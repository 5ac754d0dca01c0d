"""Backbones (AuxiliaryUNet, LatentUNet) and the InfoDiff / Diff wrappers."""
