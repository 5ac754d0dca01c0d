"""Blocks: embeddings, ResBlocks, attention, resampling, the latent MLP."""
