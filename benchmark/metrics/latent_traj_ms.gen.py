"""Device milliseconds of the latent prior's trajectory kernel (K4,
``ops/cuda/latent_traj.py``) per batch, from the traced batch."""


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    s = tr["by_category_s"].get("K4 latent_traj", 0.0)
    return s / tr["batches"] * 1e3 if s > 0 else None
