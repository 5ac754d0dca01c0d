"""Train state, optimizer, LR schedule and the train step
(JAX counterpart: ``infodiffusion_tpu/train``)."""
