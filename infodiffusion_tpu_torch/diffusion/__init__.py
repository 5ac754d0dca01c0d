"""The schedule, its step algebra and the samplers."""
