"""Measurement tools of the port that run on the card (counterparts of the
JAX package's `tools/`)."""
