"""Measurement tools of the port (counterparts of the JAX package's
`tools/`): the card's, and `bench_etc1s_host`, which needs only the host."""
