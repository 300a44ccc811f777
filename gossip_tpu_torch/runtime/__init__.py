"""Run loops of the XLA engine (the JAX package's ``runtime``)."""
