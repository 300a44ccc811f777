"""Round models of the XLA engine (the JAX package's ``models``)."""
