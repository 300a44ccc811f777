"""Graph families as padded neighbour tables (the JAX package's
``topology``)."""
