"""Round kernels of the port and their plain versions."""
