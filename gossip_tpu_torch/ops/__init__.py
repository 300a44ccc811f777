"""Kernels of the port (the rounds' and the roofline's calibration
microkernels) and their plain versions."""
