"""Kernels of the port and their plain versions."""
