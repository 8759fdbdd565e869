"""Model modules of the port (inference side)."""
