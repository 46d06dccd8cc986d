"""Data preparation tools of the port (no JAX)."""
