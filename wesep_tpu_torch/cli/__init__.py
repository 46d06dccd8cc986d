"""The extraction command line and its Python API (no JAX)."""
