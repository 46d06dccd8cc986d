"""Run-time helpers: config, file I/O, scoring, the JAX weight bridge."""
