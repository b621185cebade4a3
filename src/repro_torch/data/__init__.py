"""Synthetic temporal workload (the same generator as the JAX package)."""
