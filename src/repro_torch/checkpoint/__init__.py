"""Checkpointing in the JAX package's on-disk layout."""
