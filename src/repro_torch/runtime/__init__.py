"""Runtime pieces of the port (the JAX package's ``runtime``, in part)."""
