"""Model zoo of the port (the JAX package's ``models``): the dense and vlm
families."""
