"""Optimizer and gradient compression of the port (the JAX package's
``optim``)."""
