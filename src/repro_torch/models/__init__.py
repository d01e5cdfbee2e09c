"""Model zoo of the port (the JAX package's ``models``): every family —
dense and vlm, moe, ssm, hybrid and encdec."""
