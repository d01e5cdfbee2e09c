"""PyTorch and CUDA port of the tuner (the JAX package ``repro`` is the
reference it is tested against)."""
