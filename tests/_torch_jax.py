"""JAX helpers shared by the port's parity tests."""

import functools

import jax

# ``jax.jit`` at XLA's backend (LLVM) optimization level 0: the same
# function, compiled in about two thirds of the time. The reference's
# compiles dominate the parity tests.
fast_jit = functools.partial(
    jax.jit, compiler_options={"xla_backend_optimization_level": 0})
