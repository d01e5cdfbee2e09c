"""Command-line launchers of the port (the JAX package's ``launch``, in
part)."""
