"""Examples of the port's entry points (``examples/`` of the JAX package)."""
