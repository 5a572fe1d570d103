"""Backend-neutral numerics core of the port (own copies, no JAX)."""
