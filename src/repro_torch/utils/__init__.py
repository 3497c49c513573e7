"""Helpers shared across the port (copies of the JAX package's ``utils/``)."""
