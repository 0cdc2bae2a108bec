"""Package version (the same as the JAX package's)."""

__version__ = "0.1.0"
