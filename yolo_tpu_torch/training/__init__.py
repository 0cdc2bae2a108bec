"""Training (only checkpoint loading is ported yet)."""
