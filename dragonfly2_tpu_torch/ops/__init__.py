"""Hand-written kernels and their wrappers (ops/flash.py)."""
