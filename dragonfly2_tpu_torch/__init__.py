"""PyTorch/CUDA port of dragonfly2_tpu, laid out module for module like it.

The JAX package beside it is the reference each module here is held
against. This package imports torch and never jax, flax or anything of
dragonfly2_tpu. Entry points run on the CUDA device unless the caller
passes ``device="cpu"`` (device.resolve_device).
"""
