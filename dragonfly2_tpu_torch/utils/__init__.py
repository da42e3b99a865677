"""Host-side helpers copied from dragonfly2_tpu/utils."""
