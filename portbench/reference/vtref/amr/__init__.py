"""Non-subcycled multi-level AMR (counterpart of varden_tpu.amr)."""
