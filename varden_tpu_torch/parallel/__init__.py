"""Multi-device runs over torch.distributed (counterpart of
varden_tpu.parallel): the rank decomposition of a level (mesh), the halo
exchange and the reductions between ranks (halo), and a launcher of gloo
ranks for tests and chip_smoke.py (launch)."""
