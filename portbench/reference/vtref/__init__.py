"""A frozen copy of varden_tpu_torch's plain PyTorch path (commit e4c28ca).

The benchmark's reference for the port: the same modules, with each kernel
wrapper of ``ops/cuda_*.py`` reduced to its plain version on every device
(no CUDA kernel, no ``_cuda`` module) and the driver without its output,
restart and run loops. Relative imports only: it imports nothing of the
port, of ``varden_tpu`` or of ``jax``. Frozen on purpose: a later change
to the port is held against this copy, not against itself.
"""
