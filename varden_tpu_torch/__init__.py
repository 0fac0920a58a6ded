"""varden_tpu_torch: the PyTorch/CUDA port of varden_tpu.

Variable-density incompressible Navier-Stokes (VARDEN) on one NVIDIA GPU.
The module names mirror varden_tpu's; every TPU kernel of the ported path is
a hand-written CUDA kernel (csrc/) with its plain PyTorch version beside it.
The package imports torch, numpy and the standard library only.
"""
