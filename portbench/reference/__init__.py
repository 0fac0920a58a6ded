"""The plain reference that decides ``correct``: the benchmark's own float64
initial data (``initdata``) and a frozen copy of the port's plain PyTorch
path (``vtref``). Nothing here imports the port, ``varden_tpu`` or ``jax``."""
