"""Hand-written CUDA kernels for Hopper, one package per kernel.

Each `<name>/` holds `ops.py` (the wrapper: the kernel for a CUDA
tensor, the plain version for a CPU tensor, a launch counter) and
`ref.py` (the plain PyTorch version); the CUDA source is
`csrc/<name>.cu`, built by `_build` at first use.
"""

KERNELS = ("flash_attention", "rmsnorm", "ssd")
