"""Hand-written CUDA kernels for Hopper, one package per kernel.

Each `<name>/` holds `ops.py` (the wrapper: the kernel for a CUDA
tensor, the plain version for a CPU tensor, a launch counter) and
`ref.py` (the plain PyTorch version); the CUDA source is
`csrc/<name>.cu`, built by `_build` at first use.
"""

KERNELS = ("flash_attention", "rmsnorm", "ssd")


def reject_dtensor(name: str, *tensors) -> None:
    """Raise if any of `tensors` is a DTensor.  A wrapper hands its
    kernel the local memory of a whole tensor (`data_ptr()`), which a
    sharded DTensor does not hold; callers gather to local tensors first
    (`runtime/train.py` does, on a mesh)."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(f"{name}: got a DTensor; the kernel takes local "
                        f"tensors (gather with .redistribute(...).to_local() "
                        f"first)")
