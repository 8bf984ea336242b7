"""Deterministic scatter sums for the analytic engines.

The JAX package's engines sum per-packet terms into bins with
`np.bincount(weights=)` and `np.add.at`, which add duplicates serially
in index order.  `scatter_sum` is `index_put_(accumulate=True)`: on the
CPU it adds serially in index order too (bit-equal to NumPy), and on
CUDA it sorts the indices and sums each bin in a fixed order, so two
runs on the card agree bit for bit (the order differs from the CPU's,
so the card's sums may differ from it in the last bits).  Counts are
integer sums, exact in any order: `bin_count` adds ones with
`scatter_add_`, which, unlike `torch.bincount` on CUDA, reads no bound
of the index back to the host.
"""

from __future__ import annotations

import torch


def scatter_sum(index: torch.Tensor, values: torch.Tensor,
                size: int) -> torch.Tensor:
    """float64 ``(size, *values.shape[1:])``: ``values`` rows summed into
    the bins ``index`` names, on the index's device."""
    out = torch.zeros((size,) + tuple(values.shape[1:]), dtype=torch.float64,
                      device=index.device)
    return out.index_put_((index,), values.to(torch.float64),
                          accumulate=True)


def bin_count(index: torch.Tensor, size: int) -> torch.Tensor:
    """float64 count of ``index`` per bin, ``size`` bins."""
    return torch.zeros(size, dtype=torch.int64,
                       device=index.device).scatter_add_(
        0, index, torch.ones_like(index)).to(torch.float64)
