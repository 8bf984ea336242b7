"""Vectorized event calendar: per-resource next-free-time arrays.

The event-driven engine advances a frontier (the layer barrier of the
GEMINI execution model: layer ``l+1``'s packets inject when layer
``l``'s timeline has fully drained) and serves each resource — a mesh
cut's striped link bundle, a single directed link, a wireless channel,
a DRAM port — as a FIFO server with a *next-free-time*.  Because every
packet of a layer is enqueued at the layer's start, an entire layer's
worth of events can be popped as ONE batch: per resource, the k-th
queued transmission completes at ``frontier + cumsum(service)[k]``, so
a segmented cumulative sum over (resource-sorted) events yields every
completion time of the batch at once — no per-event heap.

`segment_cumsum` and `first_occurrence` are tensor code on their
inputs' device with no host sync (the batched path's primitives: the
token MAC's active-station counts are a segmented cumsum of
first-occurrence flags, in int64 so that they are exact everywhere).
`ResourcePool` holds the next-free and cumulative-busy arrays that the
per-packet online loop mutates event by event; that loop runs on the
host, so the pool is NumPy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def segment_cumsum(values: torch.Tensor,
                   segments: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum of ``values`` within runs of ``segments``.

    ``segments`` must be grouped (all equal ids contiguous, e.g. after a
    stable sort); within each run the original order is the FIFO service
    order.  Integer and bool values sum in int64 (exact in any order),
    floats in float64.
    """
    dtype = (torch.float64 if values.is_floating_point() else torch.int64)
    values = values.to(dtype)
    n = len(values)
    if n == 0:
        return values.clone()
    cs = torch.cumsum(values, 0)
    first = torch.ones(n, dtype=torch.bool, device=values.device)
    first[1:] = segments[1:] != segments[:-1]
    # each entry's segment start: the running max of the starts' indices
    pos = torch.arange(n, device=values.device)
    start = torch.cummax(torch.where(first, pos, 0), 0).values
    # subtract the cumulative total *before* each segment's first entry
    return cs - (cs - values)[start]


def first_occurrence(keys: torch.Tensor) -> torch.Tensor:
    """Boolean mask marking the first appearance of each key value.

    A stable sort groups equal keys in their original order; the head of
    each run is the key's first appearance, scattered back to its place.
    """
    n = len(keys)
    flags = torch.zeros(n, dtype=torch.bool, device=keys.device)
    if n:
        skeys, order = torch.sort(keys, stable=True)
        head = torch.ones(n, dtype=torch.bool, device=keys.device)
        head[1:] = skeys[1:] != skeys[:-1]
        flags[order] = head
    return flags


@dataclasses.dataclass
class ResourcePool:
    """Next-free-time + busy accounting for one family of resources
    (host NumPy, for the per-packet online loop).

    ``free`` is relative to the current layer frontier (the barrier
    resets it each layer after folding the elapsed occupancy into
    ``busy``, the cumulative busy-seconds per resource over the run).
    """

    free: np.ndarray
    busy: np.ndarray

    @classmethod
    def of(cls, n: int) -> "ResourcePool":
        return cls(np.zeros(n), np.zeros(n))

    def serve(self, ids: np.ndarray, service: np.ndarray) -> float:
        """Serve one transmission across ``ids`` simultaneously.

        Each listed resource enqueues its share ``service[i]`` (FIFO);
        the transmission completes when the slowest of them finishes.
        Returns the completion time (relative to the layer frontier).
        """
        self.free[ids] += service
        return float(self.free[ids].max())

    def peek(self, ids: np.ndarray, service: np.ndarray) -> float:
        """Completion time `serve` would return, without committing."""
        return float((self.free[ids] + service).max())

    def horizon(self) -> float:
        """Latest next-free time — when this pool's queues fully drain."""
        return float(self.free.max()) if self.free.size else 0.0

    def roll(self) -> None:
        """Barrier: fold this layer's occupancy into ``busy`` and reset."""
        self.busy += self.free
        self.free[:] = 0.0
