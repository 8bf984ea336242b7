"""The paper's wireless plane: decision function + shared-channel model.

Decision criteria (paper SIII-B2), applied per message:

1. *Multi-chip multicast*: a multicast with >=1 destination off the source
   chiplet qualifies for wireless (broadcast-natured channel).
2. *Distance threshold*: a message whose chip-to-chip hop count exceeds the
   threshold qualifies.
3. *Injection probability*: a configurable probability gates qualified
   messages so the (single, shared) wireless channel does not saturate.

The paper uses a Bernoulli filter; for exact reproducibility we use a
low-discrepancy golden-ratio hash of the message index — the injected
fraction converges to p without an RNG stream.  The hash is float64
(``i * phi`` less its floor), bit-equal to the JAX package's NumPy hash
on every device: a float32 hash would move which packets go wireless.

Channel model (paper SIII-B3/C2): injected messages are summed per layer and
served at `wireless_bw` by a single shared channel; wireless time is
volume / bandwidth, exactly how GEMINI costs NoP/NoC aggregate times.

Masks are bool tensors on the trace's device.
"""

from __future__ import annotations

import dataclasses

import torch

from .traffic import TrafficTrace, resolve_device
from .units import bytes_to_bits, gbps_to_bytes_per_s, pj_to_j

_PHI = 0.6180339887498949  # frac(golden ratio)


@dataclasses.dataclass(frozen=True)
class WirelessConfig:
    bandwidth: float = gbps_to_bytes_per_s(64)   # B/s (paper: 64/96 Gb/s)
    distance_threshold: int = 1      # NoP hops (paper sweep: 1..4)
    injection_prob: float = 0.5      # paper sweep: 0.10..0.80 step 0.05
    energy_pj_per_bit: float = 1.0   # ~1 pJ/bit mm-wave transceivers

    def __post_init__(self):
        if not self.bandwidth > 0:
            raise ValueError(f"bandwidth must be positive bytes/s, got "
                             f"{self.bandwidth!r}")
        if not 0.0 <= self.injection_prob <= 1.0:
            raise ValueError(f"injection_prob must be in [0, 1], got "
                             f"{self.injection_prob!r}")
        if self.distance_threshold < 0:
            raise ValueError(f"distance_threshold must be >= 0 hops, "
                             f"got {self.distance_threshold!r}")
        if self.energy_pj_per_bit < 0:
            raise ValueError(f"energy_pj_per_bit must be >= 0, got "
                             f"{self.energy_pj_per_bit!r}")


def eligibility(trace: TrafficTrace, threshold: int) -> torch.Tensor:
    """Boolean per-message wireless eligibility (criteria 1+2)."""
    mc = trace.is_multichip & trace.is_multicast & (trace.max_hops >= threshold)
    far_unicast = (trace.is_multichip & ~trace.is_multicast
                   & (trace.max_hops > threshold))
    return mc | far_unicast


def injection_hash(n_messages: int, device=None) -> torch.Tensor:
    """Per-message low-discrepancy hash in [0, 1), float64 on ``device``
    (the card when None, as `resolve_device`).

    A message is injected at probability ``p`` iff its hash is < ``p``;
    exposing the hash (rather than only the boolean filter) lets the
    batched design-space engine (`repro_torch.net.batched`) bucket each
    message's fate across the whole injection axis at once.
    """
    x = torch.arange(n_messages, dtype=torch.float64,
                     device=resolve_device(device)) * _PHI
    return x - torch.floor(x)


def injection_filter(n_messages: int, prob: float,
                     device=None) -> torch.Tensor:
    """Deterministic low-discrepancy stand-in for the Bernoulli filter."""
    return injection_hash(n_messages, device) < prob


def select_wireless(trace: TrafficTrace, cfg) -> torch.Tensor:
    """Messages designated for the wireless plane under `cfg`.

    `cfg` is a `WirelessConfig` or any config exposing the same
    selection attributes (e.g. `repro_torch.net.NetworkConfig`).
    """
    ok = eligibility(trace, cfg.distance_threshold)
    return ok & injection_filter(len(ok), cfg.injection_prob, trace.device)


def wireless_energy_joules(trace: TrafficTrace, injected: torch.Tensor,
                           cfg, extra_bytes=0.0) -> torch.Tensor:
    """Transceiver energy for the injected payload (+ MAC overhead
    bytes), a 0-dim float64 tensor on the trace's device."""
    bits = bytes_to_bits(torch.where(injected, trace.nbytes, 0.0).sum()
                         + extra_bytes)
    return pj_to_j(bits * cfg.energy_pj_per_bit)
