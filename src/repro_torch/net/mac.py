"""Analytic MAC protocols for the shared wireless medium.

The paper costs the wireless plane as a perfectly arbitrated aggregate
(`volume / bandwidth`) and explicitly leaves medium-access overhead to
future work.  We cost three protocols per (layer, channel) from the
aggregates the traffic trace already exposes — bytes ``V``, message
count ``m`` and active transmitter count ``a`` — so the models stay
closed-form and vectorize across the whole design-space grid:

- ``ideal``: ``t = V / B``.  Reproduces the paper's numbers exactly.
- ``tdma``: the channel is a slotted frame.  Serving ``V`` bytes takes
  ``ceil(V / slot)`` full slots plus (pessimistically) one partial slot
  per additional active transmitter (each transmitter's tail slot is
  padded), and every slot pays a guard interval:

      n_slots = ceil(V / slot) + max(a - 1, 0)
      t       = n_slots * (slot / B + guard)

- ``token``: transmitters hold the channel per message after acquiring
  a circulating token; the expected acquisition wait grows with the
  number of stations the token visits, i.e. the active transmitter
  count on that channel:

      t = V / B + m * a * token_time

Both non-ideal protocols dominate ``ideal`` pointwise (slot padding
``n_slots * slot >= V``; the token term is non-negative), and both
shrink when a multi-channel plan splits the transmitter population —
which is exactly the trade the DSE explores.

Energy: the padded slot bytes (TDMA) and the token frames (token) are
transmitted at the same pJ/bit as payload; `mac_extra_bytes` returns
the non-payload byte overhead that `wireless_energy_joules` adds on.

The functions are elementwise torch in float64: tensors stay on their
device, and numbers or NumPy arrays become CPU tensors.  The
per-transmission forms of the event-driven engine have a host-float
twin each (`mac_packet_time_host`, `mac_packet_extra_host`).
"""

from __future__ import annotations

import dataclasses
import math

import torch

MAC_PROTOCOLS = ("ideal", "tdma", "token")


@dataclasses.dataclass(frozen=True)
class MacConfig:
    """MAC protocol + timing constants (mm-wave-transceiver scale)."""

    protocol: str = "ideal"
    slot_bytes: float = 64 * 1024    # TDMA slot payload (one NoP packet)
    guard_s: float = 50e-9           # TDMA guard interval per slot
    token_s: float = 20e-9           # token pass latency per station hop
    token_bytes: float = 16.0        # token frame size (energy accounting)

    def __post_init__(self):
        if self.protocol not in MAC_PROTOCOLS:
            raise ValueError(f"protocol must be one of {MAC_PROTOCOLS}")


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float64)


def _tdma_slots(mac: MacConfig, nbytes: torch.Tensor, active):
    full = torch.ceil(nbytes / mac.slot_bytes)
    return full + torch.clamp(_f64(active) - 1.0, min=0.0)


def mac_times(mac: MacConfig, nbytes, msgs, active, bw) -> torch.Tensor:
    """Per-(layer, channel) wireless service time under ``mac``.

    All of ``nbytes``/``msgs``/``active`` are broadcastable aggregates
    for one channel; ``bw`` is the per-channel rate in B/s.  Zero-traffic
    entries cost zero under every protocol.
    """
    nbytes = _f64(nbytes)
    if mac.protocol == "ideal":
        return nbytes / bw
    if mac.protocol == "tdma":
        n_slots = _tdma_slots(mac, nbytes, active)
        return n_slots * (mac.slot_bytes / bw + mac.guard_s)
    # token
    return nbytes / bw + _f64(msgs) * _f64(active) * mac.token_s


def mac_extra_bytes(mac: MacConfig, nbytes, msgs, active) -> torch.Tensor:
    """Non-payload bytes the protocol transmits (for the energy model)."""
    nbytes = _f64(nbytes)
    if mac.protocol == "ideal":
        return torch.zeros_like(nbytes)
    if mac.protocol == "tdma":
        return _tdma_slots(mac, nbytes, active) * mac.slot_bytes - nbytes
    return _f64(msgs) * _f64(active) * mac.token_bytes


# ---------------------------------------------------------------------------
# per-transmission costing (the event-driven engine, `repro_torch.sim`)
# ---------------------------------------------------------------------------
#
# The functions above cost a (layer, channel) aggregate in one
# closed form.  The event-driven simulator serves the channel one packet
# at a time, so it needs the *per-transmission* cost: the same protocol
# constants, charged per packet.
#
# - ``ideal``: ``v / B`` — summing over a layer reproduces the aggregate
#   exactly, so the event engine is bit-compatible with the paper model.
# - ``tdma``: every packet occupies ``ceil(v / slot)`` whole slots (its
#   tail slot is padded) plus the guard per slot.  Neither form bounds
#   the other: the event model resolves per-packet padding the
#   aggregate amortises (event higher on fragmented traffic), while
#   the aggregate pessimistically pads one tail per *transmitter*
#   (aggregate higher on slot-aligned traffic).  Both dominate the
#   ideal MAC pointwise.
# - ``token``: each transmission first waits for the circulating token,
#   ``active`` station hops away — where ``active`` is the number of
#   stations holding traffic on the channel *at that moment*, which the
#   event engine tracks as it serves (the analytic form pessimistically
#   charges the final count for every message).
#
# Each closed form is written once, over a ``ceil``: torch's for the
# batched engine's tensors, `math.ceil` for the per-packet online loop,
# which runs on the host in floats (a torch op per packet would be pure
# overhead).  Both are IEEE float64 in the same order of operations.


def _packet_time(mac: MacConfig, nbytes, active, bw, ceil):
    if mac.protocol == "ideal":
        return nbytes / bw
    if mac.protocol == "tdma":
        return ceil(nbytes / mac.slot_bytes) * (mac.slot_bytes / bw
                                                + mac.guard_s)
    return nbytes / bw + active * mac.token_s


def _packet_extra(mac: MacConfig, nbytes, active, ceil, zero):
    if mac.protocol == "ideal":
        return zero
    if mac.protocol == "tdma":
        return ceil(nbytes / mac.slot_bytes) * mac.slot_bytes - nbytes
    return active * mac.token_bytes


def mac_packet_times(mac: MacConfig, nbytes, active, bw) -> torch.Tensor:
    """Service time of individual transmissions under ``mac``, float64.

    ``nbytes`` are per-packet sizes; ``active`` is the station count
    seen by each transmission (scalar or tensor, ignored by ideal/tdma);
    ``bw`` is the channel rate (scalar or a per-packet tensor).
    """
    nbytes = _f64(nbytes)
    return _f64(_packet_time(mac, nbytes, _f64(active), bw, torch.ceil))


def mac_packet_extra_bytes(mac: MacConfig, nbytes, active) -> torch.Tensor:
    """Per-transmission non-payload bytes (event-engine energy model)."""
    nbytes = _f64(nbytes)
    return _f64(_packet_extra(mac, nbytes, _f64(active), torch.ceil,
                              torch.zeros_like(nbytes)))


def mac_packet_time_host(mac: MacConfig, nbytes: float, active: int,
                         bw: float) -> float:
    """`mac_packet_times` of one transmission, in host floats."""
    return float(_packet_time(mac, float(nbytes), active, float(bw),
                              math.ceil))


def mac_packet_extra_host(mac: MacConfig, nbytes: float,
                          active: int) -> float:
    """`mac_packet_extra_bytes` of one transmission, in host floats."""
    return float(_packet_extra(mac, float(nbytes), active, math.ceil, 0.0))
