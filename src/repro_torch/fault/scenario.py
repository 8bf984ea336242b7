"""Declarative fault scenarios: what degrades, when, by how much.

Timing convention: the simulators are layer-barriered (a layer's
packets inject at its start, the next layer starts when every queue
drains), so "fail-stop at time t" maps onto the layer boundary it
falls in — every event carries ``at_layer`` and the condition holds
for all layers ``>= at_layer``.  ``at_layer=0`` is a condition present
from the start of the run (e.g. a persistently faded channel).

Events:

- `ChipFailure`   — chiplet fail-stop: its compute contribution drops
  to zero; in *degraded mode* (no reshard) its per-layer share is
  absorbed by its surviving exec-set peers, with the absorbed weight
  slice re-streamed from DRAM (the absorber has no SRAM budget
  reserved for it).  The chiplet's mesh *router* keeps forwarding —
  interposer routers are powered independently of the compute die —
  so chip death does not kill mesh links (use `LinkFailure` for that).
- `ChipSlowdown`  — thermal throttling / a flaky host: the chiplet
  computes at ``1/factor`` of its rate from ``at_layer`` on.
- `LinkFailure`   — one directed mesh link (named by its endpoint grid
  coordinates) goes down.  Striped runs serve the cut on the surviving
  stripe (``k/surviving`` service scaling); xy runs detour the
  crossing onto a surviving parallel link of the same cut; a fully
  dead cut *forces* its packets onto the wireless plane (wired-only
  runs go to infinity — wireless-as-failover).
- `SnrFade`       — ``fading_db`` of SNR degradation on one channel
  (or all), converted to an effective-capacity scale by the package's
  `repro_torch.net.channel.SnrProfile` Shannon model.

The JAX package's `fault/scenario.py`, on the port's `SnrProfile`:
plain dataclasses on the host.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

from repro_torch.net.channel import SnrProfile

#: xy-model detour multiplier: a crossing remapped off its dead link
#: onto a parallel link of the same cut doglegs through the adjacent
#: row/column, traversing that neighbourhood twice.
DETOUR_FACTOR = 2.0


def _check_layer(at_layer: int) -> None:
    if not isinstance(at_layer, int) or at_layer < 0:
        raise ValueError(f"at_layer must be an int >= 0, got {at_layer!r}")


@dataclasses.dataclass(frozen=True)
class ChipFailure:
    chip: int
    at_layer: int = 0

    def __post_init__(self):
        if not isinstance(self.chip, int) or self.chip < 0:
            raise ValueError(f"chip must be an int >= 0, got {self.chip!r}")
        _check_layer(self.at_layer)


@dataclasses.dataclass(frozen=True)
class ChipSlowdown:
    chip: int
    factor: float
    at_layer: int = 0

    def __post_init__(self):
        if not isinstance(self.chip, int) or self.chip < 0:
            raise ValueError(f"chip must be an int >= 0, got {self.chip!r}")
        if not self.factor >= 1.0:
            raise ValueError(
                f"slow-down factor must be >= 1, got {self.factor!r}")
        _check_layer(self.at_layer)


@dataclasses.dataclass(frozen=True)
class LinkFailure:
    """Directed mesh link ``a -> b`` down (both directions by default)."""

    a: Tuple[int, int]
    b: Tuple[int, int]
    at_layer: int = 0
    both_directions: bool = True

    def __post_init__(self):
        for end in (self.a, self.b):
            if not (isinstance(end, tuple) and len(end) == 2):
                raise ValueError(
                    f"link endpoints are (row, col) grid tuples, got {end!r}")
        if self.a == self.b:
            raise ValueError("link endpoints must differ")
        _check_layer(self.at_layer)


@dataclasses.dataclass(frozen=True)
class SnrFade:
    """``fading_db`` of SNR loss on ``channel`` (None = every channel)."""

    fading_db: float
    channel: Optional[int] = None
    at_layer: int = 0

    def __post_init__(self):
        fade = float(self.fading_db)
        if not (fade >= 0.0 and fade == fade and fade != float("inf")):
            raise ValueError(
                f"fading_db must be finite and >= 0, got {self.fading_db!r}")
        if self.channel is not None and self.channel < 0:
            raise ValueError(f"channel must be >= 0, got {self.channel!r}")
        _check_layer(self.at_layer)


@dataclasses.dataclass(frozen=True)
class FaultScenario:
    """A validated bundle of dynamic-condition events.

    ``snr`` carries the package's link budget (distance model) used to
    convert `SnrFade` events into effective per-channel bandwidth.
    A scenario with no events (`is_null`) is structurally a no-op: the
    engine skips every fault path and stays bit-identical to the
    fault-free run; zero-*magnitude* events (factor-1 slowdowns, 0 dB
    fades) also reproduce the fault-free numbers exactly, by
    construction of the ratio forms.
    """

    chip_failures: Tuple[ChipFailure, ...] = ()
    chip_slowdowns: Tuple[ChipSlowdown, ...] = ()
    link_failures: Tuple[LinkFailure, ...] = ()
    snr_fades: Tuple[SnrFade, ...] = ()
    snr: SnrProfile = SnrProfile()

    def __post_init__(self):
        for name, typ in (("chip_failures", ChipFailure),
                          ("chip_slowdowns", ChipSlowdown),
                          ("link_failures", LinkFailure),
                          ("snr_fades", SnrFade)):
            v = tuple(getattr(self, name))
            if not all(isinstance(e, typ) for e in v):
                raise ValueError(f"{name} must contain only {typ.__name__}")
            object.__setattr__(self, name, v)
        if not isinstance(self.snr, SnrProfile):
            raise ValueError("snr must be an SnrProfile")

    @property
    def is_null(self) -> bool:
        return not (self.chip_failures or self.chip_slowdowns
                    or self.link_failures or self.snr_fades)

    @property
    def has_chip_events(self) -> bool:
        return bool(self.chip_failures or self.chip_slowdowns)

    def events(self):
        return itertools.chain(self.chip_failures, self.chip_slowdowns,
                               self.link_failures, self.snr_fades)

    def network_only(self) -> "FaultScenario":
        """The residual scenario after a reshard absorbed the chip
        events into the placement (link/SNR conditions remain)."""
        return dataclasses.replace(self, chip_failures=(),
                                   chip_slowdowns=())

    def reshard_boundaries(self) -> Tuple[int, ...]:
        """Layer boundaries where the chip-health state changes — the
        online-reshard controller's decision points."""
        return tuple(sorted({e.at_layer
                             for e in (self.chip_failures
                                       + self.chip_slowdowns)}))

    def describe(self) -> str:
        parts = []
        if self.chip_failures:
            parts.append("fail:" + ",".join(
                f"c{e.chip}@{e.at_layer}" for e in self.chip_failures))
        if self.chip_slowdowns:
            parts.append("slow:" + ",".join(
                f"c{e.chip}x{e.factor:g}@{e.at_layer}"
                for e in self.chip_slowdowns))
        if self.link_failures:
            parts.append("link:" + ",".join(
                f"{e.a}-{e.b}@{e.at_layer}" for e in self.link_failures))
        if self.snr_fades:
            parts.append("fade:" + ",".join(
                f"{e.fading_db:g}dB@" +
                ("*" if e.channel is None else f"ch{e.channel}")
                for e in self.snr_fades))
        return ";".join(parts) if parts else "null"
