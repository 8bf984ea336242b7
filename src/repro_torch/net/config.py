"""`NetworkConfig`: the full wireless-network description.

Supersedes the paper-era `core.wireless.WirelessConfig` (selection
parameters + one shared channel) by adding the channel plan and the MAC
protocol.  The selection fields carry the same names, so the paper's
decision function (`core.wireless.select_wireless`) and energy model
accept either config unchanged; `as_network` upgrades a legacy config
to the degenerate plan (1 channel, ideal MAC) that reproduces the
paper's numbers exactly.
"""

from __future__ import annotations

import dataclasses

from repro_torch.units import bytes_per_s_to_gbps, gbps_to_bytes_per_s

from .channel import ChannelPlan
from .mac import MacConfig


@dataclasses.dataclass(frozen=True)
class NetworkConfig:
    # --- paper SIII-B2 selection + shared-medium parameters ---
    bandwidth: float = gbps_to_bytes_per_s(64)   # aggregate wireless B/s
    distance_threshold: int = 1      # NoP hops (paper sweep: 1..4)
    injection_prob: float = 0.5      # paper sweep: 0.10..0.80 step 0.05
    energy_pj_per_bit: float = 1.0   # ~1 pJ/bit mm-wave transceivers
    # --- beyond-paper network stack ---
    channels: ChannelPlan = ChannelPlan()
    mac: MacConfig = MacConfig()

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

    def describe(self) -> str:
        return (f"{bytes_per_s_to_gbps(self.bandwidth):.0f}Gb/s "
                f"thr={self.distance_threshold} "
                f"p={self.injection_prob:.2f} {self.mac.protocol} "
                f"{self.channels.describe()}")


def as_network(cfg) -> NetworkConfig:
    """Upgrade any wireless config to a `NetworkConfig`.

    Accepts a `NetworkConfig` (returned as-is) or anything exposing the
    legacy `WirelessConfig` attributes, which maps to the single-channel
    ideal-MAC plan — today's behaviour as the degenerate case.
    """
    if isinstance(cfg, NetworkConfig):
        return cfg
    return NetworkConfig(
        bandwidth=cfg.bandwidth,
        distance_threshold=cfg.distance_threshold,
        injection_prob=cfg.injection_prob,
        energy_pj_per_bit=cfg.energy_pj_per_bit,
    )
