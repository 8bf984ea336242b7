"""Wireless NoP network subsystem of the port.

The paper models the wireless plane as ONE idealized shared channel
(volume / bandwidth) and defers channel saturation and wired/wireless
load balancing to future work (SIV-B, SV).  This package replaces that
implicit model with a composable stack, as the JAX package's `net` does:

- `channel`  — `ChannelPlan`: single shared channel (the degenerate
  case, bit-exact with the paper), or frequency-division multi-channel
  with chiplet->channel zone assignment (contiguous / interleaved), and
  spatial reuse zones; `SnrProfile`, the fading model.
- `mac`      — `MacConfig`: analytic per-layer MAC costing: `ideal`
  (pure aggregate, reproduces the paper's numbers exactly), `tdma`
  (slot quantization + guard time), `token` (token-passing overhead
  proportional to the active transmitter count).
- `config`   — `NetworkConfig`: the full network description.  It is
  attribute-compatible with `core.wireless.WirelessConfig` so the
  paper's decision function applies unchanged.
- `stack`    — per-layer wireless service times + MAC energy overhead
  for one configuration.
- `batched`  — the vectorized design-space engine: per-packet
  eligibility/injection tensors are bucketed once per trace, then the
  whole (threshold x injection x bandwidth x MAC x channel-plan) grid
  is evaluated as batched tensor ops (scatter sums + cumsum) on the
  trace's device, at the per-point `simulate_hybrid` loop's results.
- `scatter`  — the deterministic scatter sums the engines share.

The package is independent of `repro_torch.core` (it operates on plain
tensors), so `core.simulator` can import it without cycles.
"""

from .channel import ChannelPlan, SnrProfile, shannon_capacity
from .config import NetworkConfig, as_network
from .mac import MAC_PROTOCOLS, MacConfig, mac_extra_bytes, mac_times
from .stack import network_layer_times
from .batched import BatchedDesignSpace, GridSpec, GridResult

__all__ = [
    "ChannelPlan", "SnrProfile", "shannon_capacity",
    "MacConfig", "NetworkConfig", "as_network",
    "MAC_PROTOCOLS", "mac_times", "mac_extra_bytes",
    "network_layer_times",
    "BatchedDesignSpace", "GridSpec", "GridResult",
]
