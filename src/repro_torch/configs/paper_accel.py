"""The paper's own platform config (Table 1), for the package-scale sim."""

from ..core.topology import AcceleratorConfig
from ..units import gbps_to_bytes_per_s

CONFIG_64G = AcceleratorConfig(wireless_bw=gbps_to_bytes_per_s(64))
CONFIG_96G = AcceleratorConfig(wireless_bw=gbps_to_bytes_per_s(96))
