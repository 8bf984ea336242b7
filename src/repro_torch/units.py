"""Unit constants and conversion helpers of the port's analytic plane:
the single source of every scale factor between the quantities the
modelling planes exchange, the same constants as the JAX package's
`units` module.

The paper quotes wireless/NoP/NoC rates in **Gb/s**, DRAM rates in
**GB/s**, transceiver energy in **pJ/bit**, and the simulators account
volumes in **bytes** and times in **seconds**.  A variable carrying a
unit-bearing quantity tags the unit as a suffix (``bandwidth_gbps``,
``nbytes``/``*_bytes``, ``wall_s``, ``energy_pj``), and conversions
between tags use the named helpers below.

Every helper is bit-identical to the inline expression it names:

- ``GBPS_TO_BYTES_PER_S`` is ``1e9 / 8``, exact in binary64 (1.25e8),
  and scaling by it equals ``x * 1e9 / 8`` exactly because division by
  8 is an exact power-of-two scaling that commutes with rounding.
- ``bytes_per_s_to_gbps`` keeps the ``x * 8 / 1e9`` expression shape
  instead of pre-folding ``8 / 1e9`` (whose rounding could shift the
  result by 1 ulp).

The module lives at the package root, not inside `core`, because `net`
needs it at import time and `core.__init__` imports `net`;
`core.units` re-exports everything here.
"""

from __future__ import annotations

# --- decimal scale prefixes -------------------------------------------------
KILO = 1e3
MEGA = 1e6
GIGA = 1e9
TERA = 1e12

# --- information ------------------------------------------------------------
BITS_PER_BYTE = 8

#: Gb/s -> bytes/s.  ``1e9 / 8`` is exactly representable (1.25e8), and
#: ``x * GBPS_TO_BYTES_PER_S`` is bit-identical to ``x * 1e9 / 8``.
GBPS_TO_BYTES_PER_S = GIGA / BITS_PER_BYTE

# --- energy -----------------------------------------------------------------
#: picojoules -> joules (the simulators' energy constants are pJ/bit
#: and pJ/MAC; reported platform energy is joules).
PJ_TO_J = 1e-12

# --- time -------------------------------------------------------------------
S_TO_MS = 1e3
S_TO_US = 1e6    # Perfetto's trace-event timestamps are microseconds


def gbps_to_bytes_per_s(gbps: float) -> float:
    """Gb/s -> bytes/s (bit-identical to the legacy ``x * 1e9 / 8``)."""
    return gbps * GBPS_TO_BYTES_PER_S


def bytes_per_s_to_gbps(bytes_per_s: float) -> float:
    """bytes/s -> Gb/s.

    Keeps the ``* 8 / 1e9`` expression shape so the result is
    bit-identical to the inline conversions it replaces.
    """
    return bytes_per_s * BITS_PER_BYTE / GIGA


def bytes_to_bits(nbytes: float) -> float:
    return nbytes * BITS_PER_BYTE


def pj_to_j(pj: float) -> float:
    return pj * PJ_TO_J


def s_to_ms(seconds: float) -> float:
    return seconds * S_TO_MS


def s_to_us(seconds: float) -> float:
    return seconds * S_TO_US


__all__ = [
    "KILO", "MEGA", "GIGA", "TERA",
    "BITS_PER_BYTE", "GBPS_TO_BYTES_PER_S", "PJ_TO_J",
    "S_TO_MS", "S_TO_US",
    "gbps_to_bytes_per_s", "bytes_per_s_to_gbps", "bytes_to_bits",
    "pj_to_j", "s_to_ms", "s_to_us",
]
