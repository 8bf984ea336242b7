"""Shared helpers of the event and fault planes' parity tests: the same
hand-built trace in both packages, a fault scenario translated into the
port's classes, and the comparison of two `EventResult`s.

Integers and masks must be equal; floats are held to ``RTOL`` (the port
sums in the reference's order on the CPU, so most agree bit for bit).
"""

import math

import numpy as np
import torch

import repro.core as R
import repro.fault as RF
from repro.core.traffic import TrafficTrace as RTrace
from repro_torch import core as P
from repro_torch import fault as PF
from repro_torch.core.traffic import TrafficTrace as PTrace

RTOL = 1e-12
NET96 = (R.NetworkConfig(bandwidth=96e9 / 8),
         P.NetworkConfig(bandwidth=96e9 / 8))

INT_FIELDS = ("layer", "src", "max_hops", "dram_node", "inc_msg",
              "inc_link")
BOOL_FIELDS = ("is_multicast", "is_multichip")
FLOAT_FIELDS = ("nbytes", "t_compute", "t_dram", "t_noc", "dram_bytes")


def trace_pair(grid, n_dram, n_layers, link_index, *, exec_meta=None,
               **arrays):
    """One hand-built trace in both packages (the reference's int32
    arrays, the port's int64 / bool / float64 tensors on the CPU)."""
    ref_topo = R.build_topology(R.AcceleratorConfig(grid=grid, n_dram=n_dram))
    port_topo = P.build_topology(P.AcceleratorConfig(grid=grid,
                                                     n_dram=n_dram))
    extra = exec_meta or {}
    ref = RTrace(topo=ref_topo, n_layers=n_layers, link_index=link_index,
                 messages=[], **extra,
                 **{f: np.asarray(arrays[f], np.int32) for f in INT_FIELDS},
                 **{f: np.asarray(arrays[f], bool) for f in BOOL_FIELDS},
                 **{f: np.asarray(arrays[f], float) for f in FLOAT_FIELDS})
    port = PTrace(
        topo=port_topo, n_layers=n_layers, link_index=link_index,
        messages=[], **extra,
        **{f: torch.tensor(arrays[f], dtype=torch.int64) for f in INT_FIELDS},
        **{f: torch.tensor(arrays[f], dtype=torch.bool) for f in BOOL_FIELDS},
        **{f: torch.tensor(arrays[f], dtype=torch.float64)
           for f in FLOAT_FIELDS})
    return ref, port


def golden_pair():
    """`tests/test_sim.py`'s golden trace in both packages: two chiplets
    side by side, one directed link each way, three packets in one
    layer: two 4 MB eligible multicasts on link 0 and a 2 MB one-hop
    unicast on link 1 (not eligible); compute floor 1 ms."""
    return trace_pair(
        (1, 2), 1, 1, {((0, 0), (0, 1)): 0, ((0, 1), (0, 0)): 1},
        layer=[0, 0, 0], nbytes=[4e6, 4e6, 2e6], src=[0, 0, 1],
        is_multicast=[True, True, False], is_multichip=[True, True, True],
        max_hops=[1, 1, 1], dram_node=[-1, -1, -1], inc_msg=[0, 1, 2],
        inc_link=[0, 0, 1], t_compute=[1e-3], t_dram=[0.0], t_noc=[0.0],
        dram_bytes=[0.0])


def port_scenario(sc):
    """A reference `FaultScenario` in the port's classes."""
    return PF.FaultScenario(
        chip_failures=tuple(PF.ChipFailure(e.chip, e.at_layer)
                            for e in sc.chip_failures),
        chip_slowdowns=tuple(PF.ChipSlowdown(e.chip, e.factor, e.at_layer)
                             for e in sc.chip_slowdowns),
        link_failures=tuple(PF.LinkFailure(e.a, e.b, e.at_layer,
                                           e.both_directions)
                            for e in sc.link_failures),
        snr_fades=tuple(PF.SnrFade(e.fading_db, e.channel, e.at_layer)
                        for e in sc.snr_fades))


def random_scenario(tr, rng):
    """`tests/test_fault_plane.py`'s seeded random scenario (reference
    classes): fail-stops, a slow-down, a fade, maybe a link failure."""
    n = tr.topo.config.n_chiplets
    fails = tuple(RF.ChipFailure(int(c), at_layer=int(rng.integers(
        1, max(2, tr.n_layers))))
        for c in rng.choice(n, size=rng.integers(0, 3), replace=False))
    slows = (RF.ChipSlowdown(int(rng.integers(0, n)),
                             float(rng.uniform(1.5, 4.0)),
                             at_layer=int(rng.integers(0, tr.n_layers))),)
    fades = (RF.SnrFade(float(rng.uniform(0.5, 12.0))),)
    links = ()
    if rng.random() < 0.5:
        a, b = list(tr.link_index)[int(rng.integers(len(tr.link_index)))]
        links = (RF.LinkFailure(a, b, at_layer=int(
            rng.integers(0, tr.n_layers))),)
    return RF.FaultScenario(chip_failures=fails, chip_slowdowns=slows,
                            link_failures=links, snr_fades=fades)


def close(a, b, rtol=RTOL):
    if math.isinf(a) or math.isinf(b):
        return a == b
    return abs(a - b) <= rtol * abs(b)


def assert_same_event(ref, port, what=""):
    """A port `EventResult` against the reference's, field by field."""
    assert close(port.total_time, ref.total_time), \
        (what, port.total_time, ref.total_time)
    for f in ("layer_times", "layer_finish", "cut_busy", "channel_busy",
              "dram_busy"):
        got = getattr(port, f)
        assert got.dtype == torch.float64, (what, f)
        np.testing.assert_allclose(got.numpy(), getattr(ref, f), rtol=RTOL,
                                   atol=0, err_msg=f"{what} {f}")
    if ref.link_busy is None:
        assert port.link_busy is None, what
    else:
        np.testing.assert_allclose(port.link_busy.numpy(), ref.link_busy,
                                   rtol=RTOL, atol=0, err_msg=what)
    assert port.injected.dtype == torch.bool, what
    np.testing.assert_array_equal(port.injected.numpy(), ref.injected,
                                  err_msg=what)
    assert port.bottleneck == ref.bottleneck, what
    for f in ("wireless_bytes", "wireless_energy_j", "energy_j"):
        assert close(getattr(port, f), getattr(ref, f)), (what, f)
    assert (port.policy, port.link_model, port.dram_model) == \
        (ref.policy, ref.link_model, ref.dram_model), what
    assert port.trace is None and port.layer_terms is None
