"""The port's analytic plane (`repro_torch.core`, `repro_torch.net`)
against the JAX package's (`repro.core`, `repro.net`), on the CPU.

The same traces, built from the same graphs, go through both packages'
functions.  Integer and mask arrays must be equal; floats are held to
rtol 1e-12 (the port sums in the reference's order on the CPU, so most
agree bit for bit).  Tie rule: a discrete choice (a bottleneck label,
the best threshold and injection, a reuse plan, the balancer's anchor)
that differs is accepted only where the reference's own value at the
port's choice is within the tolerance of the reference's best.

Sweeps, the scale-out frontier and the balancer are in
`test_torch_paper_sweeps.py`.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.core as R
from repro.core.topology import node_grid_coords as ref_coords
from repro.core.wireless import injection_hash as ref_hash
from repro.core.workloads import WORKLOADS
from repro.net import channel as RC
from repro.net import mac as RMAC
from repro.net import stack as RS
from repro_torch import core as P
from repro_torch.core import simulator as PSIM
from repro_torch.core import traffic as PT
from repro_torch.core.wireless import injection_hash
from repro_torch.net import channel as PC
from repro_torch.net import mac as PMAC
from repro_torch.net import stack as PS

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-12

INT_FIELDS = ("layer", "src", "is_multicast", "is_multichip", "max_hops",
              "dram_node", "inc_msg", "inc_link")
FLOAT_FIELDS = ("nbytes", "t_compute", "t_dram", "t_noc", "dram_bytes",
                "macs_per_chiplet", "noc_bytes_per_chiplet")
LLM_CASES = ("smollm_360m:prefill", "mixtral_8x22b:decode",
             "gemma2_2b:prefill")


def close(a, b, rtol=RTOL, atol=0.0):
    return abs(a - b) <= atol + rtol * abs(b)


def nets(gbps=96):
    """(reference, port) network pairs: the paper's ideal single channel
    and tdma on two interleaved channels."""
    bw = gbps * 1e9 / 8
    return [
        (R.WirelessConfig(bw, 1, 0.5), P.WirelessConfig(bw, 1, 0.5)),
        (R.NetworkConfig(bw, 2, 0.35, mac=R.MacConfig("tdma"),
                         channels=R.ChannelPlan(2, "interleaved")),
         P.NetworkConfig(bw, 2, 0.35, mac=P.MacConfig("tdma"),
                         channels=P.ChannelPlan(2, "interleaved"))),
    ]


def assert_same_trace(ref, port):
    for f in INT_FIELDS:
        got = getattr(port, f)
        assert got.dtype in (torch.int64, torch.bool), f
        np.testing.assert_array_equal(got.numpy(), getattr(ref, f), f)
    for f in FLOAT_FIELDS:
        got = getattr(port, f)
        assert got.dtype == torch.float64, f
        np.testing.assert_allclose(got.numpy(), getattr(ref, f), rtol=RTOL,
                                   atol=0, err_msg=f)
    assert port.link_index == ref.link_index
    assert (port.n_layers, port.total_macs, port.noc_bytes) == \
        (ref.n_layers, ref.total_macs, ref.noc_bytes)
    mat, bw = port.cut_matrix()
    ref_mat, ref_bw = ref.cut_matrix()
    np.testing.assert_array_equal(mat.numpy(), ref_mat)
    np.testing.assert_array_equal(bw.numpy(), ref_bw)
    np.testing.assert_allclose(port.baseline_link_loads().numpy(),
                               ref.baseline_link_loads(), rtol=RTOL, atol=0)


def assert_same_sim(ref, port, what):
    atol = RTOL * ref.total_time
    assert close(port.total_time, ref.total_time, atol=atol), what
    np.testing.assert_allclose(port.layer_times.numpy(), ref.layer_times,
                               rtol=RTOL, atol=atol, err_msg=what)
    np.testing.assert_allclose(port.layer_terms.numpy(), ref.layer_terms,
                               rtol=RTOL, atol=atol, err_msg=what)
    for li, (got, want) in enumerate(zip(port.bottleneck, ref.bottleneck)):
        if got != want:   # the tie rule
            col = PSIM.BOTTLENECKS.index(got)
            assert close(ref.layer_terms[li, col], ref.layer_times[li],
                         atol=atol), (what, li, got, want)
    for f in ("wireless_bytes", "wireless_energy_j", "energy_j"):
        assert close(getattr(port, f), getattr(ref, f)), (what, f)
    assert port.bottleneck_share().keys() == ref.bottleneck_share().keys()


@pytest.fixture(scope="module")
def paper_traces():
    return {w: (R.make_trace(w), P.make_trace(w, device="cpu"))
            for w in WORKLOADS}


@pytest.mark.parametrize("wl", list(WORKLOADS))
def test_paper_trace_and_simulators_match_the_reference(wl, paper_traces):
    ref, port = paper_traces[wl]
    assert port.device == torch.device("cpu")
    assert_same_trace(ref, port)
    assert_same_sim(R.simulate_wired(ref), P.simulate_wired(port),
                    f"{wl} wired")
    for rnet, pnet in nets():
        assert_same_sim(R.simulate_hybrid(ref, rnet),
                        P.simulate_hybrid(port, pnet),
                        f"{wl} hybrid {pnet}")


@pytest.mark.parametrize("name", LLM_CASES)
def test_llm_trace_matches_the_reference(name):
    ref, port = R.make_trace(name), P.make_trace(name, device="cpu")
    assert_same_trace(ref, port)
    assert_same_sim(R.simulate_wired(ref), P.simulate_wired(port), name)
    rnet, pnet = nets()[0]
    assert_same_sim(R.simulate_hybrid(ref, rnet),
                    P.simulate_hybrid(port, pnet), name)
    want = {(r.workload, r.bandwidth_gbps): r.best_speedup
            for r in R.sweep_all({name: ref})}
    for r in P.sweep_all({name: port}):
        assert close(r.best_speedup, want[r.workload, r.bandwidth_gbps])


def test_smollm_prefill_meets_the_golden_row():
    """tests/test_golden.py's frozen LLM row, on the port's own configs."""
    from test_golden import GOLDEN_LLM_PREFILL as G
    tr = P.make_trace("smollm_360m:prefill", device="cpu")
    total = sum(m.nbytes for m in tr.messages)
    coll = sum(m.nbytes for m in tr.messages if m.kind == "coll")
    assert coll / total == G["collective_byte_share"]
    assert close(P.simulate_wired(tr).total_time, G["wired_time"])
    for r in P.sweep_all({"smollm_360m:prefill": tr}):
        assert close(r.best_speedup, G[f"best_speedup_{r.bandwidth_gbps}"])


def test_injection_hash_is_bit_equal():
    got = injection_hash(120_000, device="cpu")
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), ref_hash(120_000))


def test_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: P.make_trace("zfnet"),
                 lambda: P.make_trace("smollm_360m:decode"),
                 lambda: P.scaling_sweep(["zfnet"], [(4, 4)]),
                 lambda: injection_hash(8)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert PT.resolve_device("cpu") == torch.device("cpu")


def test_trace_to_moves_every_tensor_and_drops_caches():
    tr = P.make_trace("googlenet", device="cpu")
    tr.cut_matrix()
    P.batched_design_space(tr)
    moved = tr.to("cpu")
    assert moved._cut is None and not hasattr(moved, "_batched_dse")
    assert moved.nbytes is tr.nbytes and moved.messages is tr.messages


@pytest.mark.parametrize("proto", ("ideal", "tdma", "token"))
def test_mac_costing_matches_the_reference(proto):
    rng = np.random.default_rng(0)
    nb = rng.random((5, 3)) * 3e5
    nb[0] = 0.0
    msgs, active = rng.integers(0, 9, (5, 3)), rng.integers(0, 4, (5, 3))
    rmac, pmac = RMAC.MacConfig(proto), PMAC.MacConfig(proto)
    for bw in (8e9, rng.random((5, 3)) * 1e10 + 1e9):
        got = PMAC.mac_times(pmac, torch.from_numpy(nb), msgs, active,
                             bw if np.isscalar(bw) else torch.from_numpy(bw))
        np.testing.assert_array_equal(
            got.numpy(), RMAC.mac_times(rmac, nb, msgs, active, bw))
    np.testing.assert_array_equal(
        PMAC.mac_extra_bytes(pmac, torch.from_numpy(nb), msgs,
                             active).numpy(),
        RMAC.mac_extra_bytes(rmac, nb, msgs, active))


def test_channel_plans_and_snr_profile_match_the_reference():
    coords = np.array([[0, 0], [0, 3], [2, 1], [3, 3], [1, 2], [3, 0]])
    for n, pol in ((1, "contiguous"), (2, "contiguous"), (3, "interleaved"),
                   (4, "interleaved")):
        rp, pp = RC.ChannelPlan(n, pol), PC.ChannelPlan(n, pol)
        np.testing.assert_array_equal(pp.assign(7).numpy(), rp.assign(7))
        assert pp.describe() == rp.describe()
    for zones in (1, 2, 4):
        rp = RC.ChannelPlan(1, reuse_zones=zones)
        pp = PC.ChannelPlan(1, reuse_zones=zones)
        (rz, rd), (pz, pd) = (rp.assign_spatial((4, 4), coords),
                              pp.assign_spatial((4, 4), coords))
        np.testing.assert_array_equal(pz.numpy(), rz)
        assert pd == rd
    snr = np.array([-3.0, 0.0, 7.5, 20.0])
    np.testing.assert_allclose(PC.shannon_capacity(snr).numpy(),
                               RC.shannon_capacity(snr), rtol=RTOL)
    fades = np.array([0.0, 4.0])
    np.testing.assert_allclose(
        PC.SnrProfile().effective_bandwidth(
            PC.ChannelPlan(2), 1.2e10, 6, coords, fades).numpy(),
        RC.SnrProfile().effective_bandwidth(
            RC.ChannelPlan(2), 1.2e10, 6, coords, fades), rtol=RTOL)


@pytest.mark.parametrize("zones", (1, 4))
def test_channel_aggregates_and_layer_times_match_the_reference(zones):
    ref = R.make_trace("vgg", R.scaled_config((4, 4)))
    port = P.make_trace("vgg", P.scaled_config((4, 4)), device="cpu")
    rnet = R.NetworkConfig(1.2e10, mac=R.MacConfig("token"),
                           channels=R.ChannelPlan(2, "interleaved",
                                                  reuse_zones=zones))
    pnet = P.NetworkConfig(1.2e10, mac=P.MacConfig("token"),
                           channels=P.ChannelPlan(2, "interleaved",
                                                  reuse_zones=zones))
    inj = R.select_wireless(ref, rnet)
    want = RS.network_layer_times(
        ref.n_layers, ref.layer, ref.nbytes, ref.src, ref.topo.n_nodes, inj,
        rnet, grid=ref.topo.config.grid, node_coords=ref_coords(ref.topo),
        max_hops=ref.max_hops)
    got = PS.network_layer_times(
        port.n_layers, port.layer, port.nbytes, port.src, port.topo.n_nodes,
        torch.from_numpy(inj), pnet, **PSIM.geometry(port))
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), w, rtol=RTOL, atol=0)


def test_wireless_dse_cli_prints_the_reference_sweeps():
    """`python -m repro_torch.launch.wireless_dse zfnet --quick --device
    cpu`: every section runs, the DSE best speedups it prints equal
    the reference's `sweep` at 64 and 96 Gb/s, and its event-driven
    policy sweep the reference's `policy_sweep`."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.wireless_dse", "zfnet",
         "--quick", "--device", "cpu"], capture_output=True, text=True,
        cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO / "src")},
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    for section in ("wired baseline", "bottleneck shares", "heatmap",
                    "network sweep", "balancer [ideal]",
                    "balancer [tdma 2ch]", "event-driven policy sweep"):
        assert section in out, section
    ref = R.make_trace("zfnet")
    for bw in (64, 96):
        line = next(x for x in out.splitlines()
                    if x.startswith(f"== wireless {bw} Gb/s"))
        got = float(line.split("(")[1].split(";")[0])
        assert got == R.sweep(ref, "zfnet", bw).best_speedup
    lines = out.splitlines()
    start = next(i for i, x in enumerate(lines)
                 if x.startswith("event-driven policy sweep"))
    want = R.policy_sweep(ref, "zfnet")
    best = float(lines[start + 1].split("(")[1].split(")")[0])
    assert best == want.grid_best_speedup
    got = {x.split()[0]: float(x.split("(")[1].split(")")[0])
           for x in lines[start + 2:start + 6]}
    assert got == want.policy_speedups
