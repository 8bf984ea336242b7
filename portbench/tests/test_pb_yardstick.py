"""The yardstick's counts against hand-worked values, and the trace
arithmetic against known intervals."""

import pytest

from portbench import spec, yardstick
from portbench.trace import Trace, busy_us, gaps

BENCH = spec.load()
S = spec.cell(BENCH, "mamba2-train").config
M = spec.cell(BENCH, "mixtral-prefill").config


def test_ssd_costs_by_hand():
    # b=1, L=256, H=1, P=2, N=2: one chunk of 256
    f, nbytes, s = yardstick.ssd_cost(1, 256, 1, 2, 2)
    assert f == 2 * (256 * 256 * 2 + 256 * 256 * 2 + 2 * 256 * 2 * 2)
    assert nbytes == 4 * 256 * 2 + 4 * 256 + 4 + 4 * 256 * 2
    assert s == max(f / 989e12, nbytes / 3.35e12)
    f, nbytes, _ = yardstick.ssd_bwd_cost(1, 128, 1, 2, 2)
    assert f == 3 * 2 * 128 * 128 * 2 + 2 * (2 * 128 * 128 * 2
                                              + 4 * 128 * 2 * 2)
    assert nbytes == 6 * 128 * 2 + 8 * 128 + 8 + 8 * 128 * 2


def test_attention_and_grouped_costs_by_hand():
    f, nbytes, _ = yardstick.fa_cost(1, 4, 1, 1, 2)
    assert f == 4 * 2 * 10                   # 10 causal pairs
    assert nbytes == 2 * (2 * 4 * 2 + 2 * 4 * 2) + 32
    f, _, _ = yardstick.fa_cost(1, 4, 1, 1, 2, window=2)
    assert f == 4 * 2 * 7                    # 1 + 2 + 2 + 2 pairs
    f, nbytes, _ = yardstick.gmm_cost(10, 3, 5, 2)
    assert (f, nbytes) == (2 * 10 * 3 * 5, 2 * (30 + 30 + 50))


def test_weights_per_token_by_hand():
    w = yardstick.weights_per_token(S)
    mamba = 2048 * (2 * 4096 + 2 * 128 + 64) + 4 * 4352 + 4096 * 2048
    assert w == {"body": 48 * mamba, "head": 2048 * 50288}
    w = yardstick.weights_per_token(M)
    layer = (2 * 6144 * 6144 + 2 * 6144 * 1024 + 6144 * 8
             + 2 * 3 * 6144 * 16384)
    assert w == {"body": 14 * layer, "head": 6144 * 32768}


def test_model_flops_by_hand():
    w = yardstick.weights_per_token(M)
    attn = 14 * 2 * 2 * 48 * 4096 * 4096 * 128
    assert yardstick.prefill_flops(M, 2, 4096) == (
        2 * w["body"] * 8192 + 2 * w["head"] * 2 + attn)
    w = yardstick.weights_per_token(S)
    scan = 4 * 4096 * 128 * 48
    assert yardstick.train_flops(S, 2, 4096) == pytest.approx(
        6 * (w["body"] + w["head"]) * 8192 + 3 * scan * 8192, rel=1e-15)
    # the figures PERF.md quotes
    assert 6.8e13 < yardstick.train_flops(S, 2, 4096) < 6.9e13
    assert 1.64e14 < yardstick.prefill_flops(M, 2, 4096) < 1.65e14


def test_families_are_found_by_name():
    from portbench import families
    assert families.get("ssm").mixers(S) == 48
    assert families.get("moe").attention_layers(M) == 14
    with pytest.raises(ValueError, match="no family module"):
        families.get("hybrid")
    with pytest.raises(ValueError, match="not a family name"):
        families.get("../x")


def test_busy_union_and_gaps():
    spans = [(0, 10), (5, 15), (20, 30), (22, 25), (40, 41)]
    assert busy_us(spans) == 15 + 10 + 1
    assert busy_us([]) == 0
    assert gaps(spans, 0, 50) == [(15, 20), (30, 40), (41, 50)]
    assert gaps(spans, -5, 12) == [(-5, 0)]


def test_idle_gaps_named_by_host_op():
    tr = Trace(calls=1, window_us=30,
               device=[("k1", 0, 10), ("k2", 20, 30)],
               host_ops=[("aten::a", 0, 12), ("aten::b", 12, 18)],
               device_us_under={})
    assert tr.busy_us == 20
    # a gap is named by the host operator running at its start
    assert tr.idle_by_host() == {"host: aten::a": 10}
    tr.host_ops = [("aten::a", 0, 9)]
    assert tr.idle_by_host() == {"host: python": 10}


class _Event:
    """The FunctionEvent attributes `trace.read` uses."""

    def __init__(self, name, device, a, b, parent=None, annotation=False,
                 device_us=0.0):
        import types
        self.name, self.device_type = name, device
        self.time_range = types.SimpleNamespace(start=a, end=b)
        self.cpu_parent, self.is_user_annotation = parent, annotation
        self.device_time_total = device_us


def test_read_leaves_named_ranges_out_of_the_device_work():
    import torch

    from portbench.trace import WINDOW, read
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    win = _Event(WINDOW, cpu, 0, 100, annotation=True)
    op = _Event("aten::_grouped_mm", cpu, 5, 20, parent=win, device_us=30)
    rng = _Event("flash_attention.plain_backward", cpu, 30, 60, parent=win,
                 annotation=True)
    inner = _Event("aten::mm", cpu, 31, 40, parent=rng, device_us=8)
    events = [win, op, rng, inner,
              _Event(WINDOW, cuda, 0, 100, annotation=True),
              _Event("flash_attention.plain_backward", cuda, 30, 70,
                     annotation=True),
              _Event("gemm", cuda, 10, 40), _Event("mm", cuda, 50, 58),
              _Event("late", cuda, 99, 120)]
    tr = read(events, calls=2, on_card=True)
    assert tr.window_us == 100
    assert [n for n, _, _ in tr.device] == ["gemm", "mm", "late"]
    assert tr.busy_us == 30 + 8 + 1           # "late" cut at the window
    assert [n for n, _, _ in tr.host_ops] == ["aten::_grouped_mm", "aten::mm"]
    assert tr.device_us_under == {"aten::_grouped_mm": 30, "aten::mm": 8}
