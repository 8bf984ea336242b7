"""The 15 AI workloads evaluated in the paper (Table 1), as layer graphs.

The port's copy of the JAX package's `core/workloads.py`: host Python,
the same graphs layer for layer.

Each workload is a DAG of `Layer` records carrying per-layer MACs, tensor
byte sizes, and the consumer fan-out of the layer's output.  Fan-out > 1
(residual branches, inception modules, dense connectivity) is what turns
activation transport into *multicast* traffic — the phenomenon the paper's
wireless plane targets.

All sizes are batch-1 inference in fp16 (2 bytes/element), matching the
GEMINI inference setting.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List

BYTES = 2   # fp16
BATCH = 8   # batched inference (GEMINI-style EDP evaluation batch):
# activations and MACs scale with batch; weights are fetched once per batch,
# so weight streaming amortises and activation transport dominates, as in
# the paper's NoP-bottleneck characterisation (Fig. 2).


@dataclasses.dataclass
class Layer:
    name: str
    macs: float                 # multiply-accumulates
    act_in: int                 # input activation bytes (sum over input edges)
    weights: int                # weight bytes
    act_out: int                # output activation bytes
    consumers: List[int] = dataclasses.field(default_factory=list)  # layer idxs
    # collective hint for parallel mappings (`mapper.tensor_parallel_mapping`
    # / `expert_parallel_mapping`): "all_reduce" marks a partial-sum output
    # that must be reduced across the layer's chiplet group, "moe" marks an
    # expert layer whose boundary is an all-to-all dispatch/combine pair.
    # `None` leaves the choice to the mapper's fallback rule.
    collective: str | None = None
    # MoE routing metadata backing the "moe" hint (set by the LLM builder)
    n_experts: int = 0
    experts_per_token: int = 0

    @property
    def fan_out(self) -> int:
        return max(1, len(self.consumers))


class GraphBuilder:
    """Tiny helper: append layers, record producer->consumer edges.

    ``batch`` scales MACs and activations (weights load once per batch);
    the LLM builder subclasses with ``batch = 1`` and carries its token
    counts explicitly.  ``meta`` kwargs (collective hints, MoE routing
    metadata) pass through to the `Layer`.
    """

    batch: int = BATCH

    def __init__(self) -> None:
        self.layers: List[Layer] = []

    def add(self, name: str, macs: float, act_in: float, weights: float,
            act_out: float, inputs: List[int] | None = None,
            **meta) -> int:
        idx = len(self.layers)
        self.layers.append(Layer(name, macs * self.batch,
                                 int(act_in * self.batch), int(weights),
                                 int(act_out * self.batch), **meta))
        # `None` means "chain to the previous layer"; an explicit empty list
        # means "true source node, no producers" — they must not collapse
        # (an `inputs=[]` source used to silently wire to its predecessor).
        if inputs is None:
            inputs = [idx - 1] if idx else []
        for p in inputs:
            if p >= 0:
                self.layers[p].consumers.append(idx)
        return idx

    def conv(self, name: str, cin: int, cout: int, k: int, hw: int,
             stride: int = 1, groups: int = 1,
             inputs: List[int] | None = None) -> int:
        hw_out = max(1, math.ceil(hw / stride))
        macs = (k * k * cin * cout * hw_out * hw_out) / groups
        return self.add(
            name, macs,
            act_in=BYTES * cin * hw * hw,
            weights=BYTES * k * k * cin * cout // groups,
            act_out=BYTES * cout * hw_out * hw_out,
            inputs=inputs,
        )

    def fc(self, name: str, din: int, dout: int, seq: int = 1,
           inputs: List[int] | None = None) -> int:
        return self.add(
            name, float(din) * dout * seq,
            act_in=BYTES * din * seq,
            weights=BYTES * din * dout,
            act_out=BYTES * dout * seq,
            inputs=inputs,
        )

    def merge(self, name: str, inputs: List[int], cout: int, hw: int) -> int:
        """Concat/add join point: no MACs, just data movement."""
        act_in = sum(self.layers[i].act_out for i in inputs)
        return self.add(name, 0.0, act_in, 0, BYTES * cout * hw * hw,
                        inputs=inputs)


# --------------------------------------------------------------------------
# CNN families
# --------------------------------------------------------------------------

def _resnet(blocks: List[int], groups: int = 1, width: int = 64) -> List[Layer]:
    g = GraphBuilder()
    g.conv("stem", 3, 64, 7, 224, stride=2)
    hw, cin = 56, 64  # after maxpool
    for stage, n in enumerate(blocks):
        mid = width * (2 ** stage)
        cout = 64 * (2 ** stage) * 4
        for b in range(n):
            stride = 2 if (b == 0 and stage > 0) else 1
            inp = len(g.layers) - 1
            a = g.conv(f"s{stage}b{b}_1x1a", cin, mid, 1, hw, inputs=[inp])
            c = g.conv(f"s{stage}b{b}_3x3", mid, mid, 3, hw, stride=stride,
                       groups=groups)
            hw2 = max(1, hw // stride)
            d = g.conv(f"s{stage}b{b}_1x1b", mid, cout, 1, hw2)
            if b == 0:
                g.conv(f"s{stage}b{b}_proj", cin, cout, 1, hw, stride=stride,
                       inputs=[inp])  # residual fan-out from `inp`
                g.merge(f"s{stage}b{b}_add", [d, len(g.layers) - 1], cout, hw2)
            else:
                g.merge(f"s{stage}b{b}_add", [d, inp], cout, hw2)
            cin, hw = cout, hw2
    g.fc("fc", cin, 1000)
    return g.layers


def resnet50() -> List[Layer]:
    return _resnet([3, 4, 6, 3])


def resnet101() -> List[Layer]:
    return _resnet([3, 4, 23, 3])


def resnet152() -> List[Layer]:
    return _resnet([3, 8, 36, 3])


def resnext50() -> List[Layer]:
    return _resnet([3, 4, 6, 3], groups=32, width=128)


def vgg16() -> List[Layer]:
    g = GraphBuilder()
    cfg = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256),
           (256, 256), (256, 512), (512, 512), (512, 512), (512, 512),
           (512, 512), (512, 512)]
    hws = [224, 224, 112, 112, 56, 56, 56, 28, 28, 28, 14, 14, 14]
    for i, ((cin, cout), hw) in enumerate(zip(cfg, hws)):
        g.conv(f"conv{i}", cin, cout, 3, hw)
    g.fc("fc6", 512 * 7 * 7, 4096)
    g.fc("fc7", 4096, 4096)
    g.fc("fc8", 4096, 1000)
    return g.layers


def zfnet() -> List[Layer]:
    g = GraphBuilder()
    g.conv("conv1", 3, 96, 7, 224, stride=2)
    g.conv("conv2", 96, 256, 5, 55, stride=2)
    g.conv("conv3", 256, 384, 3, 27)
    g.conv("conv4", 384, 384, 3, 13)
    g.conv("conv5", 384, 256, 3, 13)
    g.fc("fc6", 256 * 6 * 6, 4096)
    g.fc("fc7", 4096, 4096)
    g.fc("fc8", 4096, 1000)
    return g.layers


def darknet19() -> List[Layer]:
    g = GraphBuilder()
    plan = [(3, 32, 3, 224), (32, 64, 3, 112),
            (64, 128, 3, 56), (128, 64, 1, 56), (64, 128, 3, 56),
            (128, 256, 3, 28), (256, 128, 1, 28), (128, 256, 3, 28),
            (256, 512, 3, 14), (512, 256, 1, 14), (256, 512, 3, 14),
            (512, 256, 1, 14), (256, 512, 3, 14),
            (512, 1024, 3, 7), (1024, 512, 1, 7), (512, 1024, 3, 7),
            (1024, 512, 1, 7), (512, 1024, 3, 7), (1024, 1000, 1, 7)]
    for i, (cin, cout, k, hw) in enumerate(plan):
        g.conv(f"conv{i}", cin, cout, k, hw)
    return g.layers


def googlenet() -> List[Layer]:
    g = GraphBuilder()
    g.conv("stem1", 3, 64, 7, 224, stride=2)
    g.conv("stem2", 64, 192, 3, 56)
    # (cin, 1x1, 3x3red, 3x3, 5x5red, 5x5, pool_proj, hw)
    modules = [
        (192, 64, 96, 128, 16, 32, 32, 28), (256, 128, 128, 192, 32, 96, 64, 28),
        (480, 192, 96, 208, 16, 48, 64, 14), (512, 160, 112, 224, 24, 64, 64, 14),
        (512, 128, 128, 256, 24, 64, 64, 14), (512, 112, 144, 288, 32, 64, 64, 14),
        (528, 256, 160, 320, 32, 128, 128, 14),
        (832, 256, 160, 320, 32, 128, 128, 7), (832, 384, 192, 384, 48, 128, 128, 7),
    ]
    for m, (cin, b1, r3, b3, r5, b5, bp, hw) in enumerate(modules):
        inp = len(g.layers) - 1
        p1 = g.conv(f"i{m}_1x1", cin, b1, 1, hw, inputs=[inp])
        g.conv(f"i{m}_3x3r", cin, r3, 1, hw, inputs=[inp])
        p3 = g.conv(f"i{m}_3x3", r3, b3, 3, hw)
        g.conv(f"i{m}_5x5r", cin, r5, 1, hw, inputs=[inp])
        p5 = g.conv(f"i{m}_5x5", r5, b5, 5, hw)
        pp = g.conv(f"i{m}_pool", cin, bp, 1, hw, inputs=[inp])
        g.merge(f"i{m}_cat", [p1, p3, p5, pp], b1 + b3 + b5 + bp, hw)
    g.fc("fc", 1024, 1000)
    return g.layers


def iresnet() -> List[Layer]:
    """Inception-ResNet-style: inception branches + residual add."""
    g = GraphBuilder()
    g.conv("stem", 3, 192, 3, 149, stride=2)
    hw, cin = 35, 320
    g.conv("stem2", 192, cin, 3, 71, stride=2)
    for blk, (n, hw, cin) in enumerate([(5, 35, 320), (10, 17, 1088),
                                        (5, 8, 2080)]):
        for b in range(n):
            inp = len(g.layers) - 1
            p1 = g.conv(f"b{blk}_{b}_1x1", cin, 32 * (blk + 1), 1, hw,
                        inputs=[inp])
            g.conv(f"b{blk}_{b}_3x3r", cin, 32 * (blk + 1), 1, hw, inputs=[inp])
            p3 = g.conv(f"b{blk}_{b}_3x3", 32 * (blk + 1), 48 * (blk + 1), 3, hw)
            pj = g.conv(f"b{blk}_{b}_proj", 32 * (blk + 1) + 48 * (blk + 1),
                        cin, 1, hw, inputs=[p1, p3])
            g.merge(f"b{blk}_{b}_add", [pj, inp], cin, hw)
    g.fc("fc", cin, 1000)
    return g.layers


def densenet() -> List[Layer]:
    """DenseNet-121: dense connectivity == the heaviest multicast fan-out."""
    g = GraphBuilder()
    g.conv("stem", 3, 64, 7, 224, stride=2)
    growth = 32
    cin, hw = 64, 56
    for blk, n in enumerate([6, 12, 24, 16]):
        block_outs: List[int] = [len(g.layers) - 1]
        for b in range(n):
            c_in_eff = cin + b * growth
            a = g.conv(f"d{blk}_{b}_1x1", c_in_eff, 4 * growth, 1, hw,
                       inputs=list(block_outs))
            o = g.conv(f"d{blk}_{b}_3x3", 4 * growth, growth, 3, hw)
            block_outs.append(o)
        cin = cin + n * growth
        if blk < 3:
            g.conv(f"t{blk}_1x1", cin, cin // 2, 1, hw,
                   inputs=[block_outs[-1]])
            cin, hw = cin // 2, hw // 2
    g.fc("fc", cin, 1000)
    return g.layers


def pnasnet() -> List[Layer]:
    """PNASNet-5-ish: 12 cells, 5 separable-conv branches per cell."""
    g = GraphBuilder()
    g.conv("stem", 3, 96, 3, 224, stride=2)
    hw, cin = 56, 270
    g.conv("stem2", 96, cin, 3, 112, stride=2)
    for cell in range(12):
        if cell in (4, 8):
            hw, cin = hw // 2, cin * 2
        inp = len(g.layers) - 1
        branches = []
        for br in range(5):
            k = (3, 5, 7, 3, 5)[br]
            # separable: depthwise k x k + pointwise 1x1
            d = g.conv(f"c{cell}_b{br}_dw", cin, cin, k, hw, groups=cin,
                       inputs=[inp])
            p = g.conv(f"c{cell}_b{br}_pw", cin, cin // 5, 1, hw)
            branches.append(p)
        g.merge(f"c{cell}_cat", branches, cin, hw)
    g.fc("fc", cin, 1000)
    return g.layers


# --------------------------------------------------------------------------
# Sequence models
# --------------------------------------------------------------------------

def _lstm_layer(g: GraphBuilder, name: str, d: int, seq: int,
                inputs: List[int] | None = None) -> int:
    # 4 gates, input + recurrent matmuls, per timestep
    return g.add(
        name, macs=seq * 2 * 4 * d * d,
        act_in=BYTES * seq * d,
        weights=BYTES * 2 * 4 * d * d,
        act_out=BYTES * seq * d,
        inputs=inputs,
    )


def lstm() -> List[Layer]:
    g = GraphBuilder()
    d, seq = 1024, 100
    g.fc("embed", 32000, d, seq=1)  # embedding lookup modeled as weight fetch
    for i in range(4):
        _lstm_layer(g, f"lstm{i}", d, seq)
    g.fc("proj", d, 32000, seq=seq)
    return g.layers


def gnmt() -> List[Layer]:
    g = GraphBuilder()
    d, seq = 1024, 50
    g.fc("src_embed", 32000, d, seq=1)
    enc = []
    for i in range(8):
        residual = [len(g.layers) - 1] if i < 2 else [len(g.layers) - 1,
                                                      len(g.layers) - 2]
        enc.append(_lstm_layer(g, f"enc{i}", d, seq, inputs=residual))
    for i in range(8):
        inputs = [len(g.layers) - 1]
        if i == 0:
            inputs.append(enc[-1])
        _lstm_layer(g, f"dec{i}", d, seq, inputs=inputs)
        if i == 0:
            # attention: scores + context against encoder states, consumed by
            # every subsequent decoder layer (multicast-heavy)
            g.add("attention", macs=2 * seq * seq * d,
                  act_in=BYTES * 2 * seq * d, weights=BYTES * d * d,
                  act_out=BYTES * seq * d, inputs=[enc[-1], len(g.layers) - 1])
    g.fc("softmax", d, 32000, seq=seq)
    return g.layers


def _transformer_block(g: GraphBuilder, name: str, d: int, ff: int, seq: int,
                       inp: int) -> int:
    # QKV: input fans out to three projections + the residual add
    q = g.fc(f"{name}_q", d, d, seq=seq, inputs=[inp])
    k = g.fc(f"{name}_k", d, d, seq=seq, inputs=[inp])
    v = g.fc(f"{name}_v", d, d, seq=seq, inputs=[inp])
    att = g.add(f"{name}_attn", macs=2 * seq * seq * d,
                act_in=3 * BYTES * seq * d, weights=0,
                act_out=BYTES * seq * d, inputs=[q, k, v])
    o = g.fc(f"{name}_o", d, d, seq=seq, inputs=[att])
    r1 = g.merge(f"{name}_add1", [o, inp], 1, int(math.sqrt(seq * d)))
    f1 = g.fc(f"{name}_ff1", d, ff, seq=seq, inputs=[r1])
    f2 = g.fc(f"{name}_ff2", ff, d, seq=seq, inputs=[f1])
    return g.merge(f"{name}_add2", [f2, r1], 1, int(math.sqrt(seq * d)))


def transformer() -> List[Layer]:
    g = GraphBuilder()
    d, ff, seq = 512, 2048, 512
    cur = g.fc("embed", 32000, d, seq=1)
    for i in range(6):
        cur = _transformer_block(g, f"enc{i}", d, ff, seq, cur)
    for i in range(6):
        cur = _transformer_block(g, f"dec{i}", d, ff, seq, cur)
    g.fc("lm_head", d, 32000, seq=seq, inputs=[cur])
    return g.layers


def transformer_cell() -> List[Layer]:
    g = GraphBuilder()
    d, ff, seq = 1024, 4096, 512
    cur = g.add("input", 0.0, 0, 0, BYTES * seq * d, inputs=[])
    _transformer_block(g, "cell", d, ff, seq, cur)
    return g.layers


WORKLOADS: Dict[str, Callable[[], List[Layer]]] = {
    "darknet19": darknet19,
    "densenet": densenet,
    "zfnet": zfnet,
    "gnmt": gnmt,
    "vgg": vgg16,
    "lstm": lstm,
    "resnet50": resnet50,
    "resnet101": resnet101,
    "resnet152": resnet152,
    "resnext50": resnext50,
    "pnasnet": pnasnet,
    "transformer": transformer,
    "transformer_cell": transformer_cell,
    "iresnet": iresnet,
    "googlenet": googlenet,
}


def get_workload(name: str) -> List[Layer]:
    if name in WORKLOADS:
        return WORKLOADS[name]()
    # "<model>:<phase>" names resolve against the LLM frontier registry
    # (kept separate so the paper's 15-workload sweeps stay exactly Table 1)
    from .workloads_llm import LLM_WORKLOADS, llm_workload
    if name in LLM_WORKLOADS:
        return llm_workload(name)
    raise KeyError(f"unknown workload {name!r}; pick one of "
                   f"{sorted(WORKLOADS)} or {sorted(LLM_WORKLOADS)}")
