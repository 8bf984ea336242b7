"""Collective-traffic plane: synthesize collective phases into messages.

At multi-chiplet scale the dominant inter-chip traffic is *collective* —
all-reduce at tensor-parallel layer boundaries, all-gather /
reduce-scatter of sharded tensors, and MoE all-to-all dispatch/combine
(the communication characterization of arXiv:2410.22262).  These are
exactly the broadcast-natured patterns a wireless plane serves best
(arXiv:2011.14755): one transmission reaches every antenna, so a
multicast that costs a whole spanning tree of mesh links costs a single
channel slot.

Each `CollectiveSpec` lowers to plain `traffic.Message` records, so the
existing packetiser, the analytic simulator, the batched DSE engine and
the event-driven `sim` plane all cost collective traffic with no new
code paths.  Wired vs wireless costing per collective step:

- **ring steps** (ring all-reduce / all-gather / reduce-scatter): each
  participant unicasts a ``nbytes / k`` chunk to its ring successor.
  Kind ``"coll"``, unicast: costed on the wired per-link loads like any
  point-to-point transfer, and wireless-INeligible at the default
  distance threshold (neighbour hops; the unicast criterion is strict
  ``hops > threshold``).  Rings are the wired plane's best case.
- **tree reduce** (``all_reduce`` with ``algorithm="tree"``): the
  ``k - 1`` up-tree partial-sum unicasts are wired like ring steps; the
  final **result fan-out** is ONE multicast from the root to all other
  participants (kind ``"coll"``, ``len(dsts) > 1``) — wired it pays the
  whole multicast tree, wireless it is eligible under the paper's
  multicast criterion (``hops >= threshold``), i.e. a single broadcast
  slot.
- **broadcast all-gather** (``algorithm="bcast"``): every participant
  multicasts its shard to all others — k wireless-eligible multicasts
  instead of ``k (k - 1)`` ring chunk unicasts.
- **MoE all-to-all dispatch** (`moe_all_to_all`): a token routed to
  ``experts_per_token > 1`` experts sends the SAME activation block to
  several expert-owner chiplets, so each source's dispatch is one
  multicast of its local token block to the owners it hits — the
  shared-payload, broadcast-natured step (shared-expert dispatch is the
  ``fanout = k - 1`` limit).  The **combine** path returns per-token
  partial outputs, which are distinct per destination: plain all-to-all
  chunk unicasts, wired-costed.
- **broadcast** (`op="broadcast"`): root multicasts the full payload to
  every other participant (weight/KV replication, router state).

`Message.layer` carries the cost on the emitting layer's timeline, so a
collective competes with its layer's compute/DRAM/NoC terms in the
GEMINI per-layer bottleneck max — the same convention activation
transport already uses.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from .traffic import Message

OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
       "broadcast")
# per-op algorithm choices; ops not listed accept only the default ring
_ALGORITHMS = {"all_reduce": ("ring", "tree"),
               "all_gather": ("ring", "bcast")}


@dataclasses.dataclass(frozen=True)
class CollectiveSpec:
    """One collective phase attached to a workload layer.

    ``nbytes`` semantics per op:

    - ``all_reduce``: the full per-participant tensor being reduced
      (every participant holds ``nbytes`` of partial sums).
    - ``all_gather``: the full gathered tensor (each participant
      contributes a ``nbytes / k`` shard).
    - ``reduce_scatter``: the full tensor being reduced (each
      participant keeps a ``nbytes / k`` shard of the result).
    - ``all_to_all``: per-participant send volume (``fanout`` scales
      the dispatch multicast, see `moe_all_to_all`).
    - ``broadcast``: the payload replicated from ``root`` to everyone.
    """

    op: str
    layer: int                       # layer timeline carrying the cost
    participants: Tuple[int, ...]    # chiplet ids, in ring order
    nbytes: float
    algorithm: str = "ring"          # ring | tree (all_reduce) | bcast
    fanout: int = 1                  # all_to_all: destinations per source
    root: int | None = None          # tree reduce / broadcast root

    def __post_init__(self):
        if self.op not in OPS:
            raise ValueError(f"op must be one of {OPS}, got {self.op!r}")
        if len(set(self.participants)) != len(self.participants):
            raise ValueError("participants must be distinct chiplets")
        allowed = _ALGORITHMS.get(self.op, ("ring",))
        if self.algorithm not in allowed:
            raise ValueError(
                f"{self.op} supports algorithms {allowed}, got "
                f"{self.algorithm!r} (a typo here would silently lower "
                f"to the wrong collective)")
        if self.root is not None and self.root not in self.participants:
            raise ValueError(f"root {self.root} is not a participant")


def _ring_steps(spec: CollectiveSpec, n_rounds: int) -> List[Message]:
    """``n_rounds`` rounds of chunk unicasts along the participant ring."""
    k = len(spec.participants)
    chunk = spec.nbytes / k
    msgs = []
    for _ in range(n_rounds):
        for i, src in enumerate(spec.participants):
            dst = spec.participants[(i + 1) % k]
            msgs.append(Message(spec.layer, src, (dst,), chunk, "coll"))
    return msgs


def _tree_parent(i: int) -> int:
    return (i - 1) // 2


def ring_all_reduce(spec: CollectiveSpec) -> List[Message]:
    """Reduce-scatter + all-gather rings: 2(k-1) rounds of nbytes/k."""
    return _ring_steps(spec, 2 * (len(spec.participants) - 1))


def tree_all_reduce(spec: CollectiveSpec) -> List[Message]:
    """Binary-tree reduce (unicasts up) + root result fan-out (multicast)."""
    parts = list(spec.participants)
    if spec.root is not None:
        parts.remove(spec.root)
        parts.insert(0, spec.root)
    msgs = [Message(spec.layer, parts[i], (parts[_tree_parent(i)],),
                    spec.nbytes, "coll")
            for i in range(1, len(parts))]
    if len(parts) > 1:   # the broadcast-natured step: one multicast
        msgs.append(Message(spec.layer, parts[0], tuple(sorted(parts[1:])),
                            spec.nbytes, "coll"))
    return msgs


def ring_all_gather(spec: CollectiveSpec) -> List[Message]:
    """(k-1) rounds of nbytes/k shard unicasts along the ring."""
    return _ring_steps(spec, len(spec.participants) - 1)


def bcast_all_gather(spec: CollectiveSpec) -> List[Message]:
    """Each participant multicasts its shard to all others."""
    k = len(spec.participants)
    return [Message(spec.layer, src,
                    tuple(sorted(d for d in spec.participants if d != src)),
                    spec.nbytes / k, "coll")
            for src in spec.participants if k > 1]


def ring_reduce_scatter(spec: CollectiveSpec) -> List[Message]:
    return _ring_steps(spec, len(spec.participants) - 1)


def all_to_all(spec: CollectiveSpec) -> List[Message]:
    """Distinct-shard exchange (MoE combine, sequence/expert resharding).

    Each participant holds ``nbytes`` destined uniformly across all k
    participants (its own share stays local): (k-1) unicasts of
    ``nbytes / k``.
    """
    k = len(spec.participants)
    chunk = spec.nbytes / k
    return [Message(spec.layer, src, (dst,), chunk, "coll")
            for src in spec.participants
            for dst in spec.participants if dst != src]


def dispatch_multicast(spec: CollectiveSpec) -> List[Message]:
    """Shared-payload dispatch: each source multicasts its block once.

    A token routed to ``fanout`` experts sends the SAME activation to
    ``fanout`` owner chiplets; aggregated over a token block the set of
    owners hit approaches ``min(fanout * tokens, k - 1)`` distinct
    chiplets, and one tree/broadcast transmission covers them all.  The
    destination set is the ``fanout``-spread neighbourhood on the
    participant ring (deterministic, uniform-routing stand-in).
    """
    k = len(spec.participants)
    fan = max(1, min(spec.fanout, k - 1))
    msgs = []
    for i, src in enumerate(spec.participants):
        dsts = tuple(sorted(spec.participants[(i + 1 + j) % k]
                            for j in range(fan)))
        msgs.append(Message(spec.layer, src, dsts, spec.nbytes, "coll"))
    return msgs


def broadcast(spec: CollectiveSpec) -> List[Message]:
    root = spec.root if spec.root is not None else spec.participants[0]
    others = tuple(sorted(d for d in spec.participants if d != root))
    if not others:
        return []
    return [Message(spec.layer, root, others, spec.nbytes, "coll")]


def lower(spec: CollectiveSpec) -> List[Message]:
    """Lower one collective phase to `traffic.Message` records.

    Lowering is topology-independent: routes, hop counts and link
    incidence are resolved by the packetiser (`traffic.build_trace`).
    """
    if len(spec.participants) < 2:
        return []
    if spec.op == "all_reduce":
        return (tree_all_reduce(spec) if spec.algorithm == "tree"
                else ring_all_reduce(spec))
    if spec.op == "all_gather":
        return (bcast_all_gather(spec) if spec.algorithm == "bcast"
                else ring_all_gather(spec))
    if spec.op == "reduce_scatter":
        return ring_reduce_scatter(spec)
    if spec.op == "all_to_all":
        return (dispatch_multicast(spec) if spec.fanout > 1
                else all_to_all(spec))
    return broadcast(spec)


def lower_all(specs: Sequence[CollectiveSpec]) -> List[Message]:
    msgs: List[Message] = []
    for spec in specs:
        msgs.extend(lower(spec))
    return msgs


def collective_bytes(specs: Sequence[CollectiveSpec]) -> float:
    """Total bytes the lowered collective messages inject into the NoP."""
    return sum(m.nbytes for m in lower_all(specs))
