"""Message generation: (workload graph x mapping) -> NoP message trace.

Traffic model (GEMINI/SIMBA conventions):

- **Weights** are resident in chiplet SRAM when a layer's weights fit the
  per-chiplet buffer budget (loaded once, amortised across inferences —
  SIMBA weight-stationary style).  Oversized layers (big FC / LSTM gates)
  are *streamed* per inference: slices striped across all DRAM chiplets,
  unicast to the executing chiplet (DRAM time + NoP entry links).
- **Activations** crossing pipeline stages are sent once, at production
  time, as a single message to the set of consumer chiplets — a multicast
  when the fan-out reaches >1 remote chiplet.  Same-chiplet edges are free
  (tile-local; halo traffic is folded into the NoC term).
- Tensors consumed more than `spill_window` layers after production, or
  larger than the activation buffer, are **spilled**: DRAM write at
  production + DRAM read at consumption.

Messages are generated and packetised on the host, in Python, as in the
JAX package's `core/traffic.py`.  `build_trace` then puts every
per-packet, per-incidence and per-layer array on the trace's device as a
tensor, once (int64 indices, float64 bytes and times, bool masks), so
the wireless DSE (hundreds of configurations) re-costs packets there
without re-walking the graph.  The mesh-cut incidence (`cut_matrix`) is
built once per trace on the trace's device.

Node ids: 0..C-1 compute chiplets, C..C+D-1 DRAM chiplets.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.net.scatter import scatter_sum

from .mapper import Mapping
from .topology import Topology, nearest_dram, node_grid_coords
from .workloads import Layer

Link = Tuple[Tuple[int, int], Tuple[int, int]]  # directed (from_xy, to_xy)

# SRAM budgets per chiplet (SIMBA-like global buffer) and model constants,
# calibrated against paper Fig. 2 (the JAX package's paper-reproduction
# tests pin them).
WEIGHT_SRAM_BYTES = 4 * 2**20     # weights resident below this size
ACT_SRAM_BYTES = 32 * 2**20       # live-tensor buffer before DRAM spill
NOC_PARALLEL = 16.0               # concurrent NoC injection ports per chiplet
COMPUTE_EFFICIENCY = 0.90         # achieved fraction of peak MACs
PACKET_BYTES = 64 * 1024          # NoP packetisation granularity: the
# injection-probability filter operates per packet (as in the simulator's
# per-message accounting), so large tensors can be *partially* offloaded.


def resolve_device(device=None) -> torch.device:
    """The device an analytic entry point builds on: the CUDA card when
    ``device`` is None, else ``device``.  Without a card it raises: the
    CPU runs only where the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the analytic plane builds on the card by "
                "default; pass device=\"cpu\" to run it on the CPU")
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass
class Message:
    layer: int                    # layer whose timeline carries the cost
    src: int
    dsts: Tuple[int, ...]
    nbytes: float
    # "wstream" | "act" | "spill_w" | "spill_r" | "coll"
    # ("coll" = collective-phase step, see core/collectives.py: ring/tree
    # chunk unicasts stay wired-costed, multicast fan-outs are
    # wireless-eligible under the paper's multicast criterion)
    kind: str

    @property
    def is_multicast(self) -> bool:
        return len(self.dsts) > 1


@dataclasses.dataclass(eq=False)
class TrafficTrace:
    """Packet tensors + per-layer wireless-independent costs, all on one
    device (`device`)."""

    topo: Topology
    n_layers: int
    link_index: Dict[Link, int]
    # per-packet tensors
    layer: torch.Tensor        # int64 (M,)
    nbytes: torch.Tensor       # float64 (M,)
    src: torch.Tensor          # int64 (M,) source node (chiplet or DRAM) id
    is_multicast: torch.Tensor   # bool (M,)
    is_multichip: torch.Tensor   # bool (M,)
    max_hops: torch.Tensor     # int64 (M,) max NoP hops src->any dst
    dram_node: torch.Tensor    # int64 (M,) DRAM port index served, -1 if none
    # sparse (packet -> link) incidence
    inc_msg: torch.Tensor      # int64 (E,)
    inc_link: torch.Tensor     # int64 (E,)
    # per-layer wireless-independent times (seconds), float64 (L,)
    t_compute: torch.Tensor
    t_dram: torch.Tensor
    t_noc: torch.Tensor
    dram_bytes: torch.Tensor
    messages: List[Message]
    total_macs: float = 0.0        # for the energy model
    noc_bytes: float = 0.0
    # per-chiplet totals (C,), for heterogeneous energy accounting
    macs_per_chiplet: torch.Tensor | None = None
    noc_bytes_per_chiplet: torch.Tensor | None = None

    # built on first use, on the trace's device
    _cut: tuple | None = dataclasses.field(default=None, init=False,
                                           repr=False)
    _inc_flat: torch.Tensor | None = dataclasses.field(
        default=None, init=False, repr=False)
    _coords: torch.Tensor | None = dataclasses.field(
        default=None, init=False, repr=False)

    @property
    def device(self) -> torch.device:
        return self.nbytes.device

    @property
    def n_links(self) -> int:
        return len(self.link_index)

    def to(self, device) -> "TrafficTrace":
        """The same trace with every tensor on ``device`` (caches are
        rebuilt there on first use)."""
        moved = {f.name: getattr(self, f.name).to(device)
                 for f in dataclasses.fields(self)
                 if f.init and isinstance(getattr(self, f.name),
                                          torch.Tensor)}
        return dataclasses.replace(self, **moved)

    def inc_flat(self) -> torch.Tensor:
        """(E,) flat ``layer * n_links + link`` index of each incidence."""
        if self._inc_flat is None:
            self._inc_flat = (self.layer[self.inc_msg] * self.n_links
                              + self.inc_link)
        return self._inc_flat

    def node_coords(self) -> torch.Tensor:
        """(n_nodes, 2) int64 clamped grid coordinates
        (`topology.node_grid_coords`) on the trace's device."""
        if self._coords is None:
            self._coords = torch.from_numpy(
                node_grid_coords(self.topo)).to(self.device)
        return self._coords

    def baseline_link_loads(self) -> torch.Tensor:
        """(n_layers, n_links) byte loads with everything wired."""
        return scatter_sum(self.inc_flat(), self.nbytes[self.inc_msg],
                           self.n_layers * self.n_links
                           ).view(self.n_layers, self.n_links)

    def cut_matrix(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(n_links, n_cuts) incidence + per-cut bandwidth (B/s), float64
        on the trace's device, built once.

        NoP congestion is evaluated per directed mesh *cut* (the paper:
        "multicast patterns leading to congested bisection links"): between
        every pair of adjacent rows/columns, per direction — cut ``2 * c``
        (+1) and ``2 * c + 1`` (-1) between columns c and c + 1, then the
        same between rows.  Every mesh link crosses exactly one cut.  A cut
        of k parallel links serves the bytes crossing it at k * link_bw.
        """
        if self._cut is None:
            rows, cols = self.topo.config.grid
            bw = self.topo.config.nop_bw_per_side
            n_cuts = 2 * (cols - 1) + 2 * (rows - 1)
            mat = np.zeros((len(self.link_index), n_cuts))
            for (a, b), li in self.link_index.items():
                if a[0] == b[0]:          # column step: a vertical cut
                    ci = 2 * min(a[1], b[1]) + (b[1] < a[1])
                else:                     # row step: a horizontal cut
                    ci = (2 * (cols - 1) + 2 * min(a[0], b[0])
                          + (b[0] < a[0]))
                mat[li, ci] = 1.0
            n_par = np.array([rows] * (2 * (cols - 1))
                             + [cols] * (2 * (rows - 1)), float)
            self._cut = (torch.from_numpy(mat).to(self.device),
                         torch.from_numpy(n_par * bw).to(self.device))
        return self._cut


def _streamed(lyr: Layer, sram: float = WEIGHT_SRAM_BYTES) -> bool:
    return lyr.weights > sram


def _uniform(vals) -> bool:
    """True iff every value equals the first (exact float equality —
    the gate deciding legacy-expression vs per-chiplet costing)."""
    it = iter(vals)
    first = next(it)
    return all(v == first for v in it)


def _layer_sram(cfg, chips) -> float:
    """Weight-SRAM budget governing a layer's streamed-vs-resident call.

    Uniform packages use the global calibrated constant; heterogeneous
    packages (`AcceleratorConfig.chiplet_sram`) take the tightest budget
    among the executing chiplets — a weight slice must fit everywhere
    the layer runs.  A uniform `HeteroPackage` of "standard" chiplets
    carries exactly `WEIGHT_SRAM_BYTES` per slot, so the comparison is
    unchanged.
    """
    sram = cfg.chiplet_sram
    if sram is None or not chips:
        return WEIGHT_SRAM_BYTES
    return min(sram[c] for c in chips)


def generate_messages(layers: List[Layer], mapping: Mapping,
                      topo: Topology) -> List[Message]:
    msgs: List[Message] = []
    n_dram = len(topo.dram_coords)
    n_chip = topo.config.n_chiplets

    for li, lyr in enumerate(layers):
        placed = list(mapping.chiplets[li])

        # 1) streamed weights: striped over all DRAM chiplets, unicast in.
        if lyr.weights and _streamed(lyr, _layer_sram(topo.config, placed)):
            for d in range(n_dram):
                for c in placed:
                    msgs.append(Message(
                        li, n_chip + d, (c,),
                        lyr.weights * mapping.share_of(li, c) / n_dram,
                        "wstream"))

        # 2) output activation transport, charged at production time.
        near: Dict[int, set] = {c: set() for c in placed}  # src -> dst set
        for ci in lyr.consumers:
            consumer_chips = list(mapping.chiplets[ci])
            spilled = (ci - li > mapping.spill_window
                       or lyr.act_out > ACT_SRAM_BYTES)
            if set(consumer_chips) == set(placed) and not spilled:
                # aligned partitions (same chiplet group, matching tiling):
                # tile-local consumption, no NoP transport
                continue
            if spilled:
                # DRAM spill: write once (at production), read at consumption
                for c in placed:
                    share = lyr.act_out * mapping.share_of(li, c)
                    msgs.append(Message(li, c, (nearest_dram(topo, c),),
                                        share, "spill_w"))
                for c in consumer_chips:
                    msgs.append(Message(
                        ci, nearest_dram(topo, c), (c,),
                        lyr.act_out / len(consumer_chips), "spill_r"))
                continue
            for c in placed:
                for d in consumer_chips:
                    if d != c:
                        near[c].add(d)
        # one message per source chiplet covering every near consumer —
        # multicast if the fan-out reaches more than one remote chiplet
        for c, dsts in near.items():
            if dsts:
                share = lyr.act_out * mapping.share_of(li, c)
                msgs.append(Message(li, c, tuple(sorted(dsts)), share, "act"))

    # 3) collective phases the mapping scheduled at layer boundaries
    # (tensor-parallel all-reduces, MoE all-to-alls, broadcasts)
    if mapping.collectives:
        from .collectives import lower_all   # traffic <-> collectives cycle
        msgs.extend(lower_all(mapping.collectives))
    # drop spill-writes duplicated per consumer edge: a tensor is written to
    # DRAM once even if several late consumers read it
    seen = set()
    dedup: List[Message] = []
    for m in msgs:
        if m.kind == "spill_w":
            key = (m.layer, m.src, m.dsts)
            if key in seen:
                continue
            seen.add(key)
        dedup.append(m)
    return dedup


def build_trace(layers: List[Layer], mapping: Mapping,
                topo: Topology,
                packet_bytes: float = PACKET_BYTES,
                device=None) -> TrafficTrace:
    """Packetise (graph x mapping) into a vectorised `TrafficTrace`.

    ``packet_bytes`` sets the packetisation granularity (default: the
    64 KiB NoP packet).  Giant-tensor workloads (the LLM frontier's
    multi-GB weight streams) pass a coarser granularity so the trace
    stays tractable — flit aggregation, not a model change: every
    per-layer aggregate is granularity-independent, only the injection
    filter's per-packet resolution coarsens.

    The tensors land on ``device``: the CUDA card when it is None
    (`resolve_device`), which raises rather than fall back to the CPU.
    """
    dev = resolve_device(device)
    cfg = topo.config
    msgs = generate_messages(layers, mapping, topo)
    n_layers = len(layers)

    # --- packetise: the wireless injection filter operates per packet, so
    # large tensors can be partially offloaded (as in real NoP traffic).
    link_index: Dict[Link, int] = {}
    inc_msg: List[int] = []
    inc_link: List[int] = []
    layer_l: List[int] = []
    nbytes_l: List[float] = []
    src_l: List[int] = []
    is_mc_l: List[bool] = []
    is_xchip_l: List[bool] = []
    max_hops_l: List[int] = []
    dram_l: List[int] = []

    n_chip = cfg.n_chiplets
    for m in msgs:
        hops = max(topo.nop_hops(m.src, d) for d in m.dsts)
        # DRAM port this message occupies (wstream/spill traffic), as a
        # 0-based index into the DRAM modules; -1 for chiplet-to-chiplet.
        dram = m.src - n_chip if m.src >= n_chip else \
            next((d - n_chip for d in m.dsts if d >= n_chip), -1)
        # chiplet-to-chiplet activation tensors fan out to the destination
        # chiplet's PE array: multicast in the NoC/NoP sense (paper SIII-B2)
        # even with a single destination chiplet.  DMA-style weight streams
        # and DRAM spills are point-to-point.
        mc = m.is_multicast or m.kind == "act"
        xchip = any(d != m.src for d in m.dsts)
        # activation tensors are dual-path routed (XY+YX, standard NoP load
        # balancing); DMA streams keep the single dimension-ordered path.
        orders = ("xy", "yx") if m.kind == "act" else ("xy",)
        for order in orders:
            route = [link_index.setdefault(link, len(link_index))
                     for link in topo.multicast_route(m.src, list(m.dsts),
                                                      order)]
            vol = m.nbytes / len(orders)
            n_pkt = max(1, int(np.ceil(vol / packet_bytes)))
            per = vol / n_pkt
            for _ in range(n_pkt):
                pid = len(layer_l)
                layer_l.append(m.layer)
                nbytes_l.append(per)
                src_l.append(m.src)
                is_mc_l.append(mc)
                is_xchip_l.append(xchip)
                max_hops_l.append(hops)
                dram_l.append(dram)
                inc_msg.extend([pid] * len(route))
                inc_link.extend(route)

    # --- wireless-independent per-layer terms ---
    dram_bytes = np.zeros(n_layers)
    for m in msgs:
        if m.kind in ("wstream", "spill_r", "spill_w"):
            dram_bytes[m.layer] += m.nbytes
    t_dram = dram_bytes / cfg.dram_bw_total
    # compute + NoC, per layer.  A heterogeneous package
    # (`cfg.chiplet_tops` / `chiplet_noc_bw` per-slot vectors) finishes
    # at the slowest executing chiplet's share/rate; whenever the rates
    # AND shares across the executing chiplets are all equal, the exact
    # legacy uniform expression is used, so a package of identical
    # chiplets reproduces the homogeneous numbers bit for bit.
    rates, nbw = cfg.chiplet_tops, cfg.chiplet_noc_bw
    macs_pc = np.zeros(cfg.n_chiplets)
    nocb_pc = np.zeros(cfg.n_chiplets)
    t_comp = np.zeros(n_layers)
    t_noc = np.zeros(n_layers)
    for i, lyr in enumerate(layers):
        chips = list(mapping.chiplets[i])
        n_exec = max(1, len(chips))
        shares = np.asarray(mapping.shares[i], float)
        for c, s in zip(chips, shares):    # hetero energy accounting
            macs_pc[c] += lyr.macs * s
            nocb_pc[c] += (lyr.act_in + lyr.act_out) * s
        uni_share = bool(chips) and bool(np.all(shares == shares[0]))
        # compute: layer runs on its mapped chiplets at the derated peak
        if rates is None or not chips:
            t_comp[i] = 2.0 * lyr.macs / (cfg.tops_per_chiplet
                                          * n_exec * COMPUTE_EFFICIENCY)
        elif uni_share and _uniform(rates[c] for c in chips):
            t_comp[i] = 2.0 * lyr.macs / (rates[chips[0]]
                                          * n_exec * COMPUTE_EFFICIENCY)
        else:
            t_comp[i] = 2.0 * lyr.macs * max(
                s / rates[c] for c, s in zip(chips, shares)) \
                / COMPUTE_EFFICIENCY
        # NoC: tile in + tile out + (streamed) weight slice through the
        # chiplet-local mesh; chiplets operate in parallel.
        streamed = _streamed(lyr, _layer_sram(cfg, chips))
        acts = lyr.act_in + lyr.act_out
        if nbw is None or not chips:
            w_local = lyr.weights / n_exec if streamed else 0.0
            t_noc[i] = (acts / n_exec + w_local) \
                / (cfg.noc_bw_per_port * NOC_PARALLEL)
        elif uni_share and _uniform(nbw[c] for c in chips):
            w_local = lyr.weights / n_exec if streamed else 0.0
            t_noc[i] = (acts / n_exec + w_local) \
                / (nbw[chips[0]] * NOC_PARALLEL)
        else:
            t_noc[i] = max(
                (acts * s + (lyr.weights * s if streamed else 0.0))
                / (nbw[c] * NOC_PARALLEL)
                for c, s in zip(chips, shares))

    def put(values, dtype):
        return torch.from_numpy(np.asarray(values, dtype)).to(dev)

    return TrafficTrace(
        topo=topo, n_layers=n_layers, link_index=link_index,
        layer=put(layer_l, np.int64), nbytes=put(nbytes_l, np.float64),
        src=put(src_l, np.int64), is_multicast=put(is_mc_l, bool),
        is_multichip=put(is_xchip_l, bool),
        max_hops=put(max_hops_l, np.int64),
        dram_node=put(dram_l, np.int64),
        inc_msg=put(inc_msg, np.int64), inc_link=put(inc_link, np.int64),
        t_compute=put(t_comp, np.float64), t_dram=put(t_dram, np.float64),
        t_noc=put(t_noc, np.float64),
        dram_bytes=put(dram_bytes, np.float64), messages=msgs,
        total_macs=float(sum(lyr.macs for lyr in layers)),
        noc_bytes=float(sum(lyr.act_in + lyr.act_out for lyr in layers)),
        macs_per_chiplet=put(macs_pc, np.float64),
        noc_bytes_per_chiplet=put(nocb_pc, np.float64),
    )
