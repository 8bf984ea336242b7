"""LM-scale reports over the port's dry-run cells: the roofline table
and the paper's hybrid-plane schedule applied to each cell's collectives.

The functions of the JAX package's `benchmarks/lm_scale.py`, reading the
port's dry-run JSONs (`launch/dryrun.py`, build/repro_torch/dryrun/ by
default) and scheduling with the port's `core/hybrid_schedule.py`.

    PYTHONPATH=src python -m repro_torch.launch.lm_scale [--mesh pod]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List

from ..core.hybrid_schedule import balance_cell, sweep_cell
from .dryrun import OUT_DIR as DRYRUN_DIR
from .roofline import HBM_BW

_GIGA = 1e9


def load_cells(dryrun_dir: str = DRYRUN_DIR) -> List[dict]:
    out = []
    for fn in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(fn) as f:
            out.append(json.load(f))
    return out


def roofline_table(mesh: str = "pod",
                   dryrun_dir: str = DRYRUN_DIR) -> List[dict]:
    """One row per (arch x shape): the three terms + dominant + useful
    ratio."""
    rows = []
    for c in load_cells(dryrun_dir):
        if c.get("mesh") != mesh or c.get("status") != "ok":
            continue
        r = c.get("roofline")
        if not r:
            continue
        rows.append({
            "arch": c["arch"], "shape": c["shape"],
            "t_compute": r["t_compute"], "t_memory": r["t_memory"],
            "t_collective": r["t_collective"], "dominant": r["dominant"],
            "useful_ratio": r.get("useful_ratio", 0.0),
            "step_time": max(r["t_compute"], r["t_memory"],
                             r["t_collective"]),
        })
    return rows


def hybrid_plane_report(mesh: str = "pod",
                        dryrun_dir: str = DRYRUN_DIR,
                        memory: str = "floor") -> List[dict]:
    """The paper's technique on each LM cell's counted collectives:
    swept decision function + the closed-form balancer.

    memory="floor" uses the HBM floor (rank 0's argument bytes / HBM
    bandwidth) as the memory term: the counted bytes of every operation
    are a no-fusion upper bound that would mask every collective-bound
    cell; "unfused" keeps that bound for comparison."""
    rows = []
    for c in load_cells(dryrun_dir):
        if c.get("mesh") != mesh or c.get("status") != "ok":
            continue
        r = c.get("roofline")
        if not r or not r.get("coll_per_op"):
            continue
        if memory == "floor":
            args = c.get("memory", {}).get("argument_size_in_bytes", 0)
            t_mem = args / HBM_BW
        else:
            t_mem = r["t_memory"]
        swept, (thr, p) = sweep_cell(r["coll_per_op"], r["t_compute"],
                                     t_mem)
        bal = balance_cell(r["coll_per_op"], r["t_compute"], t_mem)
        rows.append({
            "arch": c["arch"], "shape": c["shape"],
            "t_compute": r["t_compute"], "t_mem_floor": t_mem,
            "t_coll_wired": swept.t_coll_wired,
            "swept_step_speedup": swept.step_speedup,
            "swept_cfg": {"threshold": thr, "injection": p},
            "balancer_step_speedup": bal.step_speedup,
            "balancer_coll_speedup": bal.coll_speedup,
            "offloaded_GB": bal.offloaded_bytes / _GIGA,
        })
    return rows


def dryrun_summary(dryrun_dir: str = DRYRUN_DIR) -> Dict:
    cells = load_cells(dryrun_dir)
    ok = [c for c in cells if c.get("status") == "ok"]
    return {"total": len(cells), "ok": len(ok),
            "failed": [f'{c["arch"]}/{c["shape"]}/{c["mesh"]}'
                       for c in cells if c.get("status") != "ok"]}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--dir", default=DRYRUN_DIR)
    args = ap.parse_args(argv)
    report = {"summary": dryrun_summary(args.dir),
              "roofline": roofline_table(args.mesh, args.dir),
              "hybrid_plane": hybrid_plane_report(args.mesh, args.dir)}
    sys.stdout.write(json.dumps(report, indent=1) + "\n")


if __name__ == "__main__":
    main()
