"""Process groups for the port's distributed tests on the CPU.

`local_group()` gives the test process a 1-rank gloo group for its body
(the launchers' own group, `launch.mesh.init_process_group("cpu")`), and
ends it after, so no group outlives a test module.

`start_ranks(case, world, workdir)` starts `world` processes of
`_torch_dist_worker.py`, the ranks of one gloo group over a FileStore in
`workdir` (with device="cuda", an NCCL group, a card each), with one
torch thread each; `finish(...)` waits for them
within a time limit (killing every rank on a timeout or a failure) and
returns each rank's results, `workdir/out_<rank>.pt`.  Starting and
finishing apart lets a test run the JAX reference meanwhile.
`moe_results` sums the `moe` case's ranks into whole-batch results.
"""

import contextlib
import os
import pathlib
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import init_process_group

HERE = pathlib.Path(__file__).resolve().parent
SRC = HERE.parent / "src"


@contextlib.contextmanager
def local_group():
    started = init_process_group("cpu")
    try:
        yield
    finally:
        if started:
            dist.destroy_process_group()


def start_ranks(case, world, workdir, device="cpu"):
    workdir = pathlib.Path(workdir)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
               REPRO_DIST_DEVICE=device)
    procs = []
    for rank in range(world):
        log = open(workdir / f"log_{rank}.txt", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(HERE / "_torch_dist_worker.py"), case,
             str(rank), str(world), str(workdir)],
            env=env, stdout=log, stderr=subprocess.STDOUT), log))
    return workdir, procs


def finish(started, timeout):
    workdir, procs = started
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [proc.poll() for proc, _ in procs]
            failed = next((r for r, c in enumerate(codes) if c), None)
            if failed is not None or all(c == 0 for c in codes):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"ranks still running after {timeout} "
                                     f"s: {codes}")
            time.sleep(0.05)
    finally:
        for proc, log in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    if failed is not None:
        raise AssertionError(
            f"rank {failed} failed:\n"
            + (workdir / f"log_{failed}.txt").read_text()[-4000:])
    return [torch.load(workdir / f"out_{r}.pt", weights_only=False)
            for r in range(len(procs))]


def moe_results(got, name, dim=0):
    """The `moe` case's run `name` over all ranks: (y over both data
    shards, joined on `dim`: 0 for shards of the rows, 1 of the
    sequence; aux; gradients summed over the ranks: the params over all
    of them, x over the model ranks of each data shard), as numpy.  Each
    data shard's y must be the same on all of its model ranks."""
    by_data = {r["data_index"]: r[name] for r in got}
    for r in got:
        assert torch.equal(r[name]["y"], by_data[r["data_index"]]["y"])
    y = torch.cat([by_data[i]["y"] for i in (0, 1)], dim).numpy()
    grads = {k: sum(r[name]["grads"][k] for r in got).numpy()
             for k in ("router", "w_gate", "w_up", "w_down")}
    grads["x"] = torch.cat([
        sum(r[name]["grads"]["x"] for r in got if r["data_index"] == i)
        for i in (0, 1)], dim).numpy()
    return y, float(got[0][name]["aux"]), grads


def tp_local(mesh, params, moe=None):
    """Whole parameters (every rank the same) cut to what this rank
    computes with: each weight's slice under `compute_spec` (`moe`: the
    path of the MoE blocks' expert stacks), views of the whole leaves."""
    from repro_torch.runtime.sharding import (_map_named, compute_spec,
                                              shard_slices)
    return _map_named(lambda name, t: t[shard_slices(
        mesh, compute_spec(mesh, name, tuple(t.shape), moe),
        tuple(t.shape))], params)
