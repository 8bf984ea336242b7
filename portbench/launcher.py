"""Starting a cell's ranks from one command.

A cell on n > 1 chips runs `python -m portbench.run` once per rank, each
a child of the command the driver started, with RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR (localhost) and MASTER_PORT (a free port found
here) in its environment; the ranks meet over TCP on localhost
(`init`), never through a file.  The parent relays rank 0's standard
output, which holds the result's line, waits for every rank and fails
if any did.

`python -m portbench.launcher --selftest N` starts N gloo ranks that sum
their ranks; rank 0 prints the sum.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from typing import List, Sequence


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank() -> int:
    return int(os.environ.get("RANK", "0"))


def world() -> int:
    return int(os.environ.get("WORLD_SIZE", "1"))


def is_rank() -> bool:
    """Whether this process is one of a multi-rank run's ranks."""
    return "RANK" in os.environ and "MASTER_PORT" in os.environ


def init(backend: str):
    import torch.distributed as dist
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}",
        rank=rank(), world_size=world())
    return dist


def start(n: int, module_args: Sequence[str]) -> int:
    """Run `python -m <module_args>` as n ranks; relay rank 0's output;
    the first non-zero exit code, else 0."""
    port = str(free_port())
    procs: List[subprocess.Popen] = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                   MASTER_PORT=port)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", *module_args], env=env,
            stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL))
    out, _ = procs[0].communicate()
    codes = [procs[0].returncode] + [p.wait() for p in procs[1:]]
    bad = [c for c in codes if c != 0]
    if not bad:
        sys.stdout.write(out.decode())
        sys.stdout.flush()
    return bad[0] if bad else 0


def _selftest() -> None:
    import torch
    dist = init("gloo")
    t = torch.tensor([float(rank())])
    dist.all_reduce(t)
    if rank() == 0:
        print(f"sum {int(t.item())} of {world()} ranks", flush=True)
    dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--selftest", type=int, required=True)
    args = ap.parse_args(argv)
    if is_rank():
        _selftest()
        return 0
    return start(args.selftest, ["portbench.launcher", "--selftest",
                                 str(args.selftest)])


if __name__ == "__main__":
    sys.exit(main())
