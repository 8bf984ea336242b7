"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The program is `repro_torch` under `src/`,
which this puts on the path itself.  The run needs CUDA and as many
cards as the cell asks for; without them it exits with code 2 and
prints no result.  Its last line of standard output is the result's one
JSON object; its last lines of standard error are the numbers that
decide `correct`, each beside its limit.  A cell on more than one chip
starts its ranks here (`launcher.start`) and prints rank 0's line.
"""

from __future__ import annotations

import os
import sys
import time


def process_start() -> float:
    """The wall-clock time this process started, from /proc (Linux);
    now where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = process_start()
# mixtral-prefill's stage holds 70 GiB of the card's 79 and its reference
# runs beside it; with the allocator's fixed segments a job that near the
# card's limit ran out of memory to fragmentation (the port's zamba2-2.7b
# train step: 4 GiB asked, 14.5 GiB cached but split)
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from portbench import launcher, spec
    from portbench.harness import RunContext, forbidden_modules, log, run_cell
    cell = spec.cell(spec.load(ROOT), args.workload, ROOT)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    if cell.chips > 1 and not launcher.is_rank():
        return launcher.start(cell.chips, ["portbench.run",
                                           *sys.argv[1:]])
    if launcher.is_rank():
        torch.cuda.set_device(launcher.rank())
    ctx = RunContext(cell=cell, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device="cuda",
                     started=STARTED)
    line = run_cell(ctx)
    held = forbidden_modules()
    if held:
        log(f"the run holds forbidden modules: {', '.join(held)}")
        return 3
    if launcher.rank() == 0:
        checks = line.pop("checks")
        line["checks"] = checks            # the compared numbers come last
        sys.stdout.write(json.dumps(line) + "\n")
        sys.stdout.flush()
        for name, c in checks.items():
            log(f"check {name} {c['value']} limit {c['limit']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
