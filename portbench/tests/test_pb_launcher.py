"""Four gloo ranks started from one command, meeting on localhost;
rank 0's line alone reaches standard output."""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]


def test_four_gloo_ranks_from_one_command(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_PORT")}
    env.update(PYTHONPATH=str(ROOT), TMPDIR=str(tmp_path),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "portbench.launcher",
                          "--selftest", "4"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines() == ["sum 6 of 4 ranks"]
