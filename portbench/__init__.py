"""The benchmark of the PyTorch/CUDA port (`repro_torch`) on NVIDIA
H100s.

Driven by data: `BENCHMARK.json` at the checkout's root names the cells,
each a configuration (`configs/`) under a traffic mix (`traffic/`), the
end-to-end metrics and the per-layer metrics (`metrics/`, one reader
each); `limits/` holds the limits that decide each cell's `correct`.
The yardstick (`yardstick.py`: peaks, model FLOPs, kernel costs), the
plain reference (`reference/`) and the comparison (`compare.py`) live
here, where a change to the program cannot move them.  Nothing here
imports JAX or the JAX package; the reference imports nothing of the
program either.  `python3 -m portbench.run --help` runs one cell.
"""
