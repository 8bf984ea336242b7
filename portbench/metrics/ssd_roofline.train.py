"""The SSD scan's share of its roofline in a traced train step, in %:
the bound of each mixer's forward (counted once, so remat's replay is
time spent against the same work) and backward (`yardstick.ssd_cost`,
`ssd_bwd_cost`) over the device time of the SSD kernels.  The names are
the `__global__` functions of `src/repro_torch/kernels/csrc/ssd.cu`
(namespaces scalar, tc, bwd, tcb)."""

import re

from portbench import yardstick

NAMES = re.compile(
    r"\b(scalar|tc|bwd|tcb)::(ssd_kernel|chunk_state|state_pass|chunk_out|"
    r"own_states|scan_states|chunk_grads|sum_heads|sum_da|dstate_pass|"
    r"chunk_dx|chunk_dbc|chunk_rows|sum_groups)\b")


def read(cell, out):
    tr, c, t = out.trace, cell.config, cell.traffic
    if tr is None or not tr.on_card or not yardstick.mixers(c):
        return None
    us = tr.device_us(lambda n: NAMES.search(n) is not None)
    if us <= 0:
        return None
    B, S = t["batch"], t["seq_len"]
    P, N = c["ssm_head_dim"], c["ssm_state"]
    H = c["expand"] * c["d_model"] // P
    bound = (yardstick.ssd_cost(B, S, H, P, N)[2]
             + yardstick.ssd_bwd_cost(B, S, H, P, N)[2])
    return 100.0 * bound * yardstick.mixers(c) * tr.calls / (us / 1e6)
