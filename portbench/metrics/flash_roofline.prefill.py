"""The flash-attention forward's share of its roofline in a traced
prefill, in %: each attention layer's causal bound (`yardstick.fa_cost`)
over the device time of the flash kernels, the `__global__` functions
`flash_fwd` and `flash_fwd_tc` of
`src/repro_torch/kernels/csrc/flash_attention.cu`."""

import re

from portbench import yardstick

NAMES = re.compile(r"\bflash_fwd(_tc)?\b")


def read(cell, out):
    tr, c, t = out.trace, cell.config, cell.traffic
    if tr is None or not tr.on_card:
        return None
    us = tr.device_us(lambda n: NAMES.search(n) is not None)
    if us <= 0:
        return None
    bound = yardstick.fa_cost(t["batch"], t["seq_len"], c["n_heads"],
                              c["n_kv_heads"], c["head_dim"],
                              c.get("sliding_window"))[2]
    return 100.0 * bound * yardstick.attention_apps(c) * tr.calls / (us / 1e6)
