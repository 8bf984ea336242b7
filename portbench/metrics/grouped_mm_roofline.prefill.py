"""The MoE block's expert products' share of their roofline in a traced
prefill, in %: the bound of the three grouped GEMMs of each MoE layer
(`yardstick.gmm_cost` over the rows routed, batch x length x experts
per token, every expert's weights read) over the device time of the
kernels launched under `aten::_grouped_mm`."""

from portbench import yardstick

OP = "aten::_grouped_mm"


def read(cell, out):
    tr, c, t = out.trace, cell.config, cell.traffic
    if tr is None or not tr.on_card or not c.get("n_experts"):
        return None
    us = tr.device_us_under.get(OP, 0.0)
    if us <= 0:
        return None
    rows = t["batch"] * t["seq_len"] * c["experts_per_token"]
    d, f, E = c["d_model"], c.get("moe_d_ff") or c["d_ff"], c["n_experts"]
    bound = (2 * yardstick.gmm_cost(rows, d, f, E)[2]
             + yardstick.gmm_cost(rows, f, d, E)[2])
    return 100.0 * bound * c["n_layers"] * tr.calls / (us / 1e6)
