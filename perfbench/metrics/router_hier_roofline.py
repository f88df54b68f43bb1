"""``router_hier``'s share of its roofline over the profiled stretch:
the least time the bytes and operations it must move and do at its
inputs (``reference/workbytes.router_hier``: the probed lists' live
superblock rows, each distinct scored child summary, q once for each
distinct (query, coordinate)) would take at the H100's peaks, over its
device time in the trace; nothing on a flat route."""
from perfbench.reference import peaks, workbytes

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "qps"
SYMBOL = "router_hier_kernel"


def collect(ctx):
    """(bytes, operations) summed over the profiled stretch."""
    p, index = ctx.params, ctx.index
    if p.superblock_fanout <= 0:
        return None
    ns = index.sup_coords.shape[1]
    kept = min(p.superblock_budget, p.cut * ns)
    nbytes = ops = 0
    for probe in ctx.probes:
        b, o = workbytes.router_hier(
            probe["lists"], probe["router_r"], index.block_len,
            index.sup_coords, index.sum_coords, p.superblock_fanout, kept,
            ctx.coll.dim)
        nbytes, ops = nbytes + b, ops + o
    return nbytes * ctx.repeats, ops * ctx.repeats


def read(rec):
    work, t = rec.collected.get("router_hier_roofline"), rec.device_trace
    if work is None or t is None or t.kernel_s(SYMBOL) <= 0:
        return None
    return peaks.roofline_share(*work, t.kernel_s(SYMBOL))
