"""``gather_dot_cand``'s share of its roofline over the profiled stretch:
the least time the bytes and operations it must move and do at its
inputs (``reference/workbytes.gather_dot_cand``: one forward row for
each distinct live candidate, q once for each distinct (query,
coordinate)) would take at the H100's peaks, over its device time in the
trace."""
from perfbench.reference import peaks, workbytes

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "qps"
SYMBOL = "gather_dot_cand_kernel"
VALUE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def collect(ctx):
    """(bytes, operations) summed over the profiled stretch."""
    icfg = ctx.config["index"]
    if icfg.get("fwd_quant"):
        return None
    nnz = ctx.coll.doc_coords.shape[1]
    row = nnz * (VALUE_BYTES[icfg["fwd_dtype"]] + 4)
    nbytes = ops = 0
    for probe in ctx.probes:
        b, o = workbytes.gather_dot_cand(
            probe["cand"], ctx.coll.doc_coords.shape[0],
            ctx.coll.doc_coords, ctx.coll.dim, row)
        nbytes, ops = nbytes + b, ops + o
    return nbytes * ctx.repeats, ops * ctx.repeats


def read(rec):
    work, t = rec.collected.get("gather_dot_cand_roofline"), rec.device_trace
    if work is None or t is None or t.kernel_s(SYMBOL) <= 0:
        return None
    return peaks.roofline_share(*work, t.kernel_s(SYMBOL))
