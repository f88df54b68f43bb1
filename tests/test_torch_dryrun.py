"""The port's dry-run toolchain against the JAX package's: the roofline,
collective and dot accounting (``repro_torch.distributed.roofline``,
``hlo_analysis``), the dry run (``launch.dryrun``) and its report.

* The accounting counterparts of ``tests/test_serving_and_analysis.py``'s
  analysis tests: shape bytes (the dtype byte table equal to JAX's),
  collective bytes of a known recording equal to JAX's parser on the
  same collectives in HLO text, dot flops of a traced step equal to the
  hand count and to ``FlopCounterMode``, each roofline term times its
  constant equal to JAX's.
* The report's two tables equal JAX's strings on the same records, the
  compute lever's text aside (tensor cores, not MXUs).
* REDUCED llama3-8b train, prefill and decode, wide-deep train and
  sasrec train, each traced on a fake (2, 2) mesh in a subprocess,
  against the JAX dry run's own lowering (``_lower_lm`` /
  ``_lower_generic``) on (2, 2) forced host devices in another:
  ``argument_bytes`` equals ``memory_analysis().argument_size_in_bytes``,
  and the dot flops are within 1 % of ``hlo_dot_flops`` of the lowering
  the JAX probe uses (unrolled, remat off, one attention tile). The
  recsys models keep the rows split over the data ranks after the
  lookup, as GSPMD splits them, so each data rank runs its half of the
  dense layers (wide-deep's wide part is a matrix-vector product, which
  XLA counts as a dot and the port dispatches as ``mv``: 0.12 % of its
  flops).
* The port's collective bytes of the TP prefill equal a hand count of
  its exchanges: an all-reduce of the rank's [b, s, d] rows after the
  vocab-parallel embedding and after each layer's attention and FFN,
  nothing for the vocab-parallel head (its logits stay split).
* Seismic's analytic flops and bytes equal ``_lower_seismic``'s on
  REDUCED.
* ``main --arch llama3-8b --shape train_4k`` on the fake 256-rank mesh
  writes a record with the JAX record's keys, and the fake backend's
  collectives raise outside ``collectives.dry_run()``.

``repro.launch.dryrun`` sets ``XLA_FLAGS`` when imported, so all of the
JAX work runs in one subprocess, which starts its backend before it
imports that module; the port's dry run starts a process group, so it
runs in a subprocess of its own. The two run at once.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from helpers import REPO

CELLS = (
    ("llama-train", "llama3-8b", "train", dict(seq_len=16, global_batch=4)),
    ("llama-prefill", "llama3-8b", "prefill",
     dict(seq_len=16, global_batch=4)),
    ("llama-decode", "llama3-8b", "decode", dict(seq_len=32, global_batch=4)),
    ("wd-train", "wide-deep", "train", dict(batch=64)),
    ("sasrec-train", "sasrec", "train", dict(batch=64)),
)
SEISMIC_DIMS = dict(batch=8, k=10, cut=4, block_budget=8)
JAX_RECORD_KEYS = ("arch", "shape", "mesh", "multi_pod", "n_chips", "kind",
                   "compile_s", "memory", "cost", "collectives", "roofline",
                   "probe", "flops_source", "model_flops",
                   "model_flops_ratio", "tag")
MEMORY_KEYS = ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
               "peak_est")

JAX_CODE = r"""
import dataclasses, json, sys
import jax
jax.devices()     # the backend starts on this process's devices before
from repro.launch import dryrun as D      # dryrun sets its XLA_FLAGS
from repro.configs.base import ShapeCell
from repro.configs import seismic_msmarco
from repro.distributed.hlo_analysis import hlo_dot_flops
from repro.models.api import get_bundle
CELLS, SEISMIC_DIMS = {cells}, {seismic}
mesh = jax.make_mesh((2, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {{}}
for name, arch, kind, dims in CELLS:
    bundle = get_bundle(arch)
    cfg = bundle.reduced
    b = dataclasses.replace(bundle, config=cfg)
    cell = ShapeCell(name, kind, dims)
    with jax.set_mesh(mesh):
        if bundle.family == "lm":
            lowered, _ = D._lower_lm(b, cell, mesh)
            probe = dataclasses.replace(
                cfg, unroll_layers=True, remat="none",
                attn_q_chunk=max(dims.get("seq_len", 512), 512))
            plow, _ = D._lower_lm(dataclasses.replace(b, config=probe), cell,
                                  mesh)
        else:
            lowered, _ = D._lower_generic(b, cell, mesh)
            plow = lowered
        arg = lowered.compile().memory_analysis().argument_size_in_bytes
        dots = hlo_dot_flops(plow.compile().as_text())
    out[name] = dict(argument_bytes=int(arg), **dots)
proxy = D._seismic_override(seismic_msmarco, {{}})
proxy.CONFIG = seismic_msmarco.REDUCED
with jax.set_mesh(mesh):
    _, _, analytic = D._lower_seismic(
        proxy, ShapeCell("q", "retrieval", SEISMIC_DIMS), mesh)
out["seismic"] = analytic
json.dump(out, open(sys.argv[1], "w"))
print("OK jax")
"""

PORT_CODE = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs import seismic_msmarco
from repro_torch.configs.base import ShapeCell
from repro_torch.distributed import collectives as C
from repro_torch.distributed.sharding import set_mesh
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.models.api import get_bundle
CELLS, SEISMIC_DIMS = {cells}, {seismic}
out = {{}}
D.fake_world(4)
mesh = make_mesh_for(4, 2)
for name, arch, kind, dims in CELLS:
    bundle = get_bundle(arch)
    cfg = bundle.reduced
    if bundle.family == "lm":      # the JAX probe's config
        cfg = dataclasses.replace(cfg, remat="none", attn_q_chunk=max(
            dims.get("seq_len", 512), 512))
    got = D.trace_cell(bundle, cfg, kind, dims, mesh)
    out[name] = dict(argument_bytes=got["memory"]["argument_bytes"],
                     peak_est=got["memory"]["peak_est"],
                     collectives=got["collectives"], **got["dots"])
proxy = D._seismic_override(seismic_msmarco, {{}})
proxy.CONFIG = seismic_msmarco.REDUCED
got = D.seismic_cell(proxy, ShapeCell("q", "retrieval", SEISMIC_DIMS),
                     dict(data=2, model=2))
out["seismic"] = dict(flops=got["flops"], bytes=got["bytes"])

raised = []
with set_mesh(mesh):
    x = torch.empty(4, device="meta")
    for what, ctx, t in (("outside", None, x),
                         ("cpu tensor", C.dry_run, torch.zeros(4))):
        try:
            if ctx is None:
                C.all_reduce(t, "model")
            else:
                with ctx():
                    C.all_reduce(t, "model")
        except RuntimeError as e:
            raised.append((what, str(e)))
out["raised"] = raised
rc = D.main(["--arch", "llama3-8b", "--shape", "train_4k", "--out",
             sys.argv[2]])
out["main_rc"] = rc
json.dump(out, open(sys.argv[1], "w"))
print("OK port")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    jout, pout, rec_dir = tmp / "jax.json", tmp / "port.json", tmp / "recs"
    fmt = dict(cells=CELLS, seismic=SEISMIC_DIMS)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-c", JAX_CODE.format(**fmt),
                               str(jout)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True),
             subprocess.Popen([sys.executable, "-c", PORT_CODE.format(**fmt),
                               str(pout), str(rec_dir)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-4000:]
    return (json.loads(jout.read_text()), json.loads(pout.read_text()),
            rec_dir)


# ------------------------------------------------------------ accounting

def test_dtype_bytes_and_shape_bytes_equal_jax():
    from repro.distributed import hlo_analysis as J
    from repro_torch.distributed import hlo_analysis as H
    assert H._DTYPE_BYTES == J._DTYPE_BYTES
    assert set(H.HLO_TYPES.values()) == set(J._DTYPE_BYTES)
    assert H.shape_bytes(torch.float32, (16, 8)) == J._shape_bytes(
        "f32[16,8]") == 512
    assert H.shape_bytes(torch.bfloat16, (4,)) == J._shape_bytes(
        "bf16[4]{0}") == 8
    assert H.shape_bytes(torch.bool, ()) == J._shape_bytes("pred[]") == 1
    assert H.shape_bytes(torch.float32, (2, 2)) + H.shape_bytes(
        torch.uint8, (3,)) == J._shape_bytes("(f32[2,2], u8[3])") == 19


def test_collective_bytes_of_a_recording_equal_jax():
    """The collectives of JAX's parser test as the port records them
    (each one's input, on an axis of 2 ranks): the same bytes."""
    from repro.distributed.hlo_analysis import collective_bytes as jax_cb
    from repro_torch.distributed.hlo_analysis import collective_bytes
    hlo = """
ENTRY %main {
  %ar = f32[128]{0} all-reduce(%x), replica_groups={}
  %ag.1 = bf16[64,2]{1,0} all-gather(%y), dimensions={0}
  %rs = (f32[8]{0}, f32[8]{0}) reduce-scatter(%a, %b), dimensions={0}
  %a2a = f32[4,4]{1,0} all-to-all(%z), dimensions={0}
  %done = f32[128]{0} all-reduce-done(%start)
}
"""
    records = [("all_reduce", "model", torch.float32, (128,)),
               ("all_gather", "model", torch.bfloat16, (32, 2)),
               ("reduce_scatter", "model", torch.float32, (16,)),
               ("reduce_scatter", "model", torch.float32, (16,)),
               ("all_to_all", "model", torch.float32, (4, 4))]
    got = collective_bytes(records, {"model": 2})
    assert got == jax_cb(hlo)
    assert got["total_wire"] == got["total"] + 512


def test_dot_flops_of_a_traced_step():
    """JAX's counter test's two dots (a [16, 32] x [32, 8] product and a
    batched [4, 8, 16] x [4, 16, 2] one) as the port dispatches them,
    with a linear, an einsum and a backward pass: the hand count, and
    ``FlopCounterMode``'s on the same step."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.distributed.hlo_analysis import (StepTrace, count_ops,
                                                      dot_flops)
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(16, 32, generator=g), torch.randn(32, 8, generator=g)
    c, d = (torch.randn(4, 8, 16, generator=g),
            torch.randn(4, 16, 2, generator=g))
    w = torch.randn(8, 32, generator=g, requires_grad=True)

    def step():
        y = torch.mm(a, b).sum() + torch.bmm(c, d).sum()
        z = torch.nn.functional.linear(a, w)              # [16, 8]
        u = torch.einsum("bij,bjk->bik", c, d)            # a bmm
        (z.sum() + u.sum()).backward()
        return y

    with StepTrace() as trace:
        step()
    with FlopCounterMode(display=False) as fc:
        step()
    want = 8192 + 2048 + 8192 + 2048 + 8192     # + the linear's backward
    out = dot_flops(trace)
    assert out == dict(dot_flops=want, n_dots=5, n_while=0)
    assert fc.get_total_flops() == want
    assert count_ops(trace, ["mm", "bmm"])["bmm"] == 2


def test_step_trace_peak_counts_live_storage():
    from repro_torch.distributed.hlo_analysis import StepTrace
    x = torch.empty(1024, device="meta")
    with StepTrace() as trace:
        trace.exclude([x])
        y = x * 2                      # 4 KiB
        z = y + 1                      # 8 KiB live
        del y
        w = z.view(32, 32) * 3         # y freed: 8 KiB again
        x.add_(1)                      # an argument: not counted
    assert trace.peak_bytes == 8192
    assert w.shape == (32, 32)


def test_roofline_terms_times_constants_equal_jax():
    from repro.distributed import roofline as J
    from repro_torch.distributed import roofline as R
    args = dict(flops=3.1e14, hbm_bytes=2.2e12, coll_bytes=7.5e10)
    mine, theirs = R.Roofline(**args), J.Roofline(**args)
    assert mine.t_compute * R.PEAK_FLOPS == pytest.approx(
        theirs.t_compute * J.PEAK_FLOPS)
    assert mine.t_memory * R.HBM_BW == pytest.approx(
        theirs.t_memory * J.HBM_BW)
    assert mine.t_collective * R.LINK_BW == pytest.approx(
        theirs.t_collective * J.ICI_BW)
    r = R.Roofline(flops=989e12, hbm_bytes=3.35e12, coll_bytes=25e9)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(1.0)
    assert r.t_collective == pytest.approx(0.5)
    assert r.compute_fraction() == pytest.approx(1.0)
    assert R.model_flops_train(8e9, 1e6) == pytest.approx(4.8e16)
    assert R.model_flops_infer(8e9, 1e6) == J.model_flops_infer(8e9, 1e6)
    assert set(r.as_dict()) == set(J.Roofline(1, 1, 1).as_dict())


def test_roofline_bottleneck_pick():
    from repro_torch.distributed.roofline import Roofline
    r = Roofline(flops=1e12, hbm_bytes=1e9, coll_bytes=500e9)
    assert r.bottleneck == "collective"
    assert r.compute_fraction() < 0.01


# ---------------------------------------------------------------- report

def _records():
    def rec(arch, shape, kind, flops, hbm, coll, mfr, **kw):
        from repro_torch.distributed.roofline import Roofline
        return dict(arch=arch, shape=shape, kind=kind, tag="",
                    multi_pod=False, model_flops_ratio=mfr,
                    memory=dict(peak_est=hbm / 3),
                    roofline=Roofline(flops, hbm, coll).as_dict(), **kw)
    return [rec("llama3-8b", "train_4k", "train", 2.1e14, 1e12, 1e11, 0.93),
            rec("llama3-8b", "train_4k", "train", 1e14, 5e11, 5e10, 0.9,
                ) | dict(multi_pod=True),
            rec("fm", "serve_p99", "serve", 3e15, 1e9, 1e6, None),
            rec("gin-tu", "molecule", "train", 1e9, 5e10, 1e3, None),
            dict(arch="phi3-medium-14b", shape="long_500k",
                 skipped="pure full-attention arch")]


def test_report_tables_equal_jax():
    from repro.launch import report as J
    from repro_torch.launch import report as R
    recs = _records()
    want = J.roofline_table(recs)
    for k, text in J.LEVERS.items():
        want = want.replace(text, R.LEVERS[k])
    assert R.roofline_table(recs) == want
    assert "tensor cores" in R.roofline_table(recs)
    assert R.dryrun_matrix(recs) == J.dryrun_matrix(recs)


# ------------------------------------------------------ traced REDUCED cells

@pytest.mark.parametrize("cell", [c[0] for c in CELLS])
def test_argument_bytes_equal_jax(runs, cell):
    j, p, _ = runs
    assert p[cell]["argument_bytes"] == j[cell]["argument_bytes"]


@pytest.mark.parametrize("cell", [c[0] for c in CELLS])
def test_dot_flops_within_a_percent_of_jax(runs, cell):
    j, p, _ = runs
    assert j[cell]["n_while"] == 0 and p[cell]["n_while"] == 0
    assert p[cell]["dot_flops"] > 0
    assert p[cell]["dot_flops"] == pytest.approx(j[cell]["dot_flops"],
                                                 rel=1e-2)


def test_tp_prefill_collectives_are_its_all_reduces(runs):
    from repro_torch.configs import llama3_8b
    cfg = llama3_8b.REDUCED
    _, p, _ = runs
    b, s = 4 // 2, 16                 # the rank's rows on (2, 2)
    per = b * s * cfg.d_model * 4     # float32
    want = (2 * cfg.n_layers + 1) * per
    assert p["llama-prefill"]["collectives"] == {
        "all-reduce": want, "total": want, "total_wire": 2 * want}


def test_seismic_analytic_cost_equals_jax(runs):
    j, p, _ = runs
    assert p["seismic"] == j["seismic"]


def test_main_writes_a_record_and_the_fake_backend_needs_the_dry_run(runs):
    _, p, rec_dir = runs
    assert p["main_rc"] == 0
    files = os.listdir(rec_dir)
    assert files == ["llama3-8b__train_4k__singlepod.json"]
    rec = json.loads((rec_dir / files[0]).read_text())
    assert set(JAX_RECORD_KEYS) <= set(rec)
    assert tuple(rec["memory"]) == MEMORY_KEYS
    assert rec["mesh"] == "16x16" and rec["n_chips"] == 256
    assert rec["probe"] is None and rec["flops_source"] == "dispatch-count"
    assert 0.5 < rec["model_flops_ratio"] < 1.0
    assert np.isfinite(rec["roofline"]["t_collective"])
    assert [w for w, _ in p["raised"]] == ["outside", "cpu tensor"]
    assert "dry_run" in p["raised"][0][1]
