"""Checkpoints across meshes and packages, and both launchers on a mesh of
gloo ranks on the CPU.

* The port saves llama3 REDUCED's training state (parameters, ZeRO-1
  moments after one step, step) on (2, 2); the JAX package's
  ``load_checkpoint`` restores it unsharded, bitwise equal to the state
  the ranks gathered.
* The JAX package saves a sharded state on 8 host devices; the port
  restores it on (2, 1) with ``shardings=``: every rank's slice of every
  leaf bitwise the slice of what JAX saved (the moments cut over "data"
  by ZeRO-1).
* ``launch/train.py --reduced --devices 4 --model-parallel 2 --device
  cpu`` trains 12 steps on a (2, 2) mesh, then resumes from its
  checkpoint.
* ``launch/serve.py --devices 4 --doc-shards 4 --device cpu`` answers
  bitwise as ``search_shards`` on the same collection.
"""
import jax
import numpy as np
import pytest
import torch

from helpers import run_with_devices
from repro.ckpt import load_checkpoint as j_load
from repro_torch.launch import serve, train
from test_torch_mesh_tp import run_ranks

SAVE_CODE = r"""
import sys
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.ckpt import save_checkpoint
from repro_torch.distributed.sharding import gather_tensor, set_mesh, spec_of
from repro_torch.launch.train import _sharded_state, state_tree
from repro_torch.models.api import get_bundle
from repro_torch.models.transformer import lm, parallel
from repro_torch.data.pipeline import lm_token_stream
from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
rank, world, port, path, dst = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=world, rank=rank)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
bundle = get_bundle("llama3-8b")
cfg = bundle.reduced
with set_mesh(mesh):
    params = bundle.init(0, cfg, {}, device="cpu", mesh=mesh)
    opt = init_opt_state(params, zero=True)
    step = make_train_step(bundle.step(cfg, {}, "train"), AdamWConfig(),
                           grad_axes=parallel.batch_axes(cfg))
    batch = {k: torch.from_numpy(v) for k, v in
             next(lm_token_stream(cfg.vocab, 4, 16)()).items()}
    params, opt, _ = step(params, opt, batch)
    like, shardings = _sharded_state(cfg, params, opt, mesh)
    save_checkpoint(path, 1, state_tree(params, opt), shardings=shardings)
    full = {n: gather_tensor(p.detach(), spec_of(p), mesh)
            for n, p in params.named_parameters()}
    m = {n: gather_tensor(t, spec_of(t), mesh) for n, t in opt["m"].items()}
if rank == 0:
    out = {}
    def walk(node, pre):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, pre + k + "/")
            else:
                out[pre + k] = v.numpy()
    walk(dict(params=lm.to_jax_layout(full), m=lm.to_jax_layout(m)), "")
    np.savez(dst, **out)
dist.barrier()
dist.destroy_process_group()
"""

JAX_SAVE = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.ckpt import save_checkpoint
from repro.distributed.param_sharding import opt_state_specs
from repro.models.api import get_bundle
bundle = get_bundle("llama3-8b")
cfg = bundle.reduced
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = {}
with jax.set_mesh(mesh):
    params = bundle.init(jax.random.PRNGKey(3), cfg, {})
    pspecs = bundle.param_specs(params)
    ospecs = opt_state_specs(pspecs, params, zero=True, dp=("data",),
                             dp_size=2)
    put = lambda t, s: jax.tree.map(
        lambda a, sp: jax.device_put(a, NamedSharding(mesh, sp)), t, s,
        is_leaf=lambda x: isinstance(x, P))
    m = jax.tree.map(lambda p: p * 2.0 + 1.0, params)
    v = jax.tree.map(lambda p: p * p, params)
    state = dict(params=put(params, pspecs),
                 opt=dict(m=put(m, ospecs["m"]), v=put(v, ospecs["v"]),
                          step=jnp.asarray(7, jnp.int32)))
    save_checkpoint(sys.argv[1], 7, state)
for name, tree in (("params", params), ("m", m), ("v", v)):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[name + "/" + "/".join(str(p.key) for p in path)] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
print("OK jax")
"""

RESTORE_CODE = r"""
import sys
import numpy as np, torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.ckpt import load_checkpoint
from repro_torch.distributed.sharding import local_part, set_mesh, spec_of
from repro_torch.launch.train import _sharded_state, load_state
from repro_torch.models.api import get_bundle
from repro_torch.models.transformer import lm
from repro_torch.train import init_opt_state
rank, world, port, path, src = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4], sys.argv[5])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        world_size=world, rank=rank)
mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("data", "model"))
a = np.load(src)
bundle = get_bundle("llama3-8b")
cfg = bundle.reduced
with set_mesh(mesh):
    params = bundle.init(0, cfg, {}, device="cpu", mesh=mesh)
    opt = init_opt_state(params, zero=True)
    like, shardings = _sharded_state(cfg, params, opt, mesh)
    tree, step = load_checkpoint(path, like, device="cpu",
                                 shardings=shardings)
    load_state(tree, params, opt)
assert step == 7 and int(opt["step"]) == 7
cut = 0
for kind, named in (("params", dict(params.named_parameters())),
                    ("m", opt["m"]), ("v", opt["v"])):
    for name, t in named.items():
        path_, layer, transpose = lm.jax_path(name)
        full = a[kind + "/" + "/".join(path_)]
        full = full[layer] if layer is not None else full
        full = torch.from_numpy(np.ascontiguousarray(full.T if transpose
                                                     else full))
        want = full[local_part(spec_of(t), full.shape, mesh)]
        cut += tuple(want.shape) != tuple(full.shape)
        assert torch.equal(t.detach(), want), (kind, name)
assert cut > 0, "no leaf was cut"
dist.barrier()
dist.destroy_process_group()
"""


def _nested(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def test_port_mesh_checkpoint_restores_in_jax_bitwise(tmp_path):
    path, dst = str(tmp_path / "ckpt"), str(tmp_path / "full.npz")
    run_ranks(SAVE_CODE, 4, path, dst)
    want = _nested(dict(np.load(dst)))
    like = dict(params=want["params"],
                opt=dict(m=want["m"], v=want["m"],
                         step=np.zeros((), np.int32)))
    got, step = j_load(path, like)
    assert step == 1 and int(got["opt"]["step"]) == 1
    for kind, tree in (("params", got["params"]), ("m", got["opt"]["m"])):
        flat_got = jax.tree_util.tree_flatten_with_path(tree)[0]
        flat_want = dict(jax.tree_util.tree_flatten_with_path(want[kind])[0])
        assert len(flat_got) == len(flat_want)
        for p, leaf in flat_got:
            np.testing.assert_array_equal(np.asarray(leaf), flat_want[p])


def test_jax_8_device_checkpoint_restores_on_a_2x1_mesh(tmp_path):
    path, full = str(tmp_path / "ckpt"), str(tmp_path / "full.npz")
    code = JAX_SAVE.replace("sys.argv[1]", repr(path)).replace(
        "sys.argv[2]", repr(full))
    assert "OK jax" in run_with_devices(code, n_devices=8, timeout=600)
    run_ranks(RESTORE_CODE, 2, path, full)


def test_train_launcher_on_a_mesh_trains_and_resumes(tmp_path, capsys):
    argv = ["--reduced", "--devices", "4", "--model-parallel", "2",
            "--device", "cpu", "--steps", "12", "--batch", "4", "--seq",
            "16", "--ckpt-dir", str(tmp_path), "--resume"]
    first = train.main(argv)
    text = capsys.readouterr().out
    assert "mesh={'data': 2, 'model': 2}" in text and "backend=gloo" in text
    assert "no checkpoint; fresh start" in text and "done" in text
    assert first["start"] == 0 and np.isfinite(first["loss"])
    second = train.main(argv)
    text = capsys.readouterr().out
    assert "resumed from step 12" in text and second["start"] == 12
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000020", "step_00000024"]


def test_serve_launcher_on_a_mesh_is_search_shards_bitwise():
    from repro_torch.core import SeismicConfig
    from repro_torch.core.distributed import (build_sharded_index,
                                              search_shards)
    from repro_torch.data import SyntheticSparseConfig, make_collection
    argv = ["--n-docs", "1024", "--dim", "512", "--queries", "16",
            "--device", "cpu"]
    out = serve.main(argv + ["--devices", "4", "--doc-shards", "4"])
    assert out["mesh"] == {"data": 1, "model": 4}
    assert out["backend"] == "gloo"
    # every rank reports its own launches (none on the CPU: the plain
    # versions run), rank 0's among them
    assert len(out["rank_launches"]) == 4
    assert out["rank_launches"][0] == out["launches"]
    assert all(r.keys() == out["launches"].keys() and not any(r.values())
               for r in out["rank_launches"])
    args = serve.parse_args(argv)
    docs, queries, _ = make_collection(SyntheticSparseConfig(
        dim=512, n_docs=1024, n_queries=16, doc_nnz=96, query_nnz=32),
        device="cpu")
    sharded = build_sharded_index(docs, SeismicConfig(
        lam=192, beta=12, alpha=0.4, block_cap=32, summary_nnz=48), 4)
    scores, ids, _ = search_shards(sharded, queries, serve.search_params(args))
    torch.testing.assert_close(out["ids"], ids, rtol=0, atol=0)
    torch.testing.assert_close(out["scores"], scores, rtol=0, atol=0)
