"""Port parity: checkpoints of training state (``repro_torch.ckpt``'s
``save_checkpoint``, ``load_checkpoint``, ``latest_step`` and
``CheckpointManager``) against the JAX package's ``repro.ckpt``.

The directory tests mirror ``tests/test_checkpoint.py`` on the port's
trees (tensors and numpy arrays). Across packages: the same manifest and
the same npz members byte for byte; a float32 checkpoint written by
either restores bitwise in the other; a run resumed across packages
against JAX's uninterrupted run. Tolerances of that resume: losses
``rtol=1e-4``, parameters as ``test_torch_train.assert_steps_close``
(99.9 % within ``5e-3 * lr`` a step, all within ``lr / 4`` a step).
"""
import json
import os
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.ckpt import load_checkpoint as j_load_checkpoint
from repro.ckpt import save_checkpoint as j_save_checkpoint
from repro.configs import llama3_8b as j_llama
from repro.models.transformer import lm as jlm
from repro.train import AdamWConfig as JAdamWConfig
from repro.train import init_opt_state as j_init_opt_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.ckpt import (CheckpointManager, latest_step,
                              load_checkpoint, save_checkpoint)
from repro_torch.ckpt.checkpoint import (tree_flatten, tree_unflatten,
                                         treedef_str)
from repro_torch.configs import llama3_8b
from repro_torch.data.pipeline import lm_token_stream
from repro_torch.device import host_array
from repro_torch.launch.train import load_state, state_tree
from repro_torch.models.transformer import lm
from repro_torch.train import AdamWConfig, init_opt_state, make_train_step
from test_torch_train import assert_steps_close

OCFG = dict(lr=3e-3, warmup_steps=2, total_steps=20)


def _tree(seed=0, kind="torch"):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    if kind == "numpy":
        return dict(w=w, nested=dict(b=b), step=np.asarray(7, np.int32))
    return dict(w=torch.from_numpy(w), nested=dict(b=torch.from_numpy(b)),
                step=torch.tensor(7, dtype=torch.int32))


def _zeros_like(tree):
    leaves, td = tree_flatten(tree)
    return tree_unflatten(td, [torch.zeros_like(torch.as_tensor(l))
                               for l in leaves])


def _leaves_equal(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        assert x.dtype == y.dtype and torch.equal(x, y)


# ------------------------------------------------- directory behaviour

@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_save_load_roundtrip(tmp_path, kind):
    tree = _tree(kind=kind)
    save_checkpoint(str(tmp_path), 3, tree)
    restored, step = load_checkpoint(str(tmp_path), _zeros_like(tree),
                                     device="cpu")
    assert step == 3
    _leaves_equal(restored, _tree())


def test_crash_mid_save_leaves_committed_intact(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    os.makedirs(tmp_path / "step_00000002.tmp")
    (tmp_path / "step_00000002.tmp" / "garbage").write_text("partial")
    _, step = load_checkpoint(str(tmp_path), _zeros_like(_tree()),
                              device="cpu")
    assert step == 1                  # the torn write is invisible


def test_manager_keeps_last_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, _tree(s))
    mgr.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    assert steps == [3, 4]


def test_latest_step_ignores_nonconforming_entries(tmp_path):
    save_checkpoint(str(tmp_path), 5, _tree())
    (tmp_path / "step_final").mkdir()
    (tmp_path / "step_7.bak").write_text("x")
    (tmp_path / "step_").mkdir()
    (tmp_path / "notes.txt").write_text("x")
    assert latest_step(str(tmp_path)) == 5
    _, step = load_checkpoint(str(tmp_path), _zeros_like(_tree()),
                              device="cpu")
    assert step == 5
    assert latest_step(str(tmp_path / "absent")) is None


def test_manager_start_cleans_orphaned_tmp_dirs(tmp_path):
    save_checkpoint(str(tmp_path), 1, _tree())
    orphan = tmp_path / "step_00000009.tmp"
    orphan.mkdir()
    (orphan / "shard_0.npz").write_text("torn")
    keepme = tmp_path / "step_custom_notes"      # non-conforming: kept
    keepme.mkdir()
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert not orphan.exists() and keepme.exists()
    mgr.save_async(2, _tree(2))
    mgr.wait()
    assert latest_step(str(tmp_path)) == 2


def test_save_over_orphaned_tmp_does_not_merge_stale_shards(tmp_path):
    tmp = tmp_path / "step_00000003.tmp"
    tmp.mkdir()
    (tmp / "shard_99.npz").write_text("stale garbage")
    save_checkpoint(str(tmp_path), 3, _tree())
    committed = tmp_path / "step_00000003"
    assert committed.is_dir() and not (committed / "shard_99.npz").exists()
    _, step = load_checkpoint(str(tmp_path), _zeros_like(_tree()),
                              device="cpu")
    assert step == 3


def test_save_async_snapshots_before_returning(tmp_path):
    """The caller may update its tensors in place right after
    ``save_async``: the checkpoint holds the values at the call."""
    tree = _tree()
    want = _zeros_like(tree)
    for a, b in zip(tree_flatten(want)[0], tree_flatten(tree)[0]):
        a.copy_(b)
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save_async(1, tree)
    tree["w"].add_(1.0)
    mgr.wait()
    restored, _ = mgr.restore_latest(_zeros_like(want), device="cpu")
    _leaves_equal(restored, want)


def test_load_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path), _tree(), device="cpu")
    save_checkpoint(str(tmp_path), 1, _tree(), shards=2)
    # shardings= keeps a slice: a whole leaf (None) as it is, and a leaf
    # under a spec on a one-rank mesh whole too (its one block), marked
    _sliced_restore(tmp_path)
    with pytest.raises(ValueError, match="leaf count"):
        load_checkpoint(str(tmp_path), dict(w=torch.zeros(16, 8)),
                        device="cpu")
    bad = _tree()
    bad["w"] = torch.zeros(8, 16)
    with pytest.raises(ValueError, match="leaf 2"):
        load_checkpoint(str(tmp_path), bad, device="cpu")
    restored, _ = load_checkpoint(str(tmp_path), _tree(), device="cpu")
    _leaves_equal(restored, _tree())             # two shards


@pytest.mark.parametrize("leaf", ["w", "h"])
def test_load_refuses_a_flipped_bit(tmp_path, leaf):
    """A bit flipped in a stored member's data is caught by its CRC-32,
    as ``np.load`` (and so the JAX package's loader) catches it."""
    tree = dict(_tree(), h=torch.randn(64, 8).bfloat16())
    d = save_checkpoint(str(tmp_path), 1, tree)
    shard = os.path.join(d, "shard_0.npz")
    data = bytearray(open(shard, "rb").read())
    at = data.find(host_array(tree[leaf]).tobytes())
    assert at > 0
    data[at + 17] ^= 0x10
    open(shard, "wb").write(data)
    with pytest.raises(zipfile.BadZipFile, match="CRC-32"):
        load_checkpoint(str(tmp_path), tree, device="cpu")


def test_host_array_gives_bf16_as_its_ml_dtypes_bits():
    import ml_dtypes
    x = np.random.default_rng(0).standard_normal(9).astype(
        ml_dtypes.bfloat16)
    t = torch.from_numpy(x.astype(np.float32)).bfloat16()
    a = host_array(t)
    assert a.dtype == np.dtype("V2") and a.tobytes() == x.tobytes()
    u = torch.tensor([0, 1, 65535], dtype=torch.int32).to(torch.uint16)
    assert host_array(u).tolist() == [0, 1, 65535]


@pytest.mark.parametrize("tree", [
    dict(b=[1, (2, 3)], a=dict(z=0, y=None), c=4, d=[], e={}),
    dict(opt=dict(m=dict(w=0), step=1), params=dict(w=2)),
    [dict(x=1), (2,), None]])
def test_treedef_is_printed_as_jax_prints_it(tree):
    leaves, td = tree_flatten(tree)
    j_leaves, j_td = jax.tree_util.tree_flatten(tree)
    assert treedef_str(td) == str(j_td) and leaves == j_leaves


# ------------------------------------------------------ across packages

def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_bf16_tree_is_written_as_jax_writes_it(tmp_path):
    """The same manifest and the same npz members byte for byte (a bf16
    leaf as ``'<V2'`` items), restored bitwise by the port; JAX's own
    ``load_checkpoint`` cannot restore it (a reference-side fault)."""
    rng = np.random.default_rng(0)
    jt = dict(w=jnp.asarray(rng.standard_normal((6, 5)), jnp.bfloat16),
              n=jnp.asarray(rng.standard_normal(5), jnp.float32),
              step=jnp.asarray(2, jnp.int32))
    pt = dict(w=torch.from_numpy(np.asarray(jt["w"]).view(np.int16))
              .view(torch.bfloat16),
              n=torch.from_numpy(np.asarray(jt["n"])),
              step=torch.tensor(2, dtype=torch.int32))
    j_save_checkpoint(str(tmp_path / "jax"), 2, jt)
    save_checkpoint(str(tmp_path / "port"), 2, pt)
    d = {w: tmp_path / w / "step_00000002" for w in ("jax", "port")}
    assert json.loads((d["jax"] / "manifest.json").read_text()) \
        == json.loads((d["port"] / "manifest.json").read_text())
    assert _npz_members(d["jax"] / "shard_0.npz") \
        == _npz_members(d["port"] / "shard_0.npz")
    for who in ("jax", "port"):
        restored, _ = load_checkpoint(str(tmp_path / who), pt, device="cpu")
        _leaves_equal(restored, pt)
    with pytest.raises(ValueError):
        j_load_checkpoint(str(tmp_path / "port"), jt)


def _llama():
    jcfg = j_llama.REDUCED
    params = jax.jit(jlm.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    return llama3_8b.REDUCED, jcfg, params


def _batches(cfg, n):
    gen = lm_token_stream(cfg.vocab, 4, 16, seed=11)()
    return [next(gen) for _ in range(n)]


def _port_state(cfg, device="cpu"):
    mod = lm.init_params(cfg, seed=1, device=device)
    return mod, init_opt_state(mod)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """JAX trains 3 steps and checkpoints ``dict(params, opt)``; the port
    restores it into freshly drawn parameters and trains 3 more; the
    result against JAX's 6 uninterrupted steps."""
    cfg, jcfg, jparams = _llama()
    batches = _batches(cfg, 6)
    jstep = jax.jit(j_make_train_step(lambda p, b: jlm.loss_fn(p, b, jcfg),
                                      JAdamWConfig(**OCFG)))
    p, o = jparams, j_init_opt_state(jparams)
    losses = []
    for i, b in enumerate(batches):
        p, o, m = jstep(p, o, {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(m["loss"]))
        if i == 2:
            j_save_checkpoint(str(tmp_path), 3, dict(params=p, opt=o))
    mod, opt = _port_state(cfg)
    restored, step = load_checkpoint(str(tmp_path),
                                     state_tree(mod, opt, device="meta"),
                                     device="cpu")
    assert step == 3
    load_state(restored, mod, opt)
    assert int(opt["step"]) == 3
    step_fn = make_train_step(lambda q, b: lm.loss_fn(q, b, cfg),
                              AdamWConfig(**OCFG))
    for i, b in enumerate(batches[3:]):
        mod, opt, m = step_fn(mod, opt, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), losses[3 + i],
                                   rtol=1e-4)
    assert_steps_close(lm.to_jax_layout(dict(mod.named_parameters())), p,
                       OCFG["lr"], 3)
    assert int(opt["step"]) == int(o["step"]) == 6


def test_port_checkpoint_restores_bitwise_in_jax(tmp_path):
    """The port trains 2 steps and checkpoints its state in the JAX
    layout; JAX's ``load_checkpoint`` restores it bitwise (float32)."""
    cfg, jcfg, jparams = _llama()
    mod, opt = _port_state(cfg)
    step_fn = make_train_step(lambda q, b: lm.loss_fn(q, b, cfg),
                              AdamWConfig(**OCFG), microbatches=2)
    for b in _batches(cfg, 2):
        mod, opt, _ = step_fn(mod, opt, {k: torch.from_numpy(v)
                                         for k, v in b.items()})
    save_checkpoint(str(tmp_path), 2, state_tree(mod, opt))
    like = dict(params=jparams, opt=j_init_opt_state(jparams))
    restored, step = j_load_checkpoint(str(tmp_path), like)
    assert step == 2
    mine = state_tree(mod, opt)
    leaves, _ = tree_flatten(mine)
    theirs = jax.tree.leaves(restored)
    assert len(leaves) == len(theirs)
    for a, b in zip(leaves, theirs):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(restored["params"]["layers"]["attn"]["wq"][1]),
        mod.layers[1].attn.wq.weight.detach().numpy().T)


def test_resume_in_the_port_is_bitwise(tmp_path):
    """Kill and restart inside the port: 2 steps, ``save_async``, a
    restore into freshly drawn parameters, 2 more steps equal 4
    uninterrupted steps bit for bit."""
    cfg = llama3_8b.REDUCED
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in _batches(cfg, 4)]
    step_fn = make_train_step(lambda q, b: lm.loss_fn(q, b, cfg),
                              AdamWConfig(**OCFG), microbatches=2)
    ref, ref_opt = _port_state(cfg)
    for b in batches:
        ref, ref_opt, _ = step_fn(ref, ref_opt, b)
    mod, opt = _port_state(cfg)
    for b in batches[:2]:
        mod, opt, _ = step_fn(mod, opt, b)
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save_async(2, state_tree(mod, opt))
    mgr.wait()
    mod = lm.init_params(cfg, seed=9, device="cpu")
    opt = init_opt_state(mod)
    restored, _ = mgr.restore_latest(state_tree(mod, opt, device="meta"),
                                     device="cpu")
    load_state(restored, mod, opt)
    for b in batches[2:]:
        mod, opt, _ = step_fn(mod, opt, b)
    for (n, a), b in zip(mod.named_parameters(), ref.parameters()):
        assert torch.equal(a, b), n
    for k in ("m", "v"):
        for n, a in opt[k].items():
            assert torch.equal(a, ref_opt[k][n]), (k, n)
    assert torch.equal(opt["step"], ref_opt["step"])


def _sliced_restore(tmp_path):
    """``load_checkpoint(shardings=)`` on a one-rank mesh: each leaf under
    its (mesh, spec) is the rank's block, marked with the spec."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.sharding import P, spec_of
    from test_torch_mesh_tp import free_port
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        like = _tree()
        shardings = _zeros_like(like)
        leaves, treedef = tree_flatten(like)
        specs = [(mesh, P("model", *(None,) * (l.dim() - 1)))
                 if l.dim() else None for l in leaves]
        shardings = tree_unflatten(treedef, specs)
        restored, _ = load_checkpoint(str(tmp_path), like, device="cpu",
                                      shardings=shardings)
        _leaves_equal(restored, _tree())
        for leaf, sh in zip(tree_flatten(restored)[0], specs):
            assert (spec_of(leaf) is None) == (sh is None)
    finally:
        dist.destroy_process_group()
