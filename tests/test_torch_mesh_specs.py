"""Port parity of the sharding rules: ``repro_torch.distributed`` against
the JAX package's ``repro.distributed``, no devices needed.

Equal (as tuples) to JAX's:
* the parameter spec trees of every registered model arch, REDUCED and
  full ``CONFIG`` (shapes only: the port's meta tensors, JAX's
  ``eval_shape``), the LMs in both ``sharding_mode``s, the port's
  unstacked ``[out, in]`` leaves restacked by ``jax_layout_specs``;
* ``opt_state_specs(zero=True)`` (and so ``zero_shard_spec``) over the
  data axes, and ``cache_specs`` at a batch that splits over the data
  axes and at one that does not;
* ``logical``, ``dp_axes``, ``tp_axis`` and ``mesh_axis_size`` on 2- and
  3-axis meshes and with no mesh (JAX on an abstract mesh, the port on a
  mesh stub that names its axes and sizes).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.distributed import param_sharding as jps
from repro.distributed import sharding as jsh
from repro.models.api import get_bundle as j_get_bundle
from repro.models.transformer import lm as jlm
from repro_torch.configs.base import list_archs
from repro_torch.distributed import param_sharding as ps
from repro_torch.distributed import sharding as sh
from repro_torch.models.api import get_bundle
from repro_torch.models.transformer import lm

MODEL_ARCHS = [a for a in list_archs() if a != "seismic-msmarco"]
LM_ARCHS = [a for a in MODEL_ARCHS
            if get_bundle(a).family == "lm"]
META = torch.device("meta")


def _flat_jax(tree) -> dict:
    out = {}
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    for path, spec in leaves:
        key = ".".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = tuple(spec)
    return out


def _flat(tree, pre="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) and not isinstance(v, sh.PartitionSpec):
            out.update(_flat(v, f"{pre}{k}."))
        else:
            out[pre + k] = tuple(v)
    return out


def _dims(bundle) -> dict:
    return dict(bundle.shapes[0].dims) if bundle.family == "gnn" else {}


def _jax_shapes(arch, which):
    b = j_get_bundle(arch)
    cfg = getattr(b, which)
    return b, cfg, jax.eval_shape(
        lambda: b.init(jax.random.PRNGKey(0), cfg, _dims(b)))


@pytest.mark.parametrize("which", ["reduced", "config"])
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_param_specs_equal_jax(arch, which):
    bundle = get_bundle(arch)
    cfg = getattr(bundle, which)
    params = bundle.init(0, cfg, _dims(bundle), device=META)
    jb, jcfg, shapes = _jax_shapes(arch, which)
    if bundle.family == "lm":
        for mode in ("tp", "fsdp"):
            got = ps.jax_layout_specs(ps.lm_param_specs(params, mode))
            assert _flat(got) == _flat_jax(jps.lm_param_specs(shapes, mode))
        got = ps.jax_layout_specs(bundle.param_specs(params))
    else:
        got = bundle.param_specs(params)
    assert _flat(got) == _flat_jax(jb.param_specs(shapes))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_zero_and_cache_specs_equal_jax(arch):
    bundle = get_bundle(arch)
    cfg = bundle.config
    params = bundle.init(0, cfg, {}, device=META)
    jb, _, shapes = _jax_shapes(arch, "config")
    jspecs = jps.lm_param_specs(shapes)
    jax_tree = lm.to_jax_layout(dict(params.named_parameters()))
    specs = ps.jax_layout_specs(ps.lm_param_specs(params))
    for dp, n in ((("data",), 16), (("pod", "data"), 32), ("data", 3)):
        got = ps.opt_state_specs(specs, jax_tree, zero=True, dp=dp,
                                 dp_size=n)
        want = jps.opt_state_specs(jspecs, shapes, zero=True, dp=dp,
                                   dp_size=n)
        assert _flat(got["m"]) == _flat_jax(want["m"])
        assert tuple(got["step"]) == tuple(want["step"]) == ()
    assert ps.opt_state_specs(specs, jax_tree)["v"] is specs
    for batch, dp_size, tp_size in ((8, 8, 16), (1, 16, 16), (4, 2, 4)):
        cache = lm.init_cache(cfg, batch, 64, device=META)
        jcache = jax.eval_shape(lambda: jlm.init_cache(jb.config, batch, 64))
        got = ps.cache_specs(cache, ("data",), dp_size, tp_size)
        want = jps.cache_specs(jcache, ("data",), dp_size, tp_size)
        assert {k: tuple(v) for k, v in got.items()} == _flat_jax(want)


class _Mesh:
    """What the port's helpers read of a DeviceMesh: axis names, sizes
    and this rank's position."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.mesh = np.zeros(shape)

    def get_local_rank(self, name):
        return 0


LOGICAL = [("dp", None), ("tp",), (("dp", "tp"), None), ("dp", "tp", None),
           (None, "model"), ("pod",), (("tp", "dp"),), ("data", "tp")]


@pytest.mark.parametrize("shape,names", [
    (None, None), ((2, 4), ("data", "model")),
    ((2, 2, 4), ("pod", "data", "model")), ((8,), ("data",))])
def test_logical_axes_equal_jax(shape, names):
    def port():
        return ([tuple(sh.logical(*n)) for n in LOGICAL], sh.dp_axes(),
                sh.tp_axis(), [sh.mesh_axis_size(a) for a in
                               ("pod", "data", "model")])

    def jax_side():
        return ([tuple(jsh.logical(*n)) for n in LOGICAL], jsh.dp_axes(),
                jsh.tp_axis(), [jsh.mesh_axis_size(a) for a in
                                ("pod", "data", "model")])

    if shape is None:
        assert port() == jax_side()
        assert sh.get_mesh() is None
        return
    with sh.set_mesh(_Mesh(shape, names)):
        mine = port()
    with jax.sharding.use_abstract_mesh(
            jax.sharding.AbstractMesh(shape, names)):
        theirs = jax_side()
    assert mine == theirs
    assert sh.get_mesh() is None


def test_local_part_cuts_row_major():
    """A spec entry of several axes cuts its dim row-major over them (the
    first axis major), as a JAX NamedSharding places its blocks."""

    class _At(_Mesh):
        def __init__(self, pos):
            super().__init__((2, 4), ("data", "model"))
            self.pos = pos

        def get_local_rank(self, name):
            return self.pos[name]

    full = torch.arange(8 * 6).reshape(8, 6)
    for d in range(2):
        for m in range(4):
            mesh = _At(dict(data=d, model=m))
            part = sh.local_part(sh.P(("data", "model"), None), full.shape,
                                 mesh)
            assert part[0] == slice(d * 4 + m, d * 4 + m + 1)
            assert sh.local_shape(sh.P(None, "data"), (8, 6), mesh) == (8, 3)
    with pytest.raises(ValueError, match="does not split"):
        sh.local_part(sh.P("model"), (6,), _At(dict(data=0, model=0)))
