"""The port's sharding specs against the JAX package's, with no process
group: ``param_specs`` under the four policies, ``batch_specs`` and
``cache_specs``, for every config of ``configs/base.py`` at its published
widths, on the production meshes — an abstract (16, 16) mesh with batch
axes ("data",) and a (2, 16, 16) one with ("pod", "data") (JAX's
``AbstractMesh``; the port's ``MeshCtx.abstract``).  The port's
parameter shapes come from its own ``meta`` init and must equal JAX's
``eval_shape``; the cache specs take the JAX cache's shapes (the port's
``local`` ring is shorter than JAX's cache where the window is).  Then
``shard_tree`` / ``unshard_tree`` round trips on a one-rank gloo group
and the abstract mesh's shard shapes."""
import jax
import jax.numpy as jnp
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from jax.sharding import AbstractMesh, PartitionSpec

from repro import sharding as jsh
from repro import trees as jtrees
from repro.configs import SHAPES, list_configs
from repro.configs import get_config as jget
from repro.launch.steps import make_input_batch_shapes as jbatch
from repro.models import Model as JModel
from repro_torch import sharding, trees
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_input_batch_shapes
from repro_torch.models.transformer import Model

MESHES = {"single": ((16, 16), ("data", "model"), ("data",)),
          "multi": ((2, 16, 16), ("pod", "data", "model"), ("pod", "data"))}
ARCHS = list_configs()


def _meshes(kind):
    sizes, names, batch = MESHES[kind]
    jmc = jsh.MeshCtx(mesh=AbstractMesh(sizes, names), batch_axes=batch)
    return jmc, sharding.MeshCtx.abstract(sizes, names, batch)


def _jflat(tree):
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): tuple(v)
            for p, v in leaves}


def _jshapes(arch, max_seq):
    cfg = jget(arch)
    model = JModel(cfg)
    return cfg, model, jax.eval_shape(lambda k: model.init(k, max_seq=max_seq),
                                      jax.ShapeDtypeStruct((2,), jnp.uint32))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, mesh):
    jmc, mc = _meshes(mesh)
    jcfg, _, jshapes = _jshapes(arch, 4104)
    cfg = get_config(arch)
    pshapes = Model(cfg, device="meta").init(None, max_seq=4104)
    jsz = {p: tuple(v.shape) for p, v in jtrees.flatten(jshapes).items()}
    psz = {p: tuple(v.shape) for p, v in trees.flatten(pshapes).items()}
    assert psz == jsz
    for policy in ("fsdp", "fsdp_experts_only", "tp", "dp"):
        want = _jflat(jsh.param_specs(jmc, jshapes, jcfg, policy=policy))
        got = {p: tuple(s) for p, s in trees.flatten(
            sharding.param_specs(mc, pshapes, cfg, policy=policy)).items()}
        assert got == want, policy


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_jax(arch, mesh):
    jmc, mc = _meshes(mesh)
    jcfg = jget(arch)
    for name in ("train_4k", "decode_32k", "long_500k"):
        shape = SHAPES[name]
        want = _jflat(jsh.batch_specs(jmc, jbatch(jcfg, shape)))
        got = {p: tuple(s) for p, s in trees.flatten(sharding.batch_specs(
            mc, make_input_batch_shapes(get_config(arch), shape))).items()}
        assert got == want, name
    if jcfg.is_encoder_only:
        return
    model = JModel(jcfg)
    for batch in (128, 1):
        jcache = model.cache_spec(batch, 2048)
        want = _jflat(jsh.cache_specs(jmc, jcache, batch=batch))
        meta = {p: torch.empty(v.shape, device="meta")
                for p, v in jtrees.flatten(jcache).items()}
        got = {p: tuple(s) for p, s in trees.flatten(sharding.cache_specs(
            mc, trees.unflatten(meta), batch=batch)).items()}
        assert got == want, batch


def test_abstract_shards_and_round_trip(tmp_path):
    """Local shapes on the abstract mesh divide the whole ones; on a
    one-rank gloo group shard → unshard is the identity, and
    ``MeshCtx.create`` makes a group for every axis set."""
    _, mc = _meshes("single")
    cfg = get_config("llama3.2-1b")
    shapes = Model(cfg, device="meta").init(None, max_seq=64)
    specs = trees.flatten(sharding.param_specs(mc, shapes, cfg))
    local = trees.flatten(sharding.shard_tree(shapes, specs, mc))
    for p, v in trees.flatten(shapes).items():
        want = sharding.local_shape(v.shape, specs[p], mc)
        assert tuple(local[p].shape) == want, p
    assert tuple(local["embed"].shape) == (cfg.vocab_size // 16, cfg.d_model // 16)
    assert mc.coords == {"data": 0, "model": 0}
    assert sharding.MeshCtx.abstract((2, 4), rank=6).coords == {"data": 1, "model": 2}
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        one = sharding.MeshCtx.create((1, 1))
        assert set(one.groups) == {("data",), ("model",), ("data", "model")}
        small = Model(cfg.reduced(d_model=64), device="cpu")
        params = small.init(torch.Generator().manual_seed(0), max_seq=16)
        sp = sharding.param_specs(one, params, small.cfg)
        back = sharding.unshard_tree(sharding.shard_tree(params, sp, one), sp, one)
        for p, v in trees.flatten(params).items():
            assert torch.equal(trees.flatten(back)[p], v), p
        cs = sharding.cohort_sharding(one, 3)
        assert cs.n_shards == 1 and cs.lead and cs.total == 3
    finally:
        dist.destroy_process_group()
