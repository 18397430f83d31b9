"""The port's dry run (``launch/dryrun.py``) and FLOP counter
(``launch/flop_cost.py``) against the JAX package's, on the CPU:

* ``step_flops``' GEMM count equals JAX's ``count_flops`` restricted to
  ``dot_general`` (its elementwise set emptied) for a reduced forward and
  a train step with remat (the recompute counted on both sides), for a
  dense GQA decoder, gpt2 and an MoE decoder;
* ``analytic_memory_bytes`` (with the parameter counts it reads) and
  ``pick_impl`` equal JAX's for every config, shape and step;
* ``run_one`` writes a row for each step kind on ``meta`` under the
  abstract (16, 16) mesh (reduced configs and shapes, so it is quick), with
  the JAX dry run's keys, collectives recorded and nothing allocated."""
import json

import jax
import jax.numpy as jnp
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.configs import list_configs
from repro.launch import dryrun as jdry
from repro.launch import jaxpr_cost
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import Model as JModel
from repro.sharding import MeshCtx as JMeshCtx
from repro_torch.configs import InputShape, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.flop_cost import count_flops
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import Model

B, S = 2, 32


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gpt2-small", "dbrx-132b"])
def test_gemm_flops_match_jax_dot_general(arch, monkeypatch):
    monkeypatch.setattr(jaxpr_cost, "_ELEMWISE", set())
    jm = JModel(jget(arch).reduced(d_model=64), meshctx=JMeshCtx.single_device(), remat=True)
    jp = jax.eval_shape(lambda k: jm.init(k, max_seq=S), jax.ShapeDtypeStruct((2,), jnp.uint32))
    sds = jax.ShapeDtypeStruct
    jb = {"tokens": sds((B, S), jnp.int32), "labels": sds((B, S), jnp.int32),
          "mask": sds((B, S), jnp.float32)}
    want_fwd = jaxpr_cost.step_flops(lambda p, b: jm.lm_loss(p, b), jp, jb)
    step, opt = jmake_train_step(jm)
    want_step = jaxpr_cost.step_flops(step, jp, jax.eval_shape(opt.init, jp), jb)

    m = Model(get_config(arch).reduced(d_model=64), device="meta", remat=True)
    p = m.init(None, max_seq=S)
    b = {"tokens": torch.zeros(B, S, dtype=torch.long, device="meta"),
         "labels": torch.zeros(B, S, dtype=torch.long, device="meta"),
         "mask": torch.empty(B, S, device="meta")}
    _, fwd = count_flops(lambda: m.lm_loss(p, b))
    fn, popt = make_train_step(m)
    _, tr = count_flops(fn, p, popt.init(p), b)
    assert fwd["gemm"] == want_fwd
    assert tr["gemm"] == want_step
    assert tr["elementwise"] > 0 and tr["total"] == tr["gemm"] + tr["elementwise"]


@pytest.mark.parametrize("arch", list_configs())
def test_analytic_memory_and_pick_impl_match_jax(arch):
    jcfg, cfg = jget(arch), get_config(arch)
    assert dryrun.param_count(cfg) == jcfg.param_count()
    assert dryrun.active_param_count(cfg) == jcfg.active_param_count()
    for name, shape in dryrun.SHAPES.items():
        for step in ("train", "train_peft", "fl_round", "prefill", "decode"):
            for cache in (0, 12345):
                assert dryrun.analytic_memory_bytes(cfg, shape, step, cache) == \
                    jdry.analytic_memory_bytes(jcfg, JSHAPES[name], step, cache)
        for opts in (None, {"sparse_impl": True}):
            assert dryrun.pick_impl(cfg, shape, opts) == jdry.pick_impl(jcfg, JSHAPES[name],
                                                                        opts)


SMALL = {"train_4k": InputShape("train_4k", 64, 32, "train"),
         "decode_32k": InputShape("decode_32k", 128, 32, "decode"),
         "prefill_32k": InputShape("prefill_32k", 64, 32, "prefill")}


@pytest.mark.parametrize("arch,shape,step", [
    ("tinyllama-1.1b", "train_4k", "train"), ("tinyllama-1.1b", "train_4k", "train_peft"),
    ("gpt2-small", "train_4k", "fl_round"), ("tinyllama-1.1b", "prefill_32k", "prefill"),
    ("tinyllama-1.1b", "decode_32k", "decode"), ("dbrx-132b", "train_4k", "train")])
def test_run_one_rows(arch, shape, step, tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "get_config", lambda a: get_config(a).reduced(d_model=64))
    monkeypatch.setattr(dryrun, "SHAPES", SMALL)
    allocated = torch.cuda.memory_allocated() if torch.cuda.is_available() else 0
    row = dryrun.run_one(arch, shape, "single", step, out_dir=str(tmp_path), verbose=False)
    with open(tmp_path / f"{arch}_{shape}_single_{step}.json") as f:
        assert json.load(f) == json.loads(json.dumps(row))
    assert set(row) >= {"arch", "shape", "mesh", "step", "impl", "n_chips", "opts",
                        "shard_policy", "global", "per_device", "roofline",
                        "model_flops_total", "useful_flops_ratio"}
    pd = row["per_device"]
    assert row["n_chips"] == 256 and pd["peak_memory_bytes"] is None
    assert 0 < pd["flops"] <= row["global"]["flops"] and pd["argument_bytes"] > 0
    assert pd["collective_wire_bytes"] == (2 * pd["collectives"]["all-reduce"]
                                           + pd["collectives"]["all-gather"]
                                           + pd["collectives"]["reduce-scatter"]
                                           + pd["collectives"]["all-to-all"])
    if step != "decode":      # FSDP gathers at least, and their reduce-scatters in training
        assert pd["collectives"]["all-gather"] > 0
    if step == "train":       # the FSDP leaves' gradients
        assert pd["collectives"]["reduce-scatter"] > 0
    if step in ("train_peft", "fl_round"):   # the replicated trainables' sum over data
        assert pd["collectives"]["all-reduce"] > 0
    assert row["roofline"]["dominant"] in ("compute", "memory", "collective")
    if torch.cuda.is_available():
        assert torch.cuda.memory_allocated() == allocated
