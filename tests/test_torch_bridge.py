"""Bridge between the JAX package's trees and the port's, and the port's
import hygiene."""
import ast
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro import trees as jtrees
from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.models import peft as jpeft
from repro_torch import bridge, trees
from repro_torch.configs import get_config

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_trees():
    jcfg = jget_config("gpt2-small").reduced(d_model=128, repeats=2)
    params = JModel(jcfg).init(jax.random.PRNGKey(0), max_seq=32)
    lora = jpeft.init_lora(jax.random.PRNGKey(1), params,
                           jpeft.PEFTConfig(lora_rank=4, lora_layers=1))
    flat_p = {k: np.asarray(v) for k, v in jtrees.flatten(params).items()}
    flat_l = {k: np.asarray(v) for k, v in jtrees.flatten(lora).items()}
    return flat_p, flat_l


@pytest.fixture
def cfg():
    return get_config("gpt2-small").reduced(d_model=128, repeats=2)


def test_params_round_trip_is_bit_exact(jax_trees, cfg):
    flat_p, _ = jax_trees
    params = bridge.params_from_numpy(flat_p, cfg)
    assert isinstance(params["stages"], list)
    assert isinstance(params["stages"][0]["layers"], list)
    assert params["stages"][0]["layers"][0]["mixer"]["wq"].shape == (2, 128, 128)
    back = bridge.to_numpy(params)
    assert back.keys() == flat_p.keys()
    for k, v in flat_p.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_lora_round_trip_is_bit_exact(jax_trees, cfg):
    _, flat_l = jax_trees
    assert set(flat_l) == {f"stages/0/layers/0/mixer/{w}/{f}"
                           for w in ("wq", "wv") for f in ("a", "b", "mask")}
    lora = bridge.lora_from_numpy(flat_l, cfg)
    assert lora["stages"][0]["layers"][0]["mixer"]["wq"]["mask"].shape == (2, 1, 1)
    back = bridge.to_numpy(lora)
    assert back.keys() == flat_l.keys()
    for k, v in flat_l.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_port_init_lora_mirrors_jax_layout(jax_trees, cfg):
    """The port's own init_lora has the JAX factor paths, shapes, zero B and
    last-n-repeats mask."""
    from repro_torch.models import peft
    flat_p, flat_l = jax_trees
    params = bridge.params_from_numpy(flat_p, cfg)
    lora = peft.init_lora(torch.Generator().manual_seed(0), params,
                          peft.PEFTConfig(lora_rank=4, lora_layers=1))
    mine = bridge.to_numpy(lora)
    assert {k: v.shape for k, v in mine.items()} == {k: v.shape for k, v in flat_l.items()}
    for k, v in mine.items():
        if k.endswith(("/b", "/mask")):
            np.testing.assert_array_equal(v, flat_l[k], err_msg=k)


def test_mamba2_params_and_lora_round_trip_is_bit_exact():
    """A JAX mamba2 tree (f32 a_log / d_skip / dt_bias beside the mixer
    weights, no position table) and its LoRA tree on in_proj / out_proj."""
    jcfg = jget_config("mamba2-1.3b").reduced(d_model=64, repeats=2)
    params = JModel(jcfg).init(jax.random.PRNGKey(0))
    lora = jpeft.init_lora(jax.random.PRNGKey(1), params, jpeft.PEFTConfig(lora_rank=4))
    flat_p = {k: np.asarray(v) for k, v in jtrees.flatten(params).items()}
    flat_l = {k: np.asarray(v) for k, v in jtrees.flatten(lora).items()}
    assert "pos_embed" not in flat_p
    assert {k.rsplit("/", 2)[-2] for k in flat_l} == {"in_proj", "out_proj"}
    cfg = get_config("mamba2-1.3b").reduced(d_model=64, repeats=2)
    for flat, load in ((flat_p, bridge.params_from_numpy), (flat_l, bridge.lora_from_numpy)):
        back = bridge.to_numpy(load(flat, cfg))
        assert back.keys() == flat.keys()
        for k, v in flat.items():
            assert back[k].dtype == v.dtype, k
            np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_bridge_rejects_mismatched_trees(jax_trees, cfg):
    flat_p, flat_l = jax_trees
    with pytest.raises(KeyError, match="params lack"):
        bridge.params_from_numpy(
            {k: v for k, v in flat_p.items() if "/layers/" not in k}, cfg)
    with pytest.raises(ValueError, match="repeats"):
        bridge.params_from_numpy(flat_p, get_config("gpt2-small").reduced(
            d_model=128, repeats=1))
    with pytest.raises(ValueError, match="not LoRA factor"):
        bridge.lora_from_numpy(flat_p, cfg)


def test_trees_paths_match_jax_flatten(jax_trees, cfg):
    flat_p, _ = jax_trees
    params = bridge.params_from_numpy(flat_p, cfg)
    assert list(trees.flatten(params)) == sorted(flat_p)
    shapes = trees.map_with_path(lambda p, v: (p, tuple(v.shape)), params)
    assert shapes["stages"][0]["layers"][0]["ff"]["wu"] == (
        "stages/0/layers/0/ff/wu", flat_p["stages/0/layers/0/ff/wu"].shape)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p.relative_to(ROOT).as_posix()
    for p in [*(ROOT / "src" / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_port_imports_neither_jax_nor_reference(path):
    bad = [m for m in _imports(ROOT / path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_obs_and_fl_export_the_jax_packages_names():
    """``repro_torch.obs`` and ``repro_torch.fl`` export the JAX package's
    names (the profiler bracket renamed ``torch_profile_*``; obs adds the
    runners' ``open_run``/``close_run``), and the new modules import on
    the CPU."""
    import importlib

    import repro.fl as jfl
    import repro.obs as jobs
    from repro_torch import fl, obs
    assert set(obs.__all__) - {n.replace("jax_", "torch_") for n in jobs.__all__} == {
        "open_run", "close_run"}      # the port's runners' shared setup
    assert {n.replace("jax_", "torch_") for n in jobs.__all__} <= set(obs.__all__)
    assert all(hasattr(obs, n) for n in obs.__all__)
    jnames = {n for n in dir(jfl) if not n.startswith("_") and n[0].isupper() or n == "run_rounds"}
    assert jnames <= set(dir(fl))
    for mod in ("obs.metrics", "obs.trace", "obs.health", "fl.population", "fl.client",
                "fl.server", "fl.rounds", "wireless.scenarios", "launch.report"):
        importlib.import_module(f"repro_torch.{mod}")
