"""Every published head width in the port: the routing of a call's row
widths to the attention kernels' compiled tiles, and gemma3-12b's heads of
240 served against the JAX package on the CPU (f32, numpy-seeded LoRA,
the JAX package's own weights carried across the bridge)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro import trees as jtrees
from repro.configs import LK as JLK
from repro.configs import Stage as JStage
from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.models import peft as jpeft
from repro.sharding import MeshCtx
from repro_torch import bridge
from repro_torch.configs import LK, Stage, get_config
from repro_torch.kernels.flash_attn.ops import SQUARE, WIDTHS, instance
from repro_torch.models.transformer import Model

TOL = 1e-5
PROMPT, STEPS = 80, 8


# ---------------------------------------------------------------- routing
@pytest.mark.parametrize("dk,dv,want", [
    ((240, 240, (256, 256))), (16, 16, (32, 32)), (32, 16, (32, 32)),
    (80, 64, (96, 64)), (48, 32, (64, 64)), (120, 120, (128, 128)),
    *[(dk, dv, (dk, dv)) for dk, dv in WIDTHS]])
def test_instance_picks_the_smallest_tile(dk, dv, want):
    """A call's (dk, dv) runs in the smallest compiled tile that holds it:
    gemma3's 240 in 256, the launcher's default heads of 16 (and its MLA's
    (32, 16)) in 32, every compiled pair in itself; f32 and bf16 alike."""
    assert instance(dk, dv) == want
    assert instance(dk, dv, itemsize=2) == want
    if dk == dv:
        assert instance(dk, dv, widths=SQUARE) == want


@pytest.mark.parametrize("dk,dv,itemsize", [
    (260, 260, 4), (288, 288, 4), (264, 128, 4), (18, 18, 4), (34, 32, 4), (32, 2, 4),
    (12, 12, 2), (36, 36, 2), (240, 20, 2), (0, 0, 4)])
def test_instance_refuses_what_no_tile_holds(dk, dv, itemsize):
    """Rows wider than 256 or not whole 16-byte chunks raise, naming the
    width (the wrappers raise so on the card and never run the plain
    version there)."""
    with pytest.raises(ValueError, match=f"head width {dk}"):
        instance(dk, dv, itemsize)


def test_decode_takes_square_tiles_only():
    """The decode kernel's layouts are the square tiles: heads of 96 run at
    128 and heads of 192 at 256, as in the prefill kernels (whose MLA tiles
    (96, 64) and (192, 128) hold no v of 96 or 192)."""
    assert instance(96, 96, widths=SQUARE) == instance(96, 96) == (128, 128)
    assert instance(192, 192, widths=SQUARE) == instance(192, 192) == (256, 256)


# ---------------------------------------------------------------- gemma3
def _gemma3_cut(get, lk, stage):
    """gemma3-12b at heads of 240: 2 query heads on 1 KV head, d 480, one
    ``local`` (window 64) and one global layer, vocab 512."""
    cfg = get("gemma3-12b").reduced(d_model=480, repeats=1, vocab=512)
    return dataclasses.replace(cfg, n_heads=2, n_kv_heads=1, head_dim=240, window=64,
                               stages=(stage((lk("local", "mlp"), lk("attn", "mlp")), 1),))


@pytest.mark.parametrize("impl", ["auto", "sparse"])
def test_gemma3_head_width_240_serving_matches_jax(impl):
    """Prefill of 80 tokens (the 64-slot ring wraps) and 8 teacher-forced
    decode steps against JAX's ``prefill``/``decode_step`` with nonzero LoRA
    on wq and wv: logits within 1e-5 at every step, and the caches after the
    last within 1e-4 (RoPE's frequency table, below).  ``impl="sparse"`` runs the global layer block-sparse (block 16,
    local 2, sink 1, stride 4), the local layer keeps its window."""
    jcfg, cfg = _gemma3_cut(jget_config, JLK, JStage), _gemma3_cut(get_config, LK, Stage)
    assert cfg.hd == jcfg.hd == 240 and dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jm = JModel(jcfg, meshctx=MeshCtx.single_device(), impl=impl)
    key = jax.random.PRNGKey(0)
    jp = jm.init(key, max_seq=PROMPT + STEPS)
    pc = jpeft.PEFTConfig(lora_rank=4, lora_alpha=8.0)
    jl0 = jpeft.init_lora(key, jp, pc)
    rng = np.random.RandomState(1)
    flat_l = {k: (np.asarray(v) if k.endswith("/mask")
                  else (rng.randn(*v.shape) * 0.1).astype(np.float32))
              for k, v in jtrees.flatten(jl0).items()}
    jl = jtrees.map_with_path(lambda p, v: jnp.asarray(flat_l[p]), jl0)
    flat_p = {k: np.asarray(v) for k, v in jtrees.flatten(jp).items()}
    m = Model(cfg, device="cpu", impl=impl)
    tp, tl = bridge.params_from_numpy(flat_p, cfg), bridge.lora_from_numpy(flat_l, cfg)
    toks = np.random.RandomState(2).randint(6, cfg.vocab_size, size=(2, PROMPT + STEPS))
    cl, scale = PROMPT + STEPS, jpeft.lora_scale(pc)
    jlog, jc = jm.prefill(jp, jnp.asarray(toks[:, :PROMPT]), cl, lora=jl, lora_scale=scale)
    tlog, tc = m.prefill(tp, torch.from_numpy(toks[:, :PROMPT]), cl, lora=tl,
                         lora_scale=scale)
    for t in range(STEPS + 1):
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TOL, rtol=0,
                                   err_msg=f"step {t}")
        if t == STEPS:
            break
        nxt = toks[:, PROMPT + t:PROMPT + t + 1]
        jlog, jc = jm.decode_step(jp, jc, jnp.asarray(nxt), lora=jl, lora_scale=scale)
        tlog, tc = m.decode_step(tp, tc, torch.from_numpy(nxt), lora=tl, lora_scale=scale)
    assert tc["pos"] == int(jc["pos"]) == cl
    for pi, kind in enumerate(cfg.stages[0].pattern):
        for name, buf in tc["stages"][0][pi].items():
            want = np.asarray(jc["stages"][0][pi][name])
            assert buf.shape == want.shape and buf.shape[-1] == 240
            assert buf.shape[2] == (cfg.window if kind.mixer == "local" else cl)
            # 1e-4: the port's RoPE frequencies are the correctly rounded
            # exp, JAX's XLA exp is an ulp off at some of the 120
            # (test_torch_zoo.py::test_rope_matches_jax), so pos·f differs
            # by up to ~1e-5 at these positions: k is stored rotated, and the
            # global layer's k and v see the local layer's output
            np.testing.assert_allclose(buf.numpy(), want, atol=1e-4, rtol=0,
                                       err_msg=f"layer {pi} {name}")
