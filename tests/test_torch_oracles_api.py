"""The last public names of the JAX package the port lacked, against the
JAX package on the CPU: the list aggregation API (``masked_fedavg``,
``partial_fedavg``: within 1e-7 of JAX's and bit-identical to the port's
stacked forms, all-outage included), ``cohort.stack_host_batches``, the
tree helpers ``byte_size``/``count_params``/``mask_like``/``tree_scale``,
the PEFT names ``merge_lora``, ``strip_adapters``, ``has_factors``,
``is_lora_leaf``, ``is_lora_path`` and ``LoraProj`` on ``init_lora`` /
``init_adapters`` trees, the analytic ``ModelConfig.param_count`` /
``active_param_count`` / ``sub_quadratic`` (exactly equal for every
registered config), the merged-LoRA oracle ``factored=False`` of
``run_pftt`` (pftt and fedlora at ``test_torch_fl.py``'s ``PFTT_KW``,
engine and loop: bytes and delays equal to JAX's ``factored=False`` run,
accuracies within 1e-6; losses within 1e-5 of the port's factored run)
and of the step builders (a step's loss and trainables within 1e-5), and
the ``none`` mixer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_fl import PFTT_KW, _tree
from test_torch_fl import _export_init as pftt_init
from test_torch_launch import _factors, _np

from repro import trees as jtrees
from repro.configs import get_config as jget_config
from repro.configs import list_configs as jlist_configs
from repro.core import aggregation as jagg
from repro.core import cohort as jcohort
from repro.core import pftt as jpftt
from repro.launch import steps as jsteps
from repro.models import Model as JModel
from repro.models import peft as jpeft
from repro.models import blocks as jblocks
from repro_torch import bridge, trees
from repro_torch.configs import get_config, list_configs
from repro_torch.core import aggregation, cohort, pftt
from repro_torch.launch import steps
from repro_torch.models import blocks, peft
from repro_torch.models.transformer import Model

TOL = 1e-5


def _t(tree):
    return trees.map_leaves(torch.from_numpy, tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in trees.flatten(tree).items()}


def _same(got, want, atol=0.0):
    got, want = _flat_np(got), {k: np.asarray(v) for k, v in jtrees.flatten(want).items()}
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=atol, rtol=0, err_msg=k)


# --------------------------------------------------------------- aggregation
@pytest.mark.parametrize("weights", [None, [0.5, 0.0, 2.0], [0.0, 0.0, 0.0]])
def test_list_aggregation_matches_jax_and_stacked(weights):
    """``partial_fedavg`` (weights; all-outage: every weight 0) and
    ``masked_fedavg`` (masks of every broadcast rank, trailing-aligned;
    all-outage: every mask 0, the global kept) against JAX's within 1e-7,
    and bit for bit the port's stacked forms on the stacked inputs."""
    rng = np.random.RandomState(2)
    clients = [_tree(rng) for _ in range(3)]
    glob = _tree(rng)
    pred = lambda p: p.startswith(("w", "stages"))  # noqa: E731
    tc, jc = [_t(c) for c in clients], [_j(c) for c in clients]
    got = aggregation.partial_fedavg(_t(glob), tc, pred, weights)
    _same(got, jagg.partial_fedavg(_j(glob), jc, pred, weights), atol=1e-7)
    _same(got, aggregation.partial_fedavg_stacked(_t(glob), trees.stack(tc), pred, weights))
    off = 0.0 if weights == [0.0, 0.0, 0.0] else 1.0
    masks = [{"w": (rng.rand(2) > 0.3).astype(np.float32) * off,       # trailing-aligned
              "stages": [{"layers": [{"a": np.float32(off), "b": None}]}],
              "head": (rng.rand(2) > 0.5).astype(np.float32) * off} for _ in range(3)]
    got = aggregation.masked_fedavg(_t(glob), tc, [trees.map_leaves(torch.as_tensor, m)
                                                   for m in masks])
    _same(got, jagg.masked_fedavg(_j(glob), jc, [_j(m) for m in masks]), atol=1e-7)
    bm = [trees.map_leaves(lambda m, t: torch.broadcast_to(torch.as_tensor(m), t.shape), m, t)
          for m, t in zip(masks, tc)]
    _same(got, aggregation.masked_fedavg_stacked(_t(glob), trees.stack(tc), trees.stack(bm)))
    if not off:
        _same(got, glob)
    _same(aggregation.fedavg(tc, weights), jagg.fedavg(jc, weights), atol=1e-7)


def test_stack_host_batches_matches_jax():
    """Uniform and ragged cohorts: the same stacked leaves, and the ragged
    one's ``valid`` mask."""
    rng = np.random.RandomState(0)
    for sizes in ((4, 4), (4, 3)):
        batches = [[{"tokens": rng.randint(0, 50, size=(b, 6)).astype(np.int32),
                     "label": rng.randint(0, 4, size=b).astype(np.int32)} for _ in range(2)]
                   for b in sizes]
        got = cohort.stack_host_batches(batches)
        want = jcohort.stack_host_batches(batches)
        assert got.keys() == want.keys() and ("valid" in got) == (sizes[0] != sizes[1])
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


# --------------------------------------------------------------- trees
def test_tree_helpers_match_jax():
    rng = np.random.RandomState(1)
    tree = _tree(rng)
    tree["i"] = np.arange(5, dtype=np.int32)
    pred = lambda p: "stages" in p  # noqa: E731
    assert trees.byte_size(_t(tree)) == jtrees.byte_size(_j(tree)) == trees.byte_size(tree)
    assert trees.count_params(_t(tree)) == jtrees.count_params(_j(tree))
    assert trees.mask_like(_t(tree), pred) == jax.tree_util.tree_map(
        float, jtrees.mask_like(_j(tree), pred))
    _same(trees.tree_scale(_t({k: v for k, v in tree.items() if k != "i"}), 0.25),
          jtrees.tree_scale(_j({k: v for k, v in tree.items() if k != "i"}), 0.25))


# --------------------------------------------------------------- peft
def test_peft_names_match_jax():
    jcfg = jget_config("gpt2-small").reduced(d_model=64, repeats=2, vocab=512)
    cfg = get_config("gpt2-small").reduced(d_model=64, repeats=2, vocab=512)
    key = jax.random.PRNGKey(0)
    pc_j = jpeft.PEFTConfig(lora_rank=4, lora_alpha=8.0, adapter_dim=8)
    pc = peft.PEFTConfig(lora_rank=4, lora_alpha=8.0, adapter_dim=8)
    jparams = jpeft.init_adapters(key, JModel(jcfg).init(key, max_seq=16), jcfg, pc_j)
    params = bridge.params_from_numpy(_np(jparams), cfg)
    flat_l = _factors(_np(jpeft.init_lora(key, jparams, pc_j)), 1)
    jlora = jtrees.map_with_path(lambda p, v: jnp.asarray(flat_l[p]),
                                 jpeft.init_lora(key, jparams, pc_j))
    lora = bridge.lora_from_numpy(flat_l, cfg)
    _same(peft.merge_lora(params, lora, pc), jpeft.merge_lora(jparams, jlora, pc_j), atol=1e-6)
    assert trees.flatten(peft.strip_adapters(params)).keys() == \
        jtrees.flatten(jpeft.strip_adapters(jparams)).keys()
    assert not any("/adapter/" in p for p in trees.flatten(peft.strip_adapters(params)))
    # has_factors / is_lora_leaf on the whole tree and on each layer's parts
    own = peft.init_lora(torch.Generator().manual_seed(0), params, pc)
    jl = jlora["stages"][0]["layers"][0]
    tl = own["stages"][0]["layers"][0]
    for part in ("mixer", "ff", "norm1"):
        assert peft.has_factors(tl.get(part)) == jpeft.has_factors(jl.get(part)), part
    assert peft.has_factors(own) and jpeft.has_factors(jlora)
    assert not peft.has_factors(trees.map_leaves(lambda x: None, own))
    for t, j in ((tl["mixer"]["wq"], jl["mixer"]["wq"]), (None, None),
                 (tl["mixer"]["wq"]["a"], jl["mixer"]["wq"]["a"]), ({"b": 1}, {"b": 1})):
        assert peft.is_lora_leaf(t) == jpeft.is_lora_leaf(j)
    assert all(peft.is_lora_path(p) == jpeft.is_lora_path(p) for p in ("mixer/wq/a", ""))
    # LoraProj: the factored projection (and the plain one without factors)
    w = params["stages"][0]["layers"][0]["mixer"]["wq"][0]
    jw = jparams["stages"][0]["layers"][0]["mixer"]["wq"][0]
    lf = {k: v[0] for k, v in lora["stages"][0]["layers"][0]["mixer"]["wq"].items()}
    jlf = {k: v[0] for k, v in jlora["stages"][0]["layers"][0]["mixer"]["wq"].items()}
    x = np.random.RandomState(4).randn(3, 5, 64).astype(np.float32)
    for a, b in ((lf, jlf), (None, None)):
        got = peft.LoraProj(w, a, 2.0)(torch.from_numpy(x))
        want = jpeft.LoraProj(jw, b, 2.0)(jnp.asarray(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# --------------------------------------------------------------- configs
def test_param_counts_match_jax():
    """Every registered config, full and reduced: the analytic counts and
    ``sub_quadratic`` exactly JAX's (and ``layer_param_count`` per kind)."""
    assert list_configs() == jlist_configs()
    for name in list_configs():
        for c, j in ((get_config(name), jget_config(name)),
                     (get_config(name).reduced(), jget_config(name).reduced())):
            assert c.param_count() == j.param_count(), name
            assert c.param_count(include_embed=False) == j.param_count(include_embed=False)
            assert c.active_param_count() == j.active_param_count(), name
            assert c.sub_quadratic == j.sub_quadratic, name
            for st, jst in zip(c.stages, j.stages):
                for k, jk in zip(st.pattern, jst.pattern):
                    for act in (False, True):
                        assert blocks.layer_param_count(c, k, active_only=act) == \
                            jblocks.layer_param_count(j, jk, active_only=act)


# --------------------------------------------------------------- merged LoRA
def _ledger(res):
    return [(r["bytes"], r["delay_s"]) for r in res["round_records"]]


@pytest.mark.parametrize("method", ["pftt", "fedlora"])
def test_pftt_merged_matches_jax(method):
    """The engine and the loop with ``factored=False`` against JAX's
    ``run_pftt(factored=False)``; merged against factored in the port."""
    kw = dict(PFTT_KW, method=method)
    want = jpftt.run_pftt(jpftt.PFTTConfig(factored=False, **kw))
    init = pftt_init(jpftt.PFTTConfig(**kw))
    merges = peft.dense_merge_count()
    factored = pftt.run_pftt(pftt.PFTTConfig(device="cpu", **kw), init=init)
    assert peft.dense_merge_count() == merges
    for engine in (True, False):
        got = pftt.run_pftt(pftt.PFTTConfig(factored=False, engine=engine, device="cpu", **kw),
                            init=init)
        assert _ledger(got) == _ledger(want)
        np.testing.assert_allclose(got["acc_per_round"], want["acc_per_round"], atol=1e-6)
        np.testing.assert_allclose(got["acc_per_round"], factored["acc_per_round"], atol=1e-6)
        np.testing.assert_allclose(got["loss_per_round"], factored["loss_per_round"], atol=TOL)
    assert peft.dense_merge_count() > merges


# --------------------------------------------------------------- step builders
def test_step_builders_merged_match_jax():
    """``make_peft_step(factored=False)`` (two steps) and
    ``make_fl_round_step(factored=False)`` (one round, 3 clients) against
    JAX's on a reduced RoBERTa with nonzero factors: losses and trainables
    within 1e-5; each merged step's loss within 1e-5 of the factored one."""
    n = 3
    jcfg = jget_config("roberta-base").reduced(d_model=32, repeats=2)
    cfg = get_config("roberta-base").reduced(d_model=32, repeats=2)
    key = jax.random.PRNGKey(0)
    pc_j = jpeft.PEFTConfig(lora_rank=4, adapter_dim=4, lora_targets=("mixer/wq", "mixer/wv"))
    pc = peft.PEFTConfig(lora_rank=4, adapter_dim=4, lora_targets=("mixer/wq", "mixer/wv"))
    jfull = jpeft.init_adapters(key, JModel(jcfg).init(key), jcfg, pc_j)
    flat_l = [_factors(_np(jpeft.init_lora(jax.random.fold_in(key, c), jfull, pc_j)), c)
              for c in range(n)]
    jloras = [jtrees.map_with_path(lambda p, v, c=c: jnp.asarray(flat_l[c][p]),
                                   jpeft.init_lora(jax.random.fold_in(key, c), jfull, pc_j))
              for c in range(n)]
    full = bridge.params_from_numpy(_np(jfull), cfg)
    loras = [bridge.lora_from_numpy(fl, cfg) for fl in flat_l]
    is_ad = jpeft.is_adapter_path
    model = Model(cfg, device="cpu")
    rng = np.random.RandomState(3)
    toks = rng.randint(6, 512, size=(n, 2, 12))
    batch = {"tokens": toks, "labels": np.roll(toks, 1, -1),
             "mask": (rng.rand(n, 2, 12) < 0.5).astype(np.float32)}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def check(got, want):
        got, want = trees.flatten(got), _np(want)
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v, atol=TOL, err_msg=k)

    # make_peft_step: client 0's LoRA, its batch
    jt = {"adapters": jtrees.select(jfull, is_ad), "lora": jloras[0]}
    b0, jb0 = {k: v[0] for k, v in tb.items()}, {k: v[0] for k, v in jb.items()}
    jstep, jopt = jsteps.make_peft_step(JModel(jcfg), pc_j, lr=1e-2, factored=False)
    jstep = jax.jit(jstep)
    out = {}
    for fac in (False, True):
        tstep, topt = steps.make_peft_step(model, pc, lr=1e-2, factored=fac)
        tt = {"adapters": trees.select(full, peft.is_adapter_path), "lora": loras[0]}
        ts = topt.init(tt)
        out[fac] = []
        for _ in range(2):
            tt, ts, loss = tstep(tt, full, ts, b0)
            out[fac].append(float(loss))
        out[fac].append(tt)
    js = jopt.init(jt)
    for i in range(2):
        jt, js, jloss = jstep(jt, jfull, js, jb0)
        assert out[False][i] == pytest.approx(float(jloss), abs=TOL)
        assert out[False][i] == pytest.approx(out[True][i], abs=TOL)
    check(out[False][2], jt)

    # make_fl_round_step: the adapters shared, each client's LoRA its own
    jtrain = {"adapters": jtrees.select(jfull, is_ad), "lora": jtrees.stack(jloras)}
    jstep, jopt = jsteps.make_fl_round_step(JModel(jcfg), pc_j, n, factored=False)
    jnew, _, jloss = jax.jit(jstep)(jtrain, jfull, jopt.init(jtrain), jb)
    losses = {}
    for fac in (False, True):
        train_t = {"adapters": trees.select(full, peft.is_adapter_path),
                   "lora": trees.stack(loras)}
        step, opt = steps.make_fl_round_step(model, pc, n, factored=fac)
        new, _, loss = step(train_t, full, opt.init(train_t), tb)
        losses[fac] = float(loss)
        if not fac:
            check(new, jnew)
    assert losses[False] == pytest.approx(float(jloss), abs=TOL)
    assert losses[False] == pytest.approx(losses[True], abs=TOL)


# --------------------------------------------------------------- the none mixer
def test_none_mixer_matches_jax():
    """A ``none`` mixer (the layer is its ff; the JAX package's last layer
    kind the port refused) beside attention layers, 2 repeats, with LoRA on
    the attention projections: the LM loss within 1e-5 of JAX's, then a
    prefill and three decode steps' logits within 1e-4."""
    import dataclasses

    from repro.configs import LK as JLK
    from repro.configs import Stage as JStage
    from repro_torch.configs import LK, Stage
    jcfg = jget_config("gpt2-small").reduced(d_model=64, repeats=2, vocab=512)
    jcfg = dataclasses.replace(jcfg, stages=(JStage((JLK("attn", "mlp"), JLK("none", "mlp")), 2),))
    cfg = get_config("gpt2-small").reduced(d_model=64, repeats=2, vocab=512)
    cfg = dataclasses.replace(cfg, stages=(Stage((LK("attn", "mlp"), LK("none", "mlp")), 2),))
    key = jax.random.PRNGKey(0)
    jmodel, model = JModel(jcfg), Model(cfg, device="cpu")
    jparams = jmodel.init(key, max_seq=16)
    params = bridge.params_from_numpy(_np(jparams), cfg)
    pc_j, pc = jpeft.PEFTConfig(lora_rank=4), peft.PEFTConfig(lora_rank=4)
    flat_l = _factors(_np(jpeft.init_lora(key, jparams, pc_j)), 1)
    jlora = jtrees.map_with_path(lambda p, v: jnp.asarray(flat_l[p]),
                                 jpeft.init_lora(key, jparams, pc_j))
    lora = bridge.lora_from_numpy(flat_l, cfg)
    rng = np.random.RandomState(5)
    toks = rng.randint(6, 512, size=(2, 9))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": np.ones((2, 8), np.float32)}
    want = jmodel.lm_loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()}, lora=jlora,
                          lora_scale=2.0)
    got = model.lm_loss(params, {k: torch.from_numpy(v) for k, v in batch.items()},
                        lora=lora, lora_scale=2.0)
    np.testing.assert_allclose(float(got), float(want), atol=TOL)
    jlg, jcache = jmodel.prefill(jparams, jnp.asarray(toks[:, :5]), cache_len=8)
    lg, cache = model.prefill(params, torch.from_numpy(toks[:, :5]), 8)
    assert cache["stages"][0][1] == {}
    for t in range(3):
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4)
        nxt = toks[:, 5 + t:6 + t]
        jlg, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(nxt))
        lg, cache = model.decode_step(params, cache, torch.from_numpy(nxt).long())
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=1e-4)
