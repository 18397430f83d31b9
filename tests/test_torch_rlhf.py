"""The port's RLHF path against the JAX package, in f32 on the CPU: PFIT's
gradient masks and masked upload bytes, ``tree_l2``, rollouts with the JAX
package's own Gumbel noise injected (with and without an unmerged LoRA),
PPO's ``seq_logprobs_values``, ``gae``, ``prep`` and one masked ``step``,
the reward model's score and Bradley–Terry steps, the double reward, and
one ``build_ppo_round`` against the JAX engine.  Inputs come from numpy
seeds; weights are exported from the JAX package through ``bridge``.
Tolerances: 1e-5 on activations and parameters (``tests/test_torch_fl.py``'s),
1e-6 on the double reward, exact on masks, tokens, bytes and on every
parameter a mask holds out of training."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro import trees as jtrees
from repro.configs import get_config as jget_config
from repro.core import cohort as jcohort
from repro.core import rewards as jrewards
from repro.models import Model as JModel
from repro.models import peft as jpeft
from repro.optim import adamw as jadamw
from repro.optim import sgd as jsgd
from repro.rlhf import ppo as jppo
from repro.rlhf import reward_model as jrm
from repro.rlhf import rollout as jrollout
from repro.wireless import cost as jcost
from repro_torch import bridge, trees
from repro_torch.configs import get_config
from repro_torch.core import cohort, rewards
from repro_torch.models import peft
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw, sgd
from repro_torch.rlhf import ppo, reward_model, rollout
from repro_torch.sharding import ClientMesh, cohort_sharding
from repro_torch.wireless import cost

TOL = 1e-5
D, LAYERS, PROMPT, GEN, B = 48, 2, 6, 8, 4
PPO_CFG = jppo.PPOConfig()


def _np(tree):
    return {k: np.asarray(v) for k, v in jtrees.flatten(tree).items()}


def _assert_flat(got, want, atol=TOL):
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v), atol=atol, err_msg=k)


def jax_noise(key, gen_len, batch, vocab):
    """The Gumbel draws of ``jax.random.categorical`` inside the JAX
    package's ``generate``, step by step, as a port noise hook."""
    keys = jax.random.split(key, gen_len)
    draws = [torch.tensor(np.asarray(jax.random.gumbel(keys[t], (batch, vocab),
                                                       jnp.float32)))
             for t in range(gen_len)]
    return lambda step: draws[step]


@pytest.fixture(scope="module")
def policy():
    """The reduced GPT-2 policy (d 48, 2 layers, 4 heads of 12) from a JAX
    init with a nonzero value head, a nonzero-B LoRA, prompts and a
    rollout, as numpy."""
    jcfg = jget_config("gpt2-small").reduced(d_model=D, repeats=LAYERS)
    key = jax.random.PRNGKey(0)
    rng = np.random.RandomState(0)
    jp = JModel(jcfg).init(key)
    params = _np(jp)
    params["value_head"] = (rng.randn(D, 1) * 0.1).astype(np.float32)
    pc = jpeft.PEFTConfig(lora_rank=4, lora_targets=("mixer/wq", "mixer/wv"))
    lora = {k: (rng.randn(*v.shape) * 0.1).astype(np.float32) if k.endswith("/b") else v
            for k, v in _np(jpeft.init_lora(jax.random.PRNGKey(1), jp, pc)).items()}
    prompts = rng.randint(6, 512, size=(B, PROMPT)).astype(np.int32)
    tokens = rng.randint(6, 512, size=(B, PROMPT + GEN)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=get_config("gpt2-small").reduced(d_model=D, repeats=LAYERS),
                params=params, lora=lora, pc=pc, prompts=prompts, tokens=tokens, rng=rng)


def _jparams(flat):
    """A flat numpy tree as the JAX package's nested params (stages and
    layers as lists, as ``Model.init`` builds them)."""
    tree = {}
    for path, v in flat.items():
        node = tree
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)

    def listify(t):
        if isinstance(t, dict) and t and all(k.isdigit() for k in t):
            return [listify(t[str(i)]) for i in range(len(t))]
        return {k: listify(v) for k, v in t.items()} if isinstance(t, dict) else t

    return listify(tree)


def _port(policy):
    model = Model(policy["cfg"], device="cpu")
    return model, bridge.params_from_numpy(policy["params"], policy["cfg"])


# --------------------------------------------------------------- masks, bytes, l2
@pytest.mark.parametrize("sparsity", [0.4, 0.2, 0.0])
def test_masks_match_jax(policy, sparsity):
    """``last_k_layers_mask`` and ``head_sparsity_mask`` (from JAX's kept
    heads) equal JAX's exactly, leaf for leaf and shape for shape; the
    product masks the gradient as ``apply_grad_mask`` does in JAX; the
    masked upload bytes equal ``repro.wireless.cost.tree_bytes``'s."""
    jcfg, cfg = policy["jcfg"], policy["cfg"]
    jp = _jparams(policy["params"])
    _, params = _port(policy)
    for seed in (0, 3):
        h = cfg.n_heads
        n_keep = max(1, int(round(h * (1.0 - sparsity))))
        keep = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), h)[:n_keep])
        jm = jax.tree_util.tree_map(lambda a, b: a * b, jpeft.last_k_layers_mask(jp, jcfg, 1),
                                    jpeft.head_sparsity_mask(jp, jcfg, sparsity, seed=seed))
        m = trees.map_leaves(lambda a, b: a * b, peft.last_k_layers_mask(params, cfg, 1),
                             peft.head_sparsity_mask(params, cfg, sparsity, seed, keep=keep))
        got, want = bridge.to_numpy(m), _np(jm)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        grads = {k: policy["rng"].randn(*v.shape).astype(np.float32)
                 for k, v in policy["params"].items()}
        jg = jpeft.apply_grad_mask(_jparams(grads), jm)
        g = peft.apply_grad_mask(bridge.params_from_numpy(grads, cfg), m)
        _assert_flat(bridge.to_numpy(g), _np(jg), atol=0)
        assert cost.tree_bytes(params, nonzero_mask=m) == \
            jcost.tree_bytes(jp, nonzero_mask=jm)
    with pytest.raises(ValueError, match="nonzero_mask"):
        cost.tree_bytes(params, nonzero_mask=trees.select(m, lambda p: p != "embed"))


def test_port_head_draw_is_seeded_and_sized(policy):
    """Without ``keep`` the port draws its heads from a CPU generator per
    seed: the same seed the same mask, the kept count JAX's."""
    _, params = _port(policy)
    cfg = policy["cfg"]
    a = bridge.to_numpy(peft.head_sparsity_mask(params, cfg, 0.4, seed=5))
    b = bridge.to_numpy(peft.head_sparsity_mask(params, cfg, 0.4, seed=5))
    wq = "stages/0/layers/0/mixer/wq"
    np.testing.assert_array_equal(a[wq], b[wq])
    assert a[wq].sum() == round(cfg.n_heads * 0.6) * cfg.hd
    with pytest.raises(ValueError, match="kept heads"):
        peft.head_sparsity_mask(params, cfg, 0.4, seed=5, keep=[0])


def test_tree_l2_matches_jax(policy):
    rng = np.random.RandomState(7)
    other = {k: v + rng.randn(*v.shape).astype(np.float32) * 0.01
             for k, v in policy["params"].items()}
    pred = lambda p: p.startswith("stages")  # noqa: E731
    cfg = policy["cfg"]
    got = trees.tree_l2(trees.select(bridge.params_from_numpy(policy["params"], cfg), pred),
                        trees.select(bridge.params_from_numpy(other, cfg), pred))
    want = jtrees.tree_l2(jtrees.select(_jparams(policy["params"]), pred),
                          jtrees.select(_jparams(other), pred))
    np.testing.assert_allclose(float(got), float(want), rtol=TOL)


# --------------------------------------------------------------- rollouts
@pytest.mark.parametrize("with_lora", [False, True])
def test_generate_matches_jax_with_its_noise(policy, with_lora):
    """``generate`` with JAX's Gumbel draws injected samples exactly JAX's
    tokens (temperature 0.8, as the evaluation), with the LoRA served
    unmerged or without one."""
    jmodel = JModel(policy["jcfg"])
    model, params = _port(policy)
    key = jax.random.PRNGKey(11)
    scale = jpeft.lora_scale(policy["pc"])
    jl = _jparams(policy["lora"]) if with_lora else None
    want = jrollout.generate(jmodel, _jparams(policy["params"]), jnp.asarray(policy["prompts"]),
                             GEN, key, temperature=0.8, lora=jl, lora_scale=scale)
    lora = bridge.lora_from_numpy(policy["lora"], policy["cfg"]) if with_lora else None
    margins = []
    got = rollout.generate(model, params, torch.from_numpy(policy["prompts"]), GEN,
                           jax_noise(key, GEN, B, policy["cfg"].vocab_size), temperature=0.8,
                           lora=lora, lora_scale=scale, margins=margins)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32 and len(margins) == GEN
    assert all(bool((m >= 0).all()) for m in margins)


def test_gumbel_stream_is_seeded():
    """One stream, one noise: the same (seed, stream) draws the same, other
    streams differ; the draws are standard Gumbel (mean ≈ Euler's γ)."""
    a = rollout.gumbel_stream(0, 5, 3, 4, 512, "cpu")
    b = rollout.gumbel_stream(0, 5, 3, 4, 512, "cpu")
    c = rollout.gumbel_stream(0, 6, 3, 4, 512, "cpu")
    assert torch.equal(a(2), b(2)) and not torch.equal(a(2), c(2))
    assert a(0).shape == (4, 512) and a(0).dtype == torch.float32
    big = rollout.gumbel_stream(1, 0, 1, 64, 512, "cpu")(0)
    assert abs(float(big.mean()) - 0.5772) < 0.02


# --------------------------------------------------------------- PPO
PFIT_LR = 4e-4     # PFITConfig.lr


@pytest.fixture(scope="module")
def ppo_ref(policy):
    """JAX's seq_logprobs_values, prep, and one masked step on the policy's
    rollout (reference = the policy with perturbed stages): with AdamW at
    PFIT's lr, and with SGD at lr 1, whose update is the masked gradient."""
    jmodel = JModel(policy["jcfg"])
    jp = _jparams(policy["params"])
    rng = np.random.RandomState(9)
    ref_flat = {k: v + (rng.randn(*v.shape).astype(np.float32) * 0.02
                        if k.startswith("stages") else 0)
                for k, v in policy["params"].items()}
    toks = jnp.asarray(policy["tokens"])
    reward = rng.randn(B).astype(np.float32)
    keep = np.asarray(jax.random.permutation(jax.random.PRNGKey(2), 4)[:2])
    jmask = jax.tree_util.tree_map(lambda a, b: a * b,
                                   jpeft.last_k_layers_mask(jp, policy["jcfg"], 1),
                                   jpeft.head_sparsity_mask(jp, policy["jcfg"], 0.5, seed=2))
    out = dict(slv=jppo.seq_logprobs_values(jmodel, jp, toks), ref_flat=ref_flat,
               reward=reward, keep=keep)
    for name, opt in (("adamw", jadamw(PFIT_LR)), ("sgd", jsgd(1.0))):
        prep, step = jppo.make_ppo_fns(jmodel, opt, PPO_CFG, PROMPT)
        prepped = prep(jp, _jparams(ref_flat), toks, jnp.asarray(reward))
        new_p, new_st, loss, aux = step(jp, opt.init(jp), toks, *prepped[:4], jmask)
        out[name] = dict(new_p=_np(new_p), new_st=_np(new_st),
                         loss=[float(loss)] + [float(a) for a in aux])
    out["prepped"] = prepped
    return out


def test_seq_logprobs_values_and_gae_match_jax(policy, ppo_ref):
    model, params = _port(policy)
    toks = torch.from_numpy(policy["tokens"])
    with torch.no_grad():
        got = ppo.seq_logprobs_values(model, params, toks)
    for g, w in zip(got, ppo_ref["slv"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)
    rng = np.random.RandomState(4)
    r, v = rng.randn(3, 9).astype(np.float32), rng.randn(3, 9).astype(np.float32)
    m = (np.arange(9)[None] >= 3).astype(np.float32).repeat(3, 0)
    for g, w in zip(ppo.gae(*map(torch.from_numpy, (r, v, m)), 1.0, 0.95),
                    jppo.gae(*map(jnp.asarray, (r, v, m)), 1.0, 0.95)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)


def test_prep_and_masked_step_match_jax(policy, ppo_ref):
    """``prep`` (old logp, normalized advantages with numpy's std, returns,
    response mask, mean KL) ≤ 1e-5.  One masked step: with SGD at lr 1 (the
    update is the masked gradient) parameters and loss parts ≤ 1e-5; with
    AdamW at PFIT's lr the optimizer state, loss and parameters ≤ 1e-5,
    except where AdamW's first step cannot carry the gradient's own
    difference within that: it moves an element by lr·g/(|g| + eps), of
    slope lr·eps/(|g| + eps)², so where JAX's |g| is under K = 1 +
    lr/(4·1e-5) times the port-vs-JAX gradient difference (a near-cancelled
    sum) the element is held to AdamW's most, 2·lr.  Every parameter the
    mask holds out stays bit-equal to its value before the step."""
    model, params = _port(policy)
    cfg = policy["cfg"]
    ref = bridge.params_from_numpy(ppo_ref["ref_flat"], cfg)
    toks = torch.from_numpy(policy["tokens"])
    mask = trees.map_leaves(lambda a, b: a * b, peft.last_k_layers_mask(params, cfg, 1),
                            peft.head_sparsity_mask(params, cfg, 0.5, 2, keep=ppo_ref["keep"]))
    got = {}
    for name, opt in (("adamw", adamw(PFIT_LR)), ("sgd", sgd(1.0))):
        prep, step = ppo.make_ppo_fns(model, opt, ppo.PPOConfig(), PROMPT)
        prepped = prep(params, ref, toks, torch.from_numpy(ppo_ref["reward"]))
        new_p, new_st, loss, aux = step(params, opt.init(params), toks, *prepped[:4], mask)
        got[name] = dict(new_p=bridge.to_numpy(new_p), new_st=bridge.to_numpy(new_st),
                         loss=[float(loss)] + [float(a) for a in aux])
        np.testing.assert_allclose(got[name]["loss"], ppo_ref[name]["loss"], atol=TOL)
    for g, w in zip(prepped, ppo_ref["prepped"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL)
    _assert_flat(got["sgd"]["new_p"], ppo_ref["sgd"]["new_p"])
    _assert_flat(got["adamw"]["new_st"], ppo_ref["adamw"]["new_st"])
    before, m = policy["params"], bridge.to_numpy(mask)
    gain = 1 + PFIT_LR / (4 * TOL)
    n_open = 0
    for k, v in before.items():   # AdamW's first moment after one step is 0.1·g
        g_jax = ppo_ref["adamw"]["new_st"]["mu/" + k] / 0.1
        g_port = got["adamw"]["new_st"]["mu/" + k] / 0.1
        open_ = np.abs(g_jax) < gain * np.abs(g_port - g_jax)
        d = np.abs(got["adamw"]["new_p"][k] - ppo_ref["adamw"]["new_p"][k])
        assert d[~open_].max(initial=0) <= TOL, k
        assert d[open_].max(initial=0) <= 2 * PFIT_LR, k
        n_open += int(open_.sum())
        off = np.broadcast_to(m[k], v.shape) == 0
        np.testing.assert_array_equal(got["adamw"]["new_p"][k][off], v[off], err_msg=k)
    assert n_open < 10
    assert any(not np.array_equal(got["adamw"]["new_p"][k], before[k]) for k in before)


def test_ppo_round_wrapper_matches_jax(policy, ppo_ref):
    """``ppo_round`` (a ``PPOTrainer`` per call: prep, then two masked
    epochs) against the JAX package's, under SGD (lr 0.1, so the second
    epoch's forward sees moved parameters): parameters and the round's
    stats ≤ 1e-5."""
    jp = _jparams(policy["params"])
    jmask = jax.tree_util.tree_map(lambda a, b: a * b,
                                   jpeft.last_k_layers_mask(jp, policy["jcfg"], 1),
                                   jpeft.head_sparsity_mask(jp, policy["jcfg"], 0.5, seed=2))
    jopt = jsgd(0.1)
    want_p, _, want = jppo.ppo_round(JModel(policy["jcfg"]), jp, _jparams(ppo_ref["ref_flat"]),
                                     jopt, jopt.init(jp), jnp.asarray(policy["tokens"]),
                                     PROMPT, jnp.asarray(ppo_ref["reward"]), PPO_CFG, jmask)
    model, params = _port(policy)
    cfg = policy["cfg"]
    mask = trees.map_leaves(lambda a, b: a * b, peft.last_k_layers_mask(params, cfg, 1),
                            peft.head_sparsity_mask(params, cfg, 0.5, 2, keep=ppo_ref["keep"]))
    opt = sgd(0.1)
    got_p, _, got = ppo.ppo_round(model, params,
                                  bridge.params_from_numpy(ppo_ref["ref_flat"], cfg), opt,
                                  opt.init(params), torch.from_numpy(policy["tokens"]), PROMPT,
                                  torch.from_numpy(ppo_ref["reward"]), ppo.PPOConfig(), mask)
    _assert_flat(bridge.to_numpy(got_p), _np(want_p))
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], atol=TOL)


# --------------------------------------------------------------- reward models
@pytest.fixture(scope="module")
def reward_setup():
    """Two JAX reward models (d 32, 1 layer) and an instruction-corpus
    sample with ground-truth scores."""
    from repro.data.synthetic import InstructionCorpus
    samples = InstructionCorpus(seq_len=14, prompt_len=6, seed=0).sample(
        64, helpful_p=0.5, unsafe_p=0.4, rng=np.random.RandomState(3))
    rms = [jrm.RewardModel.create(jax.random.PRNGKey(s), d_model=32, n_layers=1)
           for s in (11, 12)]
    return samples, rms


def _port_rm(jrm_model):
    cfg = reward_model.reward_model_config(32, 1)
    rm = reward_model.RewardModel(Model(cfg, device="cpu"),
                                  bridge.params_from_numpy(_np(jrm_model.params), cfg))
    return rm


def test_reward_model_score_and_bt_steps_match_jax(reward_setup):
    """``RewardModel.score`` and 3 Bradley–Terry steps (pairs from the
    same numpy draws): parameters ≤ 1e-5, the last BT loss ≤ 1e-5, the pair
    accuracy equal."""
    samples, (jh, _) = reward_setup
    rm = _port_rm(jh)
    toks, mask = samples["tokens"][:8], samples["mask"][:8]
    got = rm.score(rm.params, torch.from_numpy(toks), torch.from_numpy(mask))
    want = jh.score(jh.params, jnp.asarray(toks), jnp.asarray(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=TOL)
    jparams, jstats = jrm.train_reward_model(jax.random.PRNGKey(0), jh, samples, "help",
                                             steps=3, batch=8)
    params, stats = reward_model.train_reward_model(rm, samples, "help", steps=3, batch=8)
    _assert_flat(bridge.to_numpy(params), _np(jparams))
    np.testing.assert_allclose(stats["bt_loss"], jstats["bt_loss"], atol=TOL)
    assert stats["pair_acc"] == jstats["pair_acc"]
    cfg = reward_model.reward_model_config()
    assert (cfg.d_model, cfg.n_heads, cfg.hd, cfg.n_layers, cfg.vocab_size, cfg.norm,
            cfg.act, cfg.pos, cfg.tie_embeddings) == (128, 4, 32, 2, 512, "ln", "gelu",
                                                      "learned", True)


def test_double_reward_matches_jax(reward_setup, policy):
    """``DoubleReward.quality`` and ``.personalized`` (the λ·L2 pull over
    a parameter pair) ≤ 1e-6."""
    samples, (jh, js) = reward_setup
    rh, rs = _port_rm(jh), _port_rm(js)
    jd = jrewards.DoubleReward(jh, jh.params, js, js.params)
    d = rewards.DoubleReward(rh, rh.params, rs, rs.params)
    toks, mask = samples["tokens"][:8], samples["mask"][:8]
    rng = np.random.RandomState(5)
    local = {k: v + rng.randn(*v.shape).astype(np.float32) * 0.01
             for k, v in policy["params"].items() if k.startswith("stages")}
    glob = {k: v for k, v in policy["params"].items() if k.startswith("stages")}
    for pref in (jrewards.ClientPreference(0.3, 0.7, 1e-3), jrewards.ClientPreference(1.0, 0.0, 0.0)):
        tp = rewards.ClientPreference(pref.alpha_help, pref.alpha_safe, pref.lambda_reg)
        want = jd.personalized(jnp.asarray(toks), jnp.asarray(mask), pref,
                               _jparams(local), _jparams(glob))
        with torch.no_grad():
            got = d.personalized(torch.from_numpy(toks), torch.from_numpy(mask), tp,
                                 trees.unflatten({k: torch.tensor(v) for k, v in local.items()}),
                                 trees.unflatten({k: torch.tensor(v) for k, v in glob.items()}))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# --------------------------------------------------------------- one PPO round
@pytest.mark.parametrize("weights", [[1.0, 1.0], [0.0, 0.0]])
def test_ppo_round_matches_jax_engine(policy, reward_setup, weights):
    """One ``build_ppo_round`` (rollout with JAX's noise, double reward minus
    the λ·L2 pull, prep, two masked epochs, masked aggregation, masked
    broadcast; all outage keeps every client's local values) from identical
    stacked state against the JAX engine: ≤ 1e-5."""
    samples, (jh, js) = reward_setup
    jcfg, cfg = policy["jcfg"], policy["cfg"]
    jmodel, jp = JModel(jcfg), _jparams(policy["params"])
    jopt = jadamw(4e-4)
    keeps = [np.asarray(jax.random.permutation(jax.random.PRNGKey(s), 4)[:2]) for s in (0, 1)]
    jmasks = [jax.tree_util.tree_map(lambda a, b: a * b,
                                     jpeft.last_k_layers_mask(jp, jcfg, 1),
                                     jpeft.head_sparsity_mask(jp, jcfg, 0.5, seed=s))
              for s in (0, 1)]

    def jquality(toks, mask, ah, asafe):
        return ah * jh.score(jh.params, toks, mask) + asafe * js.score(js.params, toks, mask)

    prompts = np.stack([policy["prompts"], policy["prompts"][::-1]])
    keys = [jax.random.fold_in(jax.random.PRNGKey(0), 17 + ci) for ci in range(2)]
    ah, asafe = [0.25, 0.75], [0.75, 0.25]
    jround = jcohort.build_ppo_round(jmodel, jopt, PPO_CFG, PROMPT, GEN, jquality,
                                     lambda_regs=[1e-3, 1e-3], donate=False)
    jout = jround(jtrees.stack([jp, jp]), jtrees.stack([jopt.init(jp)] * 2), jp,
                  jtrees.stack(jmasks), jnp.asarray(prompts), jnp.stack(keys),
                  jnp.asarray(ah), jnp.asarray(asafe), jnp.asarray(weights, jnp.float32))

    model, params = _port(policy)
    rh, rs = _port_rm(jh), _port_rm(js)
    d = rewards.DoubleReward(rh, rh.params, rs, rs.params)
    opt = adamw(4e-4)
    masks = [trees.map_leaves(lambda a, b: a * b, peft.last_k_layers_mask(params, cfg, 1),
                              peft.head_sparsity_mask(params, cfg, 0.5, s, keep=k))
             for s, k in zip((0, 1), keeps)]
    rnd = cohort.build_ppo_round(
        model, opt, ppo.PPOConfig(), PROMPT, GEN,
        lambda t, m, a, s: d.quality(t, m, rewards.ClientPreference(a, s)),
        lambda_regs=[1e-3, 1e-3])
    rollouts = []
    out = rnd(trees.stack([params, params]), trees.stack([opt.init(params)] * 2), params,
              trees.stack(masks), torch.from_numpy(prompts),
              [jax_noise(k, GEN, B, cfg.vocab_size) for k in keys], ah, asafe,
              torch.tensor(weights), rollouts=rollouts)
    for got, want in zip(out, jout):
        if isinstance(got, dict):
            _assert_flat(bridge.to_numpy(got), _np(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    assert [tuple(t.shape) for t, _ in rollouts] == [(B, PROMPT + GEN)] * 2
    st = bridge.to_numpy(out[0])
    wq = "stages/0/layers/0/mixer/wq"
    if sum(weights) > 0:   # the clients share the aggregate where both train
        both = np.broadcast_to(bridge.to_numpy(masks[0])[wq] * bridge.to_numpy(masks[1])[wq],
                               st[wq][0].shape) > 0
        np.testing.assert_array_equal(st[wq][0][both], st[wq][1][both])
    else:
        assert not np.array_equal(st[wq][0], st[wq][1])


def test_ppo_round_refuses_unported_options():
    """A sharded round over a mesh whose process group is not initialised
    raises (no fallback to world size 1), and so does anything but a
    ClientMesh."""
    mesh = ClientMesh(("data",), (2,))
    for kw, m, err, match in ((dict(codec=object()), mesh, RuntimeError, "not initialised"),
                              (dict(robust=True, codec=object()), mesh, RuntimeError,
                               "not initialised"),
                              (dict(min_quorum=1), mesh, RuntimeError, "not initialised"),
                              ({}, object(), TypeError, "ClientMesh")):
        with pytest.raises(err, match=match):
            cohort.build_ppo_round(None, None, ppo.PPOConfig(), 2, 2, None,
                                   cs=cohort_sharding(m, 2), **kw)
