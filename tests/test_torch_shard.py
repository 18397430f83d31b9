"""The client-sharded cohort's parts against the JAX package, on the CPU,
under an in-process gloo group of one rank (``FileStore`` in the test's
temporary directory): ``client_shard_axes`` and the ghost-padding
arithmetic against ``repro.sharding``'s; the toy round of
``tests/test_cohort_shard.py`` sharded at world size 1 against the
unsharded round (bit for bit) and JAX's unsharded round (1e-6); the
all-outage gate; ghosts leaving the real clients bitwise unchanged; the
mesh variants of fedavg, masked fedavg (all outage included), factored
aggregation and the health scalars against the unsharded ones; and
``HostBatchStacker``'s rows of a sharded rank."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro import sharding as jsharding
from repro import trees as jtrees
from repro.core import aggregation as jagg
from repro.core import cohort as jcohort
from repro.optim import sgd as jsgd
from repro_torch import sharding, trees
from repro_torch.core import aggregation, cohort
from repro_torch.launch.mesh import client_mesh
from repro_torch.obs import HEALTH_KEYS, cohort_health
from repro_torch.optim import sgd


@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    """A one-rank gloo group's client mesh, destroyed after the module."""
    path = str(tmp_path_factory.mktemp("pg") / "store")
    dist.init_process_group("gloo", store=dist.FileStore(path, 1), rank=0, world_size=1)
    try:
        yield client_mesh()
    finally:
        dist.destroy_process_group()


def _flat(tree):
    return {k: np.asarray(v) for k, v in trees.flatten(tree).items()}


# --------------------------------------------------------------- layout
def test_client_shard_axes_match_jax():
    for names in (("data", "model"), ("pod", "data"), ("pod", "data", "model"), ("model",)):
        jm = jax.make_mesh((1,) * len(names), names)
        pm = sharding.ClientMesh(names, (1,) * len(names))
        assert sharding.client_shard_axes(pm) == jsharding.client_shard_axes(jm), names
        assert sharding.client_shard_axes(pm, ("data",)) == \
            jsharding.client_shard_axes(jm, ("data",))


def test_ghost_padding_matches_jax(mesh1):
    jm = jax.make_mesh((1, 1), ("pod", "data"))
    j4 = jsharding.CohortSharding(mesh=jm, axes=("pod", "data"), n_clients=3, total=4)
    p4 = sharding.CohortSharding(mesh=sharding.ClientMesh(("data",), (2,), rank=1),
                                 axes=("data",), n_clients=3, total=4)
    assert (p4.n_pad, p4.n_shards, p4.n_local) == (j4.n_pad, 2, 2)
    assert p4.pad([10, 11, 12]) == j4.pad([10, 11, 12]) == [10, 11, 12, 10]
    np.testing.assert_array_equal(p4.pad_weights([1.0, 0.5, 2.0]),
                                  j4.pad_weights([1.0, 0.5, 2.0]))
    np.testing.assert_array_equal(p4.pad_vec([0.0, 1.0, 0.0], 1.0),
                                  j4.pad_vec([0.0, 1.0, 0.0], 1.0))
    # rank 1 of 2 holds rows 2..3: client 2 and the ghost (a copy of client 0)
    assert p4.rows == slice(2, 4) and p4.local([10, 11, 12]) == [12, 10]
    np.testing.assert_array_equal(p4.take_vec([1.0, 0.5, 2.0]), [2.0, 0.0])
    st = {"w": torch.arange(6.0).reshape(3, 2)}
    np.testing.assert_array_equal(p4.take(st)["w"].numpy(), [[4.0, 5.0], [0.0, 1.0]])
    for n in (1, 3, 8):
        jcs = jsharding.cohort_sharding(jm, n)
        pcs = sharding.cohort_sharding(mesh1, n)
        assert (pcs.n_shards, pcs.total, pcs.n_pad) == (jcs.n_shards, jcs.total, jcs.n_pad)
        assert pcs.rows == slice(0, n) and pcs.axes == ("data",)


def test_mesh_checks_and_world1_collectives(mesh1):
    """A ClientMesh with an axis besides its client axes (a (data, model)
    mesh comes as a MeshCtx) and a mesh larger than its group raise; at
    world size 1 the collectives return their input."""
    with pytest.raises(ValueError, match="MeshCtx"):
        sharding.mesh_axes(sharding.ClientMesh(("data", "model"), (1, 2)))
    with pytest.raises(ValueError, match="ranks"):
        sharding.mesh_axes(sharding.ClientMesh(("data",), (2,)))
    x = torch.randn(3, 4, generator=torch.Generator().manual_seed(0))
    assert torch.equal(sharding.psum(x, mesh1), x)
    assert torch.equal(sharding.pmax(x, mesh1), x)
    assert torch.equal(sharding.gather_clients(x, mesh1), x)
    tree = {"a": x, "b": [x[:, 0], None], "c": torch.ones(3, dtype=torch.int64)}
    got = sharding.gather_tree(tree, mesh1)
    assert got["b"][1] is None and got["c"].dtype == torch.int64
    for k, v in trees.flatten(tree).items():
        assert torch.equal(trees.flatten(got)[k], v), k
    summed = sharding.psum_tree({"a": x, "b": [x[0], None]}, mesh1)
    assert torch.equal(summed["a"], x) and summed["b"][1] is None


# --------------------------------------------------------------- toy round
def _toy_round(mesh=None, n_clients=2, jax_side=False):
    """``tests/test_cohort_shard.py``'s toy round in either package."""
    if jax_side:
        opt = jsgd(0.25)

        def local_step(tr, op, batch):
            loss, g = jax.value_and_grad(
                lambda t: jnp.sum((t["shared"]["w"] - batch["tgt"]) ** 2)
                + jnp.sum((t["local"]["v"] - batch["tgt"]) ** 2))(tr)
            upd, op = opt.update(g, op, tr)
            return jtrees.tree_add(tr, upd), op, loss

        tr = {"shared": {"w": jnp.zeros(2)}, "local": {"v": jnp.zeros(2)}}
        step = jcohort.build_supervised_round(local_step, lambda p: p.startswith("shared"),
                                              donate=False)
        return step, jtrees.stack([tr] * n_clients), jtrees.stack([opt.init(tr)] * n_clients)
    opt = sgd(0.25)

    def local_step(tr, op, batch):
        t = trees.map_leaves(lambda x: x.detach().requires_grad_(), tr)
        loss = ((t["shared"]["w"] - batch["tgt"]) ** 2).sum() \
            + ((t["local"]["v"] - batch["tgt"]) ** 2).sum()
        gw, gv = torch.autograd.grad(loss, [t["shared"]["w"], t["local"]["v"]])
        upd, op = opt.update({"shared": {"w": gw}, "local": {"v": gv}}, op, tr)
        return trees.tree_add(tr, upd), op, loss.detach()

    tr = {"shared": {"w": torch.zeros(2)}, "local": {"v": torch.zeros(2)}}
    step = cohort.build_supervised_round(
        local_step, lambda p: p.startswith("shared"),
        cs=None if mesh is None else sharding.cohort_sharding(mesh, n_clients))
    return step, trees.stack([tr] * n_clients), trees.stack([opt.init(tr)] * n_clients)


def _tgts(n):
    return np.stack([np.full((3, 2), 1.0 + 2.0 * ci, np.float32) for ci in range(n)])


def test_sharded_toy_round_world1_matches_unsharded(mesh1):
    """World size 1: the sharded round is the unsharded one bit for bit,
    and JAX's unsharded round to 1e-6 (client 1 in outage)."""
    tg = _tgts(2)
    w = np.asarray([1.0, 0.0], np.float32)
    outs = []
    for mesh in (None, mesh1):
        step, st_tr, st_op = _toy_round(mesh)
        outs.append(step(st_tr, st_op, {"tgt": torch.from_numpy(tg)}, torch.from_numpy(w)))
    jstep, jtr, jop = _toy_round(jax_side=True)
    want = jstep(jtr, jop, {"tgt": jnp.asarray(tg)}, jnp.asarray(w))
    for a, b, j in zip(outs[0], outs[1], want):
        fa, fb = _flat(a) if isinstance(a, dict) else {"": a.numpy()}, \
            _flat(b) if isinstance(b, dict) else {"": b.numpy()}
        fj = {k: np.asarray(v) for k, v in jtrees.flatten(j).items()} \
            if isinstance(j, dict) else {"": np.asarray(j)}
        assert fa.keys() == fb.keys() == fj.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
            np.testing.assert_allclose(fa[k], fj[k], atol=1e-6, err_msg=k)


def test_sharded_round_all_outage_keeps_local(mesh1):
    step, st_tr, st_op = _toy_round(mesh1)
    out, _, _ = step(st_tr, st_op, {"tgt": torch.from_numpy(_tgts(2))}, torch.zeros(2))
    w = out["shared"]["w"].numpy()
    assert not np.allclose(w[0], w[1])     # the gate: no aggregate, no broadcast


@pytest.mark.parametrize("sharded", [False, True])
def test_ghost_clients_do_not_change_real_clients(mesh1, sharded):
    """Zero-weight ghosts (copies of client 0) leave the real clients'
    outputs bitwise unchanged, unsharded and under the mesh."""
    mesh = mesh1 if sharded else None
    step2, tr2, op2 = _toy_round(mesh, 2)
    step4, _, _ = _toy_round(mesh, 4)
    pad = lambda t: trees.map_leaves(lambda x: torch.cat([x, x[:1], x[:1]]), t)  # noqa: E731
    b2 = {"tgt": torch.from_numpy(_tgts(2))}
    ref, _, losses2 = step2(trees.map_leaves(torch.clone, tr2), trees.map_leaves(torch.clone, op2),
                            b2, torch.ones(2))
    got, _, losses4 = step4(pad(tr2), pad(op2), pad(b2), torch.tensor([1.0, 1.0, 0.0, 0.0]))
    for k, r in _flat(ref).items():
        np.testing.assert_array_equal(r, _flat(got)[k][:2], err_msg=k)
    np.testing.assert_array_equal(losses2.numpy(), losses4.numpy()[:2])


# --------------------------------------------------------------- operators
def _stacked(rng, n=5):
    return ({"w": rng.randn(3, 4).astype(np.float32)},
            {"w": rng.randn(n, 3, 4).astype(np.float32)},
            {"w": rng.randint(0, 2, (n, 3, 4)).astype(np.float32)})


@pytest.mark.parametrize("weights", [[1.0, 0.5, 0.0, 2.0, 1.0], [0.0] * 5])
def test_masked_fedavg_mesh_matches_plain(mesh1, weights):
    """Under the mesh the masked aggregation is the plain operator bit for
    bit at world size 1, and JAX's to 1e-6, all outage (den 0 everywhere,
    the global kept) included."""
    g, st, ms = _stacked(np.random.RandomState(0))
    t = lambda tr: trees.map_leaves(torch.from_numpy, tr)  # noqa: E731
    w = torch.tensor(weights)
    plain = aggregation.masked_fedavg_stacked(t(g), t(st), t(ms), w)
    meshed = aggregation.masked_fedavg_stacked(t(g), t(st), t(ms), w, mesh=mesh1)
    want = jagg.masked_fedavg_stacked(
        {"w": jnp.asarray(g["w"])}, {"w": jnp.asarray(st["w"])}, {"w": jnp.asarray(ms["w"])},
        jnp.asarray(weights))
    np.testing.assert_array_equal(plain["w"].numpy(), meshed["w"].numpy())
    np.testing.assert_allclose(meshed["w"].numpy(), np.asarray(want["w"]), atol=1e-6)
    if sum(weights) == 0:
        np.testing.assert_array_equal(meshed["w"].numpy(), g["w"])


def test_fedavg_factored_and_health_mesh_match_plain(mesh1):
    """fedavg, the factored re-projection and the health scalars under the
    mesh against the unsharded ones at world size 1; health with a ghost
    row equals health over the real rows."""
    rng = np.random.RandomState(1)
    up = {"lora": {"a": torch.from_numpy(rng.randn(4, 6, 2).astype(np.float32)),
                   "b": torch.from_numpy(rng.randn(4, 2, 5).astype(np.float32))},
          "head": torch.from_numpy(rng.randn(4, 3).astype(np.float32))}
    w = torch.tensor([1.0, 0.0, 2.0, 0.5])
    for fn in (aggregation.fedavg_stacked, aggregation.factored_fedavg_stacked):
        a, b = fn(up, w), fn(up, w, mesh=mesh1)
        for k, v in _flat(a).items():
            np.testing.assert_array_equal(v, _flat(b)[k], err_msg=(fn.__name__, k))
    want = jagg.fedavg_stacked(jax.tree_util.tree_map(lambda x: jnp.asarray(x.numpy()), up),
                               jnp.asarray(w.numpy()))
    for k, v in jtrees.flatten(want).items():
        np.testing.assert_allclose(_flat(aggregation.fedavg_stacked(up, w, mesh=mesh1))[k],
                                   np.asarray(v), atol=1e-6)
    ref = trees.map_leaves(lambda x: x * 0.5, up)
    losses = torch.from_numpy(rng.rand(4, 3).astype(np.float32))
    gate = torch.tensor(True)
    plain = cohort_health(up, ref, losses, w, gate)
    meshed = cohort_health(up, ref, losses, w, gate, mesh=mesh1)
    for k in HEALTH_KEYS:
        assert float(meshed[k]) == pytest.approx(float(plain[k]), rel=1e-6, abs=1e-7), k
    # a ghost row (a copy of row 0 at weight 0) leaves the scalars unchanged
    pad = lambda t: trees.map_leaves(lambda x: torch.cat([x, x[:1]]), t)  # noqa: E731
    ghosted = cohort_health(pad(up), pad(ref), torch.cat([losses, losses[:1]]),
                            torch.cat([w, torch.zeros(1)]), gate, mesh=mesh1,
                            ghost=torch.tensor([False] * 4 + [True]))
    for k in HEALTH_KEYS:
        assert float(ghosted[k]) == pytest.approx(float(plain[k]), rel=1e-6, abs=1e-7), k


def test_stacker_rows_are_the_unsharded_rows():
    """A rank's ``HostBatchStacker(rows=)`` stacks its rows of the whole
    cohort's layout: ragged shapes and ``valid`` decided cohort-wide."""
    rng = np.random.RandomState(2)
    batches = [[{"x": rng.randn(b, 3).astype(np.float32)} for _ in range(2)]
               for b in (4, 4, 3, 4)]
    whole = cohort.HostBatchStacker()(batches)
    for rows in (slice(0, 2), slice(2, 4)):
        part = cohort.HostBatchStacker(rows=rows)(batches)
        assert part.keys() == whole.keys() == {"x", "valid"}
        for k in part:
            assert torch.equal(part[k], whole[k][rows]), k
