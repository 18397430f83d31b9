"""Host-resident client population for sampled-cohort federated training,
the port of ``repro.fl.population``.

Each client's trainable state is a few-KB rank-r tree, so a population of
thousands fits in host memory; every round samples a small cohort into
the cohort engine's robust round body and writes the results back:

* ``PopulationStore`` — named slots ("trainable", "opt", "pending"), each a
  stacked numpy tree with a leading (n_clients,) axis.  ``gather`` copies
  the sampled rows into a staging buffer allocated once and refilled in
  place; ``scatter`` copies the round's device rows back (never keeping a
  view of a device or staging buffer).
* ``ClientSampler`` — seeded per-round cohort selection, ``uniform`` or
  ``availability`` (probability ∝ the scenario's per-round availability);
  one ``RandomState`` stream whose ``state_dict`` is JSON-safe.
* ``PopulationData`` — lazy non-IID client data: batches are a pure
  function of (seed, client id, round) over a class-bucketed pool.
* ``PopulationRunner`` — per round: sample → plan (the population-wide
  ``StalenessTracker``) → gather + global overlay → the robust round body
  → scatter → ledger.

``PopulationConfig``, ``PopulationStore``, ``ClientSampler`` and
``PopulationData`` are copies of the JAX module's; its test holds them
against the originals.  The host-to-device step is an explicit copy on
every device (``torch.from_numpy`` alone would share the staging buffer on
the CPU, and the round body writes its inputs in place).  The codec's
uniforms are keyed by client id, never by cohort row, so a client's stream
does not depend on which cohort it lands in.

Under a client mesh (``PopulationRunner(cs=...)``, a
``sharding.CohortSharding`` of the cohort) every rank holds the whole
store and makes every host draw; the gathered cohort is padded with ghost
rows (copies of the first sampled client, ``gather(pad_to=)``), each rank
moves only its rows to its device, and after the round the rows of every
rank are gathered back so that every rank scatters the same cohort into
its store.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import synchronize, trees
from repro_torch.core.robust import round_extra, round_reports
from repro_torch.obs.trace import SpanTracer
from repro_torch.sharding import cohort_sharding
from repro_torch.wireless.scenarios import Scenario

SAMPLER_KINDS = ("uniform", "availability")


def _writable(leaf) -> np.ndarray:
    """A host numpy array the store may mutate (a copy of a tensor, or of
    a read-only array)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    a = np.asarray(leaf)
    return a if a.flags.writeable else np.array(a)


@dataclasses.dataclass(frozen=True)
class PopulationConfig:
    """Population-mode knobs for ``run_pftt``/``run_pfit``.

    ``population`` clients live in the host store; every round samples a
    ``cohort_size`` cohort (the round body's client axis — the body itself
    is the program an ``n_clients=cohort_size`` run builds).  ``scenario``
    shapes the population (non-IID partitions, availability, mobility —
    ``wireless/scenarios.py``); ``sampler`` picks who participates."""
    population: int
    cohort_size: int
    sampler: str = "uniform"          # uniform | availability
    scenario: Optional[Scenario] = None
    seed: int = 0

    def __post_init__(self):
        if self.sampler not in SAMPLER_KINDS:
            raise ValueError(f"sampler must be one of {SAMPLER_KINDS}, "
                             f"got {self.sampler!r}")
        if not (0 < self.cohort_size <= self.population):
            raise ValueError(
                f"need 0 < cohort_size ({self.cohort_size}) <= "
                f"population ({self.population})")
        if (self.sampler == "availability"
                and not (self.scenario is not None
                         and self.scenario.has_availability())):
            raise ValueError("availability sampler needs a scenario with "
                             "avail != 'none'")


class PopulationStore:
    """Stacked host-numpy client state with buffered gather/scatter.

    Each slot is a tree whose leaves carry a leading (n_clients,) axis
    (``None`` leaves, as after ``trees.select``, stay ``None``).
    ``gather(slot, ids)`` refills the slot's preallocated staging buffer
    with rows ``ids`` and returns it; callers copy it to the device
    themselves.  ``scatter(slot, ids, tree)`` copies the tree's rows back
    into rows ``ids``."""

    def __init__(self, slots: Dict[str, object]):
        self._slots = {}
        self._bufs: Dict[str, object] = {}
        n = None
        for name, tree in slots.items():
            tree = trees.map_leaves(_writable, tree)
            for leaf in trees.flatten(tree).values():
                n = leaf.shape[0] if n is None else n
                assert leaf.shape[0] == n, \
                    f"slot {name!r} leading axis {leaf.shape[0]} != {n}"
            self._slots[name] = tree
        assert n is not None, "empty store"
        self._n = int(n)

    @property
    def n_clients(self) -> int:
        return self._n

    @property
    def slots(self) -> Dict[str, object]:
        return self._slots

    def nbytes(self) -> int:
        return sum(leaf.nbytes for tree in self._slots.values()
                   for leaf in trees.flatten(tree).values())

    def gather(self, slot: str, ids: np.ndarray, pad_to: int = 0):
        """Rows ``ids`` of ``slot`` → the slot's reused staging buffer
        (allocated on first use, refilled in place afterwards); rows beyond
        ``len(ids)``, up to ``pad_to``, repeat row ``ids[0]`` (the ghost
        rows of ``sharding.CohortSharding``)."""
        ids = np.asarray(ids, np.int64)
        rows = max(pad_to, len(ids))
        tree = self._slots[slot]
        buf = self._bufs.get(slot)
        if buf is None or next(iter(trees.flatten(buf).values())).shape[0] != rows:
            buf = trees.map_leaves(
                lambda l: np.empty((rows,) + l.shape[1:], l.dtype), tree)
            self._bufs[slot] = buf
        full = np.concatenate([ids, np.full(rows - len(ids), ids[0], np.int64)])

        def fill(src, dst):
            np.take(src, full, axis=0, out=dst)
            return dst

        return trees.map_leaves(fill, tree, buf)

    def scatter(self, slot: str, ids: np.ndarray, device_tree) -> None:
        """Copy the first ``len(ids)`` rows of ``device_tree`` (tensors or
        arrays) into rows ``ids`` of ``slot`` (ghost rows are dropped)."""
        ids = np.asarray(ids, np.int64)

        def put(dst, src):
            if isinstance(src, torch.Tensor):
                src = src.detach().cpu().numpy()
            dst[ids] = src[:len(ids)]     # an indexed assignment copies
            return dst

        trees.map_leaves(put, self._slots[slot], device_tree)

    def zero_rows(self, slot: str, ids: Sequence[int]) -> None:
        """Zero the given rows (deferred crash-rejoin optimizer reset for
        clients whose rejoin round fell outside a sampled cohort)."""
        ids = np.asarray(ids, np.int64)
        if len(ids) == 0:
            return
        trees.map_leaves(lambda l: l.__setitem__(ids, 0), self._slots[slot])

    def row(self, slot: str, i: int):
        return trees.map_leaves(lambda l: l[i], self._slots[slot])

    # ---- checkpointing -----------------------------------------------------

    def checkpoint_tree(self):
        """The whole store as one tree (slot-name-prefixed)."""
        return dict(self._slots)

    def load_checkpoint_tree(self, tree) -> None:
        for name in self._slots:
            self._slots[name] = trees.map_leaves(_writable, tree[name])


class ClientSampler:
    """Seeded per-round cohort sampling over the population.

    ``uniform``: every client equally likely, without replacement.
    ``availability``: probability ∝ the round's availability probabilities
    (``ScenarioTrace.avail_probs``) — the server preferentially samples
    reachable clients, so diurnal populations induce participation skew.

    One stateful ``RandomState`` drives the whole run: the cohort sequence
    is a single stream, so ``state_dict``/``load_state_dict`` (stored in
    the checkpoint) make a mid-stream resume reproduce the uninterrupted
    sequence exactly."""

    def __init__(self, kind: str, population: int, cohort_size: int,
                 seed: int = 0):
        if kind not in SAMPLER_KINDS:
            raise ValueError(f"unknown sampler kind {kind!r}")
        self.kind = kind
        self.population = population
        self.cohort_size = cohort_size
        self._rng = np.random.RandomState(seed)

    def sample(self, avail_probs: Optional[np.ndarray] = None) -> np.ndarray:
        """One round's cohort (sorted client ids, without replacement)."""
        if self.kind == "uniform" or avail_probs is None:
            ids = self._rng.choice(self.population, size=self.cohort_size,
                                   replace=False)
        else:
            p = np.asarray(avail_probs, np.float64)
            assert p.shape == (self.population,), p.shape
            p = np.maximum(p, 1e-12)
            ids = self._rng.choice(self.population, size=self.cohort_size,
                                   replace=False, p=p / p.sum())
        return np.sort(ids)

    # ---- checkpoint/resume -------------------------------------------------

    def state_dict(self) -> Dict:
        kind, keys, pos, has_gauss, cached = self._rng.get_state()
        return {"kind": self.kind, "rng": [kind, np.asarray(keys).tolist(),
                                          int(pos), int(has_gauss),
                                          float(cached)]}

    def load_state_dict(self, d: Dict) -> None:
        assert d["kind"] == self.kind, (d["kind"], self.kind)
        kind, keys, pos, has_gauss, cached = d["rng"]
        self._rng.set_state((kind, np.asarray(keys, np.uint32), int(pos),
                             int(has_gauss), float(cached)))


class PopulationData:
    """Lazy non-IID client data over a shared class-bucketed pool.

    The pool is one synthetic corpus; each client draws samples from its
    own label distribution (``class_probs[cid]``) by picking a class, then
    a pool index within that class.  Draws are pure functions of
    (seed, client id, round) — 10k clients need no per-client iterator
    state, and checkpoint resume needs no replay."""

    def __init__(self, pool: Dict[str, np.ndarray], class_probs: np.ndarray,
                 seed: int = 0, label_key: str = "label"):
        self.pool = {k: v for k, v in pool.items()
                     if isinstance(v, np.ndarray) and v.ndim >= 1
                     and len(v) == len(pool[label_key])}
        self.scalars = {k: v for k, v in pool.items()
                        if k not in self.pool}      # e.g. prompt_len
        self.class_probs = np.asarray(class_probs, np.float64)
        self.n_classes = self.class_probs.shape[1]
        self.seed = seed
        labels = pool[label_key]
        self.buckets = [np.where(labels == c)[0]
                        for c in range(self.n_classes)]
        for c, b in enumerate(self.buckets):
            assert len(b) > 0, f"pool has no samples of class {c}"

    def _rng(self, cid: int, tag: int) -> np.random.RandomState:
        # splitmix-style mix keeps client/round streams independent
        h = (self.seed * 0x9E3779B1 + cid * 0x85EBCA77 + tag * 0xC2B2AE3D
             ) & 0xFFFFFFFF
        return np.random.RandomState(h)

    def _draw(self, rng, cid: int, n: int) -> np.ndarray:
        cls = rng.choice(self.n_classes, size=n, p=self.class_probs[cid]
                         / self.class_probs[cid].sum())
        return np.asarray([self.buckets[c][rng.randint(len(self.buckets[c]))]
                           for c in cls], np.int64)

    def round_batches(self, cid: int, rnd: int, local_steps: int,
                      batch: int) -> List[Dict[str, np.ndarray]]:
        """The client's ``local_steps`` training batches for round
        ``rnd`` (deterministic in (seed, cid, rnd))."""
        rng = self._rng(cid, rnd)
        out = []
        for _ in range(local_steps):
            sel = self._draw(rng, cid, batch)
            b = {k: v[sel] for k, v in self.pool.items()}
            b.update(self.scalars)
            out.append(b)
        return out

    def test_set(self, cid: int, n: int) -> Dict[str, np.ndarray]:
        """The client's held-out eval draw (deterministic in (seed, cid);
        tag -1 keeps it off every round's training stream)."""
        rng = self._rng(cid, 0x7FFFFFFF)
        sel = self._draw(rng, cid, n)
        b = {k: v[sel] for k, v in self.pool.items()}
        b.update(self.scalars)
        return b


class CohortTestSets:
    """The sampled cohort's held-out draws for one cohort-eval call: each
    client's ``PopulationData.test_set`` (through ``prep``) is drawn once
    and kept by id (the cache empties past 4096 clients); the cohort's rows
    refill one host buffer per key, copied to the device each call."""

    def __init__(self, data: PopulationData, n_eval: int, keys: Sequence[str],
                 prep: Optional[Callable[[Dict], Dict]] = None):
        self.data, self.n_eval, self.keys = data, n_eval, tuple(keys)
        self.prep = prep or (lambda b: b)
        self.cache: Dict[int, Dict] = {}
        self.bufs: Optional[Dict[str, np.ndarray]] = None

    def __call__(self, ids, device) -> List[torch.Tensor]:
        if len(self.cache) > 4096:
            self.cache.clear()
        for j, cid in enumerate(ids):
            te = self.cache.get(int(cid))
            if te is None:
                te = self.cache[int(cid)] = self.prep(self.data.test_set(int(cid), self.n_eval))
            if self.bufs is None:
                self.bufs = {k: np.zeros((len(ids),) + te[k].shape, te[k].dtype)
                             for k in self.keys}
            for k in self.keys:
                self.bufs[k][j] = te[k]
        return [torch.from_numpy(self.bufs[k]).to(device, copy=True) for k in self.keys]


def stacked_client_init(init_fn: Callable[[int], object], n: int):
    """``init_fn(i)`` (a tree of tensors or numpy arrays: client i's
    draw, from its own generator or from JAX's exported init) for every
    client i < n, stacked into one host numpy tree with a leading (n,)
    axis."""
    rows = [trees.map_leaves(_writable, init_fn(i)) for i in range(n)]
    return trees.map_leaves(lambda *ls: np.stack(ls), *rows)


class PopulationRunner:
    """Per-round population orchestration around the robust round body.

    The round step (``core.cohort.build_supervised_round`` with
    ``robust=True``) is the one a ``cohort_size``-client run builds.
    Everything population-specific is host work this runner owns, in order
    each round:

    1. **sample** — ``ClientSampler`` draws the cohort (availability-
       weighted from the scenario trace when configured);
    2. **plan** — the ``StalenessTracker`` (sized to the POPULATION, so a
       straggler's pending payload survives rounds it isn't sampled in)
       resolves a population-wide ``RoundPlan`` from the fault trace ∧
       sampled mask ∧ realized availability;
    3. **gather** — the sampled rows of every store slot refill their
       staging buffers, the current ``global_shared`` tree is overlaid into
       the uploaded subtree (the downlink), one copy to the device per
       leaf;
    4. the **round step** runs on cohort-indexed slices of the plan (its
       span ends in a device synchronize);
    5. **scatter** — result rows are copied back; the new global is read
       off any cohort row whose merge gate passed (host-known from the
       plan).

    Crash-rejoins that land on unsampled rounds set a ``needs_opt_reset``
    flag; the reset is applied to the store the next time that client is
    gathered.  ``state_dict``/``checkpoint_tree`` capture the whole host
    state (sampler RNG mid-stream, tracker, flags, store, global) so a
    killed run resumes into the uninterrupted sequence.

    ``cs`` (a ``sharding.CohortSharding`` of the cohort; the round step
    built with the same mesh): the cohort is ghost-padded to ``cs.total``
    rows, this rank runs its rows, and the round's rows, bits and losses
    are gathered from every rank before the scatter (module docstring)."""

    def __init__(self, *, pop: PopulationConfig, store: PopulationStore,
                 global_shared, upload_pred, channel, budget, ledger,
                 tracker, trace, strace, sampler: ClientSampler, device,
                 arrivals=None, dl=None, cs=None, est_bits=None, act_bits: float = 0.0,
                 tracer=None, health: bool = False):
        self.pop = pop
        self.N = pop.population
        self.K = pop.cohort_size
        self.store = store
        self.global_shared = global_shared
        self.upload_pred = upload_pred
        self.channel = channel
        self.budget = budget
        self.ledger = ledger
        self.tracker = tracker
        self.trace = trace
        self.strace = strace
        self.sampler = sampler
        self.device = torch.device(device)
        self.arrivals = arrivals
        self.dl = dl
        # the cohort's layout (None: this process holds the whole cohort)
        self.cs = cs if cs is not None else cohort_sharding(None, self.K)
        self.n_rows = self.cs.total
        self.est_bits = None if est_bits is None else \
            np.asarray(est_bits, np.float64)
        self.act_bits = float(act_bits)
        self.needs_opt_reset = np.zeros(self.N, bool)
        # the tracer owns all host timing (a disabled tracer still times):
        # host_s is sample + gather + scatter, round_s the whole round
        self.tracer = tracer if tracer is not None else SpanTracer()
        self.health = health              # round_step returns a trailing
        #                                 # health dict (obs.health)
        self.host_s = 0.0
        self.round_s = 0.0
        self.round_wall = []              # per-round wall: [0] builds the
        #                                 # kernels, [1:] are steady state
        self.seen = np.zeros(self.N, bool)  # ever-sampled coverage

    # ---- helpers -----------------------------------------------------------

    def _put(self, tree):
        """Host tree → device tree, always a copy (never the staging
        buffer's storage)."""
        return trees.map_leaves(
            lambda a: torch.from_numpy(a).to(self.device, copy=True), tree)

    def _local(self, tree):
        """This rank's rows of a host tree of the padded cohort."""
        return trees.map_leaves(lambda a: np.ascontiguousarray(a[self.cs.rows]), tree)

    def _vec(self, v, fill: float):
        """A cohort vector → this rank's rows on the device, ghosts ``fill``."""
        return torch.from_numpy(self.cs.take_vec(v, fill)).to(self.device, copy=True)

    def _overlay_global(self, tr_buf) -> None:
        """Broadcast the server's global into the gathered rows' uploaded
        subtree, in place (numpy staging buffer)."""
        flat_g = trees.flatten(self.global_shared)

        def f(path, leaf):
            g = flat_g.get(path)
            if g is not None:
                leaf[:] = np.asarray(g)
            return leaf

        trees.map_with_path(f, tr_buf)

    def _snapshot_global(self, cid: int):
        row = self.store.row("trainable", cid)
        return trees.map_leaves(np.array, trees.select(row, self.upload_pred))

    # ---- the round ---------------------------------------------------------

    def run_round(self, rnd: int, *, round_step, stacker, draw_batches,
                  payload_bits: Optional[float] = None,
                  codec_noise=None) -> Dict:
        """One sampled-cohort round.  ``draw_batches(cid, rnd)`` returns the
        client's local-step host batches; ``payload_bits`` is the
        uncompressed fresh-upload size (ignored under a codec, where the
        round step reports realized encoded bits); ``codec_noise(round,
        client, leaf, shape)`` is the run's codec uniform stream (None: no
        codec), keyed by population client id."""
        tracer = self.tracer
        with tracer.span("round") as sp_round:
            with tracer.span("sample") as sp_sample:
                probs = self.strace.avail_probs(rnd) \
                    if self.sampler.kind == "availability" else None
                ids = self.sampler.sample(probs)
                self.seen[ids] = True

            with tracer.span("plan"):
                # population-wide plan: faults ∧ sampled ∧ realized
                # availability
                gains = (self.channel.realize(self.N)
                         * self.strace.gain_round(rnd))
                rf = self.trace.round(rnd)
                gains = gains * rf.gain_scale
                s = np.zeros(self.N, np.float32)
                s[ids] = 1.0
                avail = self.strace.avail_round(rnd)
                rf_pop = dataclasses.replace(
                    rf, train=rf.train * s * avail, tx=rf.tx * s * avail,
                    recv=rf.recv * s * avail, rejoin=rf.rejoin * s)
                # a crash-rejoin on an unsampled round resets the optimizer
                # the next time the client is gathered
                self.needs_opt_reset |= (rf.rejoin > 0) & (s == 0)
                rplan = self.tracker.begin_round(
                    rf_pop, self.channel.outage_weights(gains), gains=gains,
                    fresh_bits=self.est_bits)

            with tracer.span("gather") as sp_gather:
                reset = ids[self.needs_opt_reset[ids]]
                self.store.zero_rows("opt", reset)
                self.needs_opt_reset[ids] = False
                tr_h = self.store.gather("trainable", ids, pad_to=self.n_rows)
                self._overlay_global(tr_h)
                tr_d = self._put(self._local(tr_h))
                opt_d = self._put(self._local(self.store.gather("opt", ids, pad_to=self.n_rows)))
                pend_d = self._put(self._local(
                    self.store.gather("pending", ids, pad_to=self.n_rows)))

            # the batch draw rides inside the device-step window (it is not
            # host_s overhead, as in the JAX runner)
            hstats = None
            with tracer.span("device-step"):
                rows = [draw_batches(int(c), rnd) for c in ids]
                batches = stacker(rows + [rows[0]] * (self.n_rows - self.K))
                w = rplan.agg_w_pre if self.dl is not None else rplan.agg_w
                ontime = rplan.ontime if self.dl is not None \
                    else np.ones(self.N, np.float32)
                # ghosts train and receive, never rejoin, weigh 0
                margs = (self._vec(rplan.train[ids], 1.0), self._vec(w[ids], 0.0),
                         self._vec(rplan.recv[ids], 1.0), self._vec(rplan.rejoin[ids], 0.0),
                         self._vec(ontime[ids], 1.0))
                noise_arg = ()
                if codec_noise is not None:
                    with tracer.span("encode"):
                        noise_arg = ([lambda leaf, shape, c=int(c): codec_noise(rnd, c, leaf, shape)
                                      for c in self.cs.local(ids)],)
                outs = round_step(tr_d, opt_d, pend_d, batches, *margs, *noise_arg)
                tr_d, opt_d, pend_d, losses = outs[:4]
                if self.health:
                    hstats = outs[-1]
                synchronize(self.device)
            if codec_noise is None:
                fresh_c = np.full(self.K, (payload_bits or 0.0), np.float64)
            else:
                fresh_c = self.cs.gather(outs[4]).cpu().numpy().astype(np.float64) \
                    + self.act_bits

            with tracer.span("scatter") as sp_scatter:
                whole = self.cs.gather_tree({"trainable": tr_d, "opt": opt_d,
                                             "pending": pend_d, "losses": losses})
                for slot in ("trainable", "opt", "pending"):
                    self.store.scatter(slot, ids, whole[slot])
                # the merge gate is host-known: extract the new global from
                # any cohort row that received the broadcast
                gate = float(rplan.agg_w.sum()) > 0 and rplan.quorum_ok
                if gate:
                    recv_rows = np.where(rplan.recv[ids] > 0)[0]
                    if len(recv_rows):
                        self.global_shared = self._snapshot_global(
                            int(ids[recv_rows[0]]))

            with tracer.span("ledger"):
                fresh_n = np.zeros(self.N, np.float64)
                fresh_n[ids] = fresh_c
                charged = self.tracker.end_round(rplan, fresh_n)
                if self.dl is not None and codec_noise is not None:
                    # realized size → next round's estimate
                    self.est_bits = np.where(np.asarray(rplan.train) > 0, fresh_n,
                                             self.est_bits)
                reports = round_reports(self.budget, rplan, charged, gains)
                extra = round_extra(rplan)
                self.ledger.log_round(reports, extra, round_id=rnd)

        self.host_s += sp_sample.dur + sp_gather.dur + sp_scatter.dur
        self.round_s += sp_round.dur
        self.round_wall.append(sp_round.dur)
        if hstats is not None:
            hstats = {k: float(v) for k, v in hstats.items()}
        return {"ids": ids, "cohort_tr": tr_d, "losses": whole["losses"],
                "plan": rplan, "health": hstats}

    def burn_rounds(self, n: int) -> None:
        """Replay the host RNG draws of ``n`` skipped rounds on resume
        (the sampler/tracker restore from state_dict instead)."""
        for _ in range(n):
            self.channel.realize(self.N)
            if self.arrivals is not None:
                self.arrivals.burn_round()

    # ---- checkpoint/resume -------------------------------------------------

    def state_dict(self) -> Dict:
        d = {"sampler": self.sampler.state_dict(),
             "tracker": self.tracker.state_dict(),
             "needs_opt_reset": np.where(self.needs_opt_reset)[0].tolist(),
             "seen": np.where(self.seen)[0].tolist(),
             "host_s": self.host_s, "round_s": self.round_s}
        if self.est_bits is not None:
            d["est_bits"] = [float(b) for b in self.est_bits]
        return d

    def load_state_dict(self, d: Dict) -> None:
        self.sampler.load_state_dict(d["sampler"])
        self.tracker.load_state_dict(d["tracker"])
        self.needs_opt_reset = np.zeros(self.N, bool)
        self.needs_opt_reset[np.asarray(d["needs_opt_reset"],
                                        np.int64)] = True
        self.seen = np.zeros(self.N, bool)
        self.seen[np.asarray(d["seen"], np.int64)] = True
        self.host_s = float(d.get("host_s", 0.0))
        self.round_s = float(d.get("round_s", 0.0))
        if "est_bits" in d:
            self.est_bits = np.asarray(d["est_bits"], np.float64)

    def checkpoint_tree(self):
        """The store and the global as one tree of CPU tensors (views of
        the host arrays) for ``checkpoint.save_checkpoint``."""
        return trees.map_leaves(torch.from_numpy,
                                {"store": self.store.checkpoint_tree(),
                                 "global": self.global_shared})

    def load_checkpoint_tree(self, tree) -> None:
        self.store.load_checkpoint_tree(tree["store"])
        self.global_shared = trees.map_leaves(_writable, tree["global"])

    @property
    def host_overhead_frac(self) -> float:
        return self.host_s / self.round_s if self.round_s > 0 else 0.0
