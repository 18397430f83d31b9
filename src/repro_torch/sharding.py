"""The client-sharded cohort layout over ``torch.distributed``, the port of
``repro.sharding``'s cohort part (``client_shard_axes``, ``CohortSharding``,
``cohort_sharding``).

A ``ClientMesh`` stands where the JAX package has a ``jax.sharding.Mesh``:
named axes with their sizes, this process's rank and the process group its
collectives run over.  The stacked client axis of every
cohort leaf is sharded over the mesh: rank ``r`` of ``n`` holds rows
``[r·total/n, (r+1)·total/n)``.  Cohorts that do not divide ``n`` are
padded with **ghost clients**, copies of client 0 at aggregation weight 0
(fault masks pad with 1.0, so a ghost trains and receives like a real
client); the weighted means leave them out exactly.  Everything without a
client axis (the frozen base, the PPO global, the reward models) is held
whole by every rank.

The collectives live here and nowhere else, and every one is a SUM (or,
for ``pmax``, MAX) ``all_reduce``: with several ranks on one card the group
runs over gloo, which offers only ``broadcast`` and ``all_reduce`` on CUDA
tensors.  A client gather is each rank's rows written into a zero-filled
buffer of the whole cohort, then summed: exact, since x + 0 = x.

The (data, model) tensor-parallel mesh is here too, the port of the rest
of ``repro.sharding``: ``MeshCtx`` (axis names and sizes, this rank's
coordinates, one process group per axis slice), the rule tables and
``param_specs`` / ``batch_specs`` / ``cache_specs``, which build the same
specs as the JAX functions (a spec is a tuple of per-dimension entries:
None, an axis name or a tuple of names, element by element a
``PartitionSpec``), ``shard_tree`` / ``unshard_tree`` between a whole tree
and this rank's contiguous blocks, and the collectives with gradients the
model runs under a mesh (``copy_to``, ``reduce_from``, ``gather``,
``scatter``, ``all_to_all``).  Every one of them is a SUM or MAX
``all_reduce`` over an axis group, for the reason above; a gather sums a
zero-filled buffer that holds this rank's block, a reduce-scatter is an
``all_reduce`` and this rank's slice.  A ``MeshCtx`` without groups is
abstract: its collectives move nothing and record their logical op and
bytes (the dry run's per-device program).  The cohort engine under a
(data, model) mesh shards its clients over the client axes only: the model
ranks of one data coordinate hold the same rows and its collectives run
over the client group (``MeshCtx.client_mesh``).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import trees

@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """Axis names and sizes of the device mesh and this process's ``rank``
    in ``group`` (None: the default group).  ``launch/mesh.py`` builds one
    from torchrun's environment."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int = 0
    group: object = None
    lead: Optional[bool] = None     # None: rank 0 leads

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))


def client_shard_axes(mesh: ClientMesh, client_axes=None) -> Tuple[str, ...]:
    """Mesh axes the stacked client dim shards over: explicit ``client_axes``
    if given, else every non-"model" axis (("pod", "data") on the production
    mesh, ("data",) on a flat one)."""
    if client_axes is not None:
        return tuple(client_axes)
    axes = tuple(a for a in mesh.axis_names if a != "model")
    return axes or tuple(mesh.axis_names)


def _dist():
    import torch.distributed as dist
    return dist


def mesh_axes(mesh: ClientMesh, client_axes=None) -> Tuple[str, ...]:
    """The client axes of ``mesh`` after checking it: a ``ClientMesh`` whose
    process group is initialised and spans it, its client axes covering
    every axis of size > 1 (no silent world size 1; a (data, model) mesh
    comes as a ``MeshCtx``, whose ``client_mesh`` is such a mesh)."""
    if not isinstance(mesh, ClientMesh):
        raise TypeError(f"mesh must be a repro_torch.sharding.ClientMesh, not "
                        f"{type(mesh).__name__}")
    axes = client_shard_axes(mesh, client_axes)
    dist = _dist()
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("the client mesh's process group is not initialised: "
                           "start the run under torchrun (launch/mesh.py) or call "
                           "torch.distributed.init_process_group first")
    rest = [a for a, s in mesh.shape.items() if a not in axes and s > 1]
    if rest:
        raise ValueError(f"mesh axes {rest} besides the client axes {axes}: pass the "
                         "(data, model) mesh as a MeshCtx")
    world = dist.get_world_size(mesh.group)
    if world != mesh.size:
        raise ValueError(f"mesh {mesh.shape} has {mesh.size} ranks, its group {world}")
    return axes


def _all_reduce(t: torch.Tensor, mesh: ClientMesh, op: str) -> torch.Tensor:
    """The one collective call: ``t`` summed (or maxed) over the mesh's
    group, in place, returned."""
    dist = _dist()
    dist.all_reduce(t, op=getattr(dist.ReduceOp, op), group=mesh.group)
    return t


def psum(x: torch.Tensor, mesh: ClientMesh) -> torch.Tensor:
    """Sum of ``x`` over every rank (a new tensor; bool sums as f32)."""
    x = x.float() if x.dtype == torch.bool else x
    return _all_reduce(x.detach().clone().contiguous(), mesh, "SUM")


def pmax(x: torch.Tensor, mesh: ClientMesh) -> torch.Tensor:
    """Elementwise max of ``x`` over every rank."""
    return _all_reduce(x.detach().clone().contiguous(), mesh, "MAX")


def psum_tree(tree, mesh: ClientMesh):
    """Every f32 leaf of ``tree`` summed over the ranks in ONE all_reduce
    (the leaves flattened into one buffer, split back after)."""
    flat = trees.flatten(tree)
    if not flat:
        return tree
    leaves = list(flat.values())
    buf = psum(torch.cat([leaf.float().reshape(-1) for leaf in leaves]), mesh)
    out, off = {}, 0
    for p, leaf in flat.items():
        out[p] = buf[off:off + leaf.numel()].reshape(leaf.shape)
        off += leaf.numel()
    return trees.map_with_path(lambda p, _: out[p], tree)


def gather_clients(x: torch.Tensor, mesh: ClientMesh) -> torch.Tensor:
    """Each rank's (n_local, ...) rows → the whole cohort's (n_local·n, ...)
    on every rank: a zero-filled buffer holding this rank's rows, summed."""
    n = x.shape[0]
    dt = torch.float32 if x.dtype == torch.bool else x.dtype
    buf = torch.zeros((n * mesh.size,) + tuple(x.shape[1:]), dtype=dt, device=x.device)
    buf[mesh.rank * n:(mesh.rank + 1) * n] = x
    return _all_reduce(buf, mesh, "SUM")


def gather_tree(tree, mesh: ClientMesh):
    """``gather_clients`` over every leaf of a stacked tree, one all_reduce
    (leaves keep their dtypes)."""
    flat = trees.flatten(tree)
    if not flat:
        return tree
    leaves = list(flat.values())
    n = leaves[0].shape[0]
    whole = gather_clients(torch.cat([leaf.float().reshape(n, -1) for leaf in leaves], 1),
                           mesh)
    out, off = {}, 0
    for p, leaf in flat.items():
        k = leaf[0].numel()
        out[p] = whole[:, off:off + k].reshape((whole.shape[0],) + tuple(leaf.shape[1:])) \
            .to(leaf.dtype)
        off += k
    return trees.map_with_path(lambda p, _: out[p], tree)


@dataclasses.dataclass(frozen=True)
class CohortSharding:
    """Device layout of one stacked cohort: the client axis over ``axes``,
    padded to ``total`` rows with ghosts (copies of client 0, aggregation
    weight 0).  ``mesh`` None: one process holds the whole cohort (no
    ghost; ``take`` and ``gather`` return what they are given)."""

    mesh: Optional[ClientMesh]
    axes: Optional[Tuple[str, ...]]
    n_clients: int       # real cohort size
    total: int           # ghost-padded size (a multiple of n_shards)

    @property
    def n_shards(self) -> int:
        if self.mesh is None:
            return 1
        return int(np.prod([self.mesh.shape[a] for a in self.axes]))

    @property
    def lead(self) -> bool:
        """Whether this process prints and writes (rank 0, or no mesh)."""
        if self.mesh is None:
            return True
        return self.mesh.rank == 0 if self.mesh.lead is None else self.mesh.lead

    @property
    def n_pad(self) -> int:
        return self.total - self.n_clients

    @property
    def n_local(self) -> int:
        return self.total // self.n_shards

    @property
    def rows(self) -> slice:
        """This rank's rows of the padded cohort."""
        lo = 0 if self.mesh is None else self.mesh.rank * self.n_local
        return slice(lo, lo + self.n_local)

    def pad(self, per_client: Sequence) -> list:
        """[n_clients] list → [total] list, ghosts = copies of entry 0."""
        per_client = list(per_client)
        assert len(per_client) == self.n_clients, (len(per_client), self.n_clients)
        return per_client + [per_client[0]] * self.n_pad

    def pad_vec(self, values, fill: float = 0.0) -> np.ndarray:
        """Append ``fill`` entries for every ghost client (fault masks pad
        with 1.0 so ghosts keep training and receiving)."""
        v = np.asarray(values, np.float32)
        return np.concatenate([v, np.full((self.n_pad,), fill, np.float32)])

    def pad_weights(self, weights) -> np.ndarray:
        """Append zero aggregation weight for every ghost client."""
        return self.pad_vec(weights, 0.0)

    def local(self, per_client: Sequence) -> list:
        """This rank's entries of the ghost-padded list."""
        return self.pad(per_client)[self.rows]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows → the real cohort's (n_clients, ...) rows."""
        return x if self.mesh is None else gather_clients(x, self.mesh)[:self.n_clients]

    def gather_tree(self, tree):
        """This rank's rows of a stacked tree → the real cohort's, every
        leaf (one all_reduce)."""
        if self.mesh is None:
            return tree
        return trees.map_leaves(lambda leaf: leaf[:self.n_clients],
                                gather_tree(tree, self.mesh))

    def take(self, stacked):
        """The real cohort's stacked tree (n_clients rows) → this rank's
        rows of its ghost-padded layout (new tensors under a mesh)."""
        if self.mesh is None:
            return stacked
        idx = self.local(list(range(self.n_clients)))
        return trees.map_leaves(
            lambda leaf: leaf[torch.as_tensor(idx, device=leaf.device)], stacked)

    def take_vec(self, values, fill: float = 0.0) -> np.ndarray:
        """This rank's entries of the ``fill``-padded (n_clients,) vector."""
        return self.pad_vec(values, fill)[self.rows]

    def ghosts(self) -> Optional[torch.Tensor]:
        """(n_local,) bool: which of this rank's rows are ghosts (None
        without a mesh)."""
        if self.mesh is None:
            return None
        return torch.arange(self.rows.start, self.rows.stop) >= self.n_clients


def cohort_sharding(mesh: Optional[ClientMesh], n_clients: int,
                    client_axes=None) -> CohortSharding:
    """The padded layout of an ``n_clients`` cohort over ``mesh`` (checked
    by ``mesh_axes``; a ``MeshCtx``: over its client axes, the model ranks
    replicas; None: the whole cohort in this process)."""
    if isinstance(mesh, MeshCtx):
        mesh, client_axes = mesh.client_mesh(client_axes), None
    if mesh is None:
        if client_axes is not None:
            raise ValueError("client_axes without a mesh")
        return CohortSharding(mesh=None, axes=None, n_clients=n_clients, total=n_clients)
    axes = mesh_axes(mesh, client_axes)
    n_shards = int(np.prod([mesh.shape[a] for a in axes]))
    total = -(-n_clients // n_shards) * n_shards
    return CohortSharding(mesh=mesh, axes=axes, n_clients=n_clients, total=total)



# ---------------------------------------------------------------------------
# The (data, model) mesh: MeshCtx, specs, sharded trees, collectives
# ---------------------------------------------------------------------------


class Spec:
    """One leaf's partition spec: a per-dimension entry, None (whole), an
    axis name or a tuple of names (the dimension split over their product,
    the first name major), as ``jax.sharding.PartitionSpec``; compares equal
    to a tuple of the same entries."""

    __slots__ = ("dims",)

    def __init__(self, *dims):
        # a one-name tuple is that name, as PartitionSpec has it
        self.dims = tuple(d[0] if isinstance(d, tuple) and len(d) == 1 else d
                          for d in dims)

    def __iter__(self):
        return iter(self.dims)

    def __len__(self):
        return len(self.dims)

    def __getitem__(self, i):
        return self.dims[i]

    def __eq__(self, other):
        if not isinstance(other, (Spec, tuple)):
            return NotImplemented
        return tuple(self) == tuple(other)

    def __hash__(self):
        return hash(self.dims)

    def __repr__(self):
        return f"Spec{self.dims}"


def spec_axes(entry) -> Tuple[str, ...]:
    """A spec entry as a tuple of axis names (() for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True, eq=False)
class MeshCtx:
    """The (data, model) device mesh of a tensor-parallel run: axis names
    and sizes (the ranks laid out row-major, the last axis innermost, as
    ``jax.make_mesh``), the batch axes and the model axis, this process's
    ``rank`` and ``groups``, {axes: process group} for every slice of the
    mesh along a set of axes (None for the whole world).  ``groups`` None
    makes the mesh abstract: collectives move nothing and append (op,
    bytes) to ``record``.  ``MeshCtx.create`` builds the groups,
    ``single_device`` the (1, 1) mesh, ``abstract`` a sizes-only one."""

    axis_names: Tuple[str, ...] = ("data", "model")
    sizes: Tuple[int, ...] = (1, 1)
    batch_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    rank: int = 0
    groups: Optional[Dict[Tuple[str, ...], object]] = None
    record: Optional[List[Tuple[str, int]]] = None

    # -- layout ----------------------------------------------------------
    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    @property
    def is_abstract(self) -> bool:
        return self.groups is None

    @property
    def data_size(self) -> int:
        return self.extent(self.batch_axes)

    @property
    def model_size(self) -> int:
        return int(self.shape[self.model_axis])

    @property
    def all_axes(self) -> Tuple[str, ...]:
        return tuple(self.batch_axes) + (self.model_axis,)

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's coordinate on every axis (row-major layout)."""
        out, r = {}, self.rank
        for name, size in reversed(list(zip(self.axis_names, self.sizes))):
            out[name] = r % size
            r //= size
        return out

    def extent(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in spec_axes(axes)]))

    def coord(self, axes) -> int:
        """This rank's block index along ``axes`` (the first name major)."""
        c = self.coords
        idx = 0
        for a in spec_axes(axes):
            idx = idx * self.shape[a] + c[a]
        return idx

    @classmethod
    def single_device(cls) -> "MeshCtx":
        return cls(groups={})

    @classmethod
    def abstract(cls, sizes, axis_names=("data", "model"), batch_axes=("data",),
                 model_axis: str = "model", rank: int = 0) -> "MeshCtx":
        """A sizes-only mesh (no process group): the dry run's and the spec
        tests'."""
        return cls(axis_names=tuple(axis_names), sizes=tuple(sizes),
                   batch_axes=tuple(batch_axes), model_axis=model_axis, rank=rank,
                   groups=None, record=[])

    @classmethod
    def create(cls, sizes, axis_names=("data", "model"), batch_axes=("data",),
               model_axis: str = "model") -> "MeshCtx":
        """The mesh over the initialised default process group (its world
        size the product of ``sizes``), with a group for every slice along
        every set of axes.  Every rank creates every group, in one order,
        its own or not: ``new_group`` is collective over the world."""
        dist = _dist()
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("MeshCtx.create needs an initialised process group "
                               "(torchrun, or torch.distributed.init_process_group)")
        sizes, names = tuple(int(s) for s in sizes), tuple(axis_names)
        world, rank = dist.get_world_size(), dist.get_rank()
        if int(np.prod(sizes)) != world:
            raise ValueError(f"mesh {dict(zip(names, sizes))} needs {int(np.prod(sizes))} "
                             f"ranks, the world has {world}")
        n = len(names)
        strides = [int(np.prod(sizes[i + 1:])) for i in range(n)]
        groups: Dict[Tuple[str, ...], object] = {}
        for k in range(1, n + 1):
            for combo in itertools.combinations(range(n), k):
                key = tuple(names[i] for i in combo)
                if k == n:
                    groups[key] = None              # the default group
                    continue
                others = [i for i in range(n) if i not in combo]
                for fixed in itertools.product(*[range(sizes[i]) for i in others]):
                    base = sum(f * strides[i] for f, i in zip(fixed, others))
                    ranks = [base + sum(c * strides[i] for c, i in zip(cs, combo))
                             for cs in itertools.product(*[range(sizes[i]) for i in combo])]
                    g = dist.new_group(ranks)
                    if rank in ranks:
                        groups[key] = g
        return cls(axis_names=names, sizes=sizes, batch_axes=tuple(batch_axes),
                   model_axis=model_axis, rank=rank, groups=groups)

    def group(self, axes):
        key = tuple(a for a in self.axis_names if a in spec_axes(axes))
        return self.groups[key]

    def client_mesh(self, client_axes=None) -> ClientMesh:
        """The cohort engine's mesh: the client axes (every non-model axis
        by default), this rank's coordinate on them and their group; the
        model ranks of one client coordinate are replicas, and only world
        rank 0 leads."""
        axes = tuple(client_axes) if client_axes is not None else tuple(
            a for a in self.axis_names if a != self.model_axis)
        return ClientMesh(axis_names=axes, sizes=tuple(self.shape[a] for a in axes),
                          rank=self.coord(axes), group=self.group(axes),
                          lead=self.rank == 0)

    # -- divisibility-aware spec construction (as the JAX MeshCtx) ----------
    def dim_axis(self, size: int, axis):
        """``axis`` (a name or tuple of names) if ``size`` divides by its
        extent (> 1), else None (replicate)."""
        if axis is None:
            return None
        extent = self.extent(axis)
        if extent <= 1:
            return None
        return axis if size % extent == 0 else None

    def spec(self, shape: Sequence[int], axes: Sequence[object]) -> Spec:
        assert len(shape) == len(axes), (shape, axes)
        return Spec(*[self.dim_axis(s, a) for s, a in zip(shape, axes)])

    # -- the one collective call -------------------------------------------
    def reduce(self, t: torch.Tensor, axes, op: str = "SUM",
               logical: str = "all-reduce", nbytes: Optional[int] = None) -> torch.Tensor:
        """``t`` summed (or maxed) over ``axes``' group in place, returned.
        An abstract mesh records (``logical``, ``nbytes`` or t's bytes)."""
        if self.extent(axes) <= 1:
            return t
        if self.groups is None:
            self.record.append((logical, int(nbytes if nbytes is not None
                                             else t.numel() * t.element_size())))
            return t
        dist = _dist()
        dist.all_reduce(t, op=getattr(dist.ReduceOp, op), group=self.group(axes))
        return t


def local_batch(meshctx: MeshCtx, global_batch: int) -> int:
    d = meshctx.data_size
    return max(1, math.ceil(global_batch / d))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _gather_fwd(x, mc: MeshCtx, axes, dim: int, logical: str):
    n, c = mc.extent(axes), mc.coord(axes)
    shape = list(x.shape)
    shape[dim] *= n
    buf = x.new_zeros(shape)
    buf.narrow(dim, c * x.shape[dim], x.shape[dim]).copy_(x)
    return mc.reduce(buf, axes, logical=logical)


def _block(x, mc: MeshCtx, axes, dim: int):
    n = x.shape[dim] // mc.extent(axes)
    return x.narrow(dim, mc.coord(axes) * n, n)


class _CopyTo(torch.autograd.Function):
    """Megatron's f: identity forward, gradient summed over the axes."""

    @staticmethod
    def forward(ctx, x, mc, axes):
        ctx.mc, ctx.axes = mc, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mc.reduce(g.contiguous().clone(), ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    """Megatron's g: summed over the axes forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mc, axes):
        return mc.reduce(x.contiguous().clone(), axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    """The whole dimension from every rank's block (a summed zero buffer);
    backward: the gradient summed over the axes then this rank's block
    (``sum_grad``, a reduce-scatter: the ranks computed different things
    with the whole), or this rank's block alone (they computed the same)."""

    @staticmethod
    def forward(ctx, x, mc, axes, dim, sum_grad):
        ctx.mc, ctx.axes, ctx.dim, ctx.sum_grad = mc, axes, dim, sum_grad
        return _gather_fwd(x.contiguous(), mc, axes, dim, "all-gather")

    @staticmethod
    def backward(ctx, g):
        mc, axes, dim = ctx.mc, ctx.axes, ctx.dim
        if ctx.sum_grad:
            g = mc.reduce(g.contiguous().clone(), axes, logical="reduce-scatter",
                          nbytes=_nbytes(g) // mc.extent(axes))
        return _block(g, mc, axes, dim).contiguous(), None, None, None, None


class _Scatter(torch.autograd.Function):
    """This rank's block forward; backward the gradient's blocks gathered."""

    @staticmethod
    def forward(ctx, x, mc, axes, dim):
        ctx.mc, ctx.axes, ctx.dim = mc, axes, dim
        return _block(x, mc, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_fwd(g.contiguous(), ctx.mc, ctx.axes, ctx.dim, "all-gather"), \
            None, None, None


class _AllToAll(torch.autograd.Function):
    """x (n, ...): row j goes to rank j; → (n, ...) with row j from rank j
    (``jax.lax.all_to_all`` tiled on dim 0): an (n, n, ...) buffer in which
    this rank fills its send row, summed.  Its own transpose backward."""

    @staticmethod
    def forward(ctx, x, mc, axes):
        ctx.mc, ctx.axes = mc, axes
        return _AllToAll.exchange(x, mc, axes)

    @staticmethod
    def backward(ctx, g):
        return _AllToAll.exchange(g, ctx.mc, ctx.axes), None, None

    @staticmethod
    def exchange(x, mc, axes):
        n, c = mc.extent(axes), mc.coord(axes)
        if n <= 1:
            return x.clone()
        buf = x.new_zeros((n,) + tuple(x.shape))
        buf[c] = x
        mc.reduce(buf, axes, logical="all-to-all", nbytes=_nbytes(x))
        return buf[:, c].contiguous()


def copy_to(x, mc: MeshCtx, axes):
    return x if mc.extent(axes) <= 1 else _CopyTo.apply(x, mc, axes)


def reduce_from(x, mc: MeshCtx, axes):
    return x if mc.extent(axes) <= 1 else _ReduceFrom.apply(x, mc, axes)


def gather(x, mc: MeshCtx, axes, dim: int, sum_grad: bool = True):
    if mc.extent(axes) <= 1:
        return x
    return _Gather.apply(x, mc, axes, dim % x.dim(), sum_grad)


def scatter(x, mc: MeshCtx, axes, dim: int):
    if mc.extent(axes) <= 1:
        return x
    return _Scatter.apply(x, mc, axes, dim % x.dim())


def all_to_all(x, mc: MeshCtx, axes):
    """``_AllToAll``; an integer tensor (no gradient) is exchanged as is."""
    if not x.is_floating_point():
        return _AllToAll.exchange(x, mc, axes)
    return _AllToAll.apply(x, mc, axes)


def all_reduce(x, mc: MeshCtx, axes, op: str = "SUM"):
    """``x`` summed (or maxed) over ``axes``, a new tensor, no gradient."""
    return mc.reduce(x.detach().contiguous().clone(), axes, op)


# ---------------------------------------------------------------------------
# Parameter / batch / cache sharding rules (copied from the JAX package)
# ---------------------------------------------------------------------------
#
# Rules are (path-suffix regex → per-dim logical axes, counted from the last
# dim); meshctx.spec() drops any axis that does not divide the dim.  "model"
# is the tensor-parallel axis, "__fsdp__" stands for the batch axes (ZeRO /
# FSDP sharding of weights and moments).  Unmatched leaves replicate.

_M = "model"
_F = "__fsdp__"

_PARAM_RULES = [
    (r"embed$", (_M, _F)),
    (r"lm_head$", (_F, _M)),
    (r"pos_embed$", (_M, _F)),
    (r"enc_pos$", (None, None)),
    (r"projector$", (_F, _M)),
    (r"(mixer|cross)/w[qkv]$", (_F, _M)),
    (r"(mixer|cross)/wo$", (_M, _F)),
    (r"mixer/wq_a$", (_F, _M)),
    (r"mixer/wq_b$", (_F, _M)),
    (r"mixer/wkv_a$", (_F, _M)),
    (r"mixer/wkv_b$", (_F, _M)),
    (r"mixer/in_proj$", (_F, _M)),
    (r"mixer/out_proj$", (_M, _F)),
    (r"mixer/conv_w$", (None, _M)),
    (r"mixer/conv_b$", (_M,)),
    (r"mixer/gate_norm/scale$", (_M,)),
    (r"ff/wg$", (_F, _M)),
    (r"ff/wu$", (_F, _M)),
    (r"ff/wd$", (_M, _F)),
    (r"ff/shared/w[gu]$", (_F, _M)),
    (r"ff/shared/wd$", (_M, _F)),
    (r"ff/router$", (None, None)),
    (r"adapter/w[du]$", (None, None)),
]

# MoE expert slabs (…, E, d, f): experts over model, d over FSDP
_EXPERT_RULES = [
    (r"ff/wg$", (_M, _F, None)),
    (r"ff/wu$", (_M, _F, None)),
    (r"ff/wd$", (_M, None, _F)),
]

POLICIES = ("fsdp", "fsdp_experts_only", "tp", "dp")


def moe_positions(cfg) -> set:
    """Path prefixes of the MoE layers' ff subtrees."""
    out = set()
    if cfg is not None:
        for si, stage in enumerate(cfg.stages):
            for pi, kind in enumerate(stage.pattern):
                if kind.ff == "moe":
                    out.add(f"stages/{si}/layers/{pi}/ff/")
    return out


def leaf_param_spec(meshctx: MeshCtx, path: str, shape, moe_at: set,
                    policy: str = "fsdp") -> Spec:
    """One leaf's spec under ``policy`` (``param_specs``' rule)."""
    if policy not in POLICIES:
        raise ValueError(f"policy {policy!r} not in {POLICIES}")

    def resolve(ax, is_expert=False):
        if policy == "dp":
            return None
        if ax == _F:
            if policy == "tp":
                return None
            if policy == "fsdp_experts_only" and not is_expert:
                return None
            return meshctx.batch_axes
        return ax

    shape = tuple(shape)
    if len(shape) == 0:
        return Spec()
    is_moe = any(path.startswith(p) for p in moe_at)
    if is_moe and not re.search(r"/(router|shared/w[gud])$", path):
        for pat, axes in _EXPERT_RULES:
            if re.search(pat, path):
                full = (None,) * (len(shape) - 3) + tuple(
                    resolve(a, is_expert=True) for a in axes)
                return meshctx.spec(shape, full)
    for pat, axes in _PARAM_RULES:
        if re.search(pat, path):
            n = len(axes)
            if len(shape) < n:
                return Spec(*([None] * len(shape)))
            full = (None,) * (len(shape) - n) + tuple(resolve(a) for a in axes)
            return meshctx.spec(shape, full)
    return Spec(*([None] * len(shape)))


def param_specs(meshctx: MeshCtx, params_shapes, cfg=None, policy: str = "fsdp"):
    """The spec tree of a params(-shaped) tree, as ``repro.sharding.
    param_specs``: ``cfg`` marks the MoE layers (their ff weights are expert
    slabs, experts over model); ``policy`` is ``fsdp`` (weights and moments
    over data × model), ``fsdp_experts_only``, ``tp`` or ``dp``."""
    moe_at = moe_positions(cfg)
    return trees.map_with_path(
        lambda p, leaf: leaf_param_spec(meshctx, p, leaf.shape, moe_at, policy),
        params_shapes)


def batch_specs(meshctx: MeshCtx, batch_shapes):
    """Batch dims over the data axes; everything else replicated."""
    def leaf_spec(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return Spec()
        return meshctx.spec(shape, (meshctx.batch_axes,) + (None,) * (len(shape) - 1))

    return trees.map_with_path(leaf_spec, batch_shapes)


def cache_seq_axes(meshctx: MeshCtx, batch: int):
    """(batch axes or None, sequence axes) of a decode cache: the batch over
    the data axes when it divides them, the sequence over the model axis,
    or over (data, model) when the batch cannot shard."""
    batch_ok = batch % max(meshctx.data_size, 1) == 0 and meshctx.data_size > 1
    seq_axes = _M if batch_ok else tuple(meshctx.batch_axes) + (_M,)
    return (meshctx.batch_axes if batch_ok else None), seq_axes


def cache_specs(meshctx: MeshCtx, cache_shapes, *, batch: int):
    """Decode-cache specs, as ``repro.sharding.cache_specs``: k/v (and the
    cross and persistent ones) (R, B, S, K, hd) batch over data, sequence
    over the model (flash-decode's partial softmax); rings over the batch
    only; MLA's latents like k; mamba's heads (``h``) and conv channels
    over model."""
    b_ax, seq_axes = cache_seq_axes(meshctx, batch)

    def leaf_spec(path, leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0:
            return Spec()
        if path.endswith(("/k", "/v", "/xk", "/xv", "/k_pers", "/v_pers")):
            return meshctx.spec(shape, (None, b_ax, seq_axes, None, None))
        if path.endswith(("/k_ring", "/v_ring")):
            return meshctx.spec(shape, (None, b_ax, None, None, None))
        if path.endswith(("/ckv", "/kpe")):
            return meshctx.spec(shape, (None, b_ax, seq_axes, None))
        if path.endswith("/h"):
            return meshctx.spec(shape, (None, b_ax, _M, None, None))
        if path.endswith("/conv"):
            return meshctx.spec(shape, (None, b_ax, None, _M))
        return Spec(*([None] * len(shape)))

    return trees.map_with_path(leaf_spec, cache_shapes)


def local_shape(shape, spec, meshctx: MeshCtx) -> Tuple[int, ...]:
    return tuple(s // meshctx.extent(e) for s, e in zip(shape, spec))


def shard_leaf(x, spec, meshctx: MeshCtx):
    """This rank's contiguous block of a whole leaf (a new tensor)."""
    for dim, entry in enumerate(spec):
        if meshctx.extent(entry) > 1:
            x = _block(x, meshctx, spec_axes(entry), dim)
    return x.clone() if x.device.type != "meta" else x.contiguous()


def unshard_leaf(x, spec, meshctx: MeshCtx):
    """The whole leaf from every rank's block (summed zero buffers)."""
    x = x.detach()
    for dim, entry in enumerate(spec):
        if meshctx.extent(entry) > 1:
            x = _gather_fwd(x.contiguous(), meshctx, spec_axes(entry), dim, "all-gather")
    return x


def _spec_of(flat_specs, path, leaf):
    spec = flat_specs.get(path)
    return Spec(*([None] * leaf.dim())) if spec is None else spec


def shard_tree(tree, specs, meshctx: MeshCtx):
    """A whole tree → this rank's blocks under ``specs`` (a spec tree or a
    {path: spec} dict; a leaf without one is replicated)."""
    flat = specs if isinstance(specs, dict) and all(
        isinstance(v, Spec) for v in specs.values()) else trees.flatten(specs)
    return trees.map_with_path(
        lambda p, x: shard_leaf(x, _spec_of(flat, p, x), meshctx), tree)


def unshard_tree(tree, specs, meshctx: MeshCtx):
    """``shard_tree``'s inverse: every rank gets the whole tree."""
    flat = specs if isinstance(specs, dict) and all(
        isinstance(v, Spec) for v in specs.values()) else trees.flatten(specs)
    return trees.map_with_path(
        lambda p, x: unshard_leaf(x, _spec_of(flat, p, x), meshctx), tree)
