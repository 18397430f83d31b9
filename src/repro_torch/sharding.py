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

The (data, model) tensor-parallel mesh (``MeshCtx`` and its specs) is not
here: a mesh whose client axes leave another axis of size > 1 raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import trees

TENSOR_PARALLEL = ("the (data, model) tensor-parallel mesh is ROADMAP queue 1 item 8's "
                   "last part (MeshCtx, param/batch/cache specs, --data-axis)")


@dataclasses.dataclass(frozen=True)
class ClientMesh:
    """Axis names and sizes of the device mesh and this process's ``rank``
    in ``group`` (None: the default group).  ``launch/mesh.py`` builds one
    from torchrun's environment."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int = 0
    group: object = None

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
    every axis of size > 1 (no silent world size 1, no tensor
    parallelism)."""
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
        raise NotImplementedError(f"mesh axes {rest} besides the client axes: "
                                  f"{TENSOR_PARALLEL}")
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
        return self.mesh is None or self.mesh.rank == 0

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
    by ``mesh_axes``; None: the whole cohort in this process)."""
    if mesh is None:
        if client_axes is not None:
            raise ValueError("client_axes without a mesh")
        return CohortSharding(mesh=None, axes=None, n_clients=n_clients, total=n_clients)
    axes = mesh_axes(mesh, client_axes)
    n_shards = int(np.prod([mesh.shape[a] for a in axes]))
    total = -(-n_clients // n_shards) * n_shards
    return CohortSharding(mesh=mesh, axes=axes, n_clients=n_clients, total=total)

