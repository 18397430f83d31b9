"""The meshes of a launched run, the counterpart of ``repro.launch.mesh``.

The client mesh is a one-axis ``("data",)`` mesh of every rank that
torchrun started, the stacked client axis sharded over it:

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --arch roberta-base --fl-clients 4 ...

torchrun sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous
address; ``make_client_mesh`` joins the process group from them.  On the
card each rank takes ``cuda:LOCAL_RANK`` over NCCL; NCCL will not put two
ranks on one card, so where the node starts more ranks than it has cards
they share the cards over gloo.  ``device="cpu"`` runs gloo on the CPU.

The tensor-parallel mesh (``make_tp_mesh``) lays torchrun's world out as
(data, world / data), row-major with the model axis innermost, as
``jax.make_mesh`` does, and builds a process group for every slice of it
(``sharding.MeshCtx.create``):

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        -m repro_torch.launch.train --arch llama3.2-1b --steps 3 --data-axis 2

The production meshes, (16 data × 16 model) and (2 pod × 16 × 16), are
``make_production_mesh`` / ``make_meshctx``: abstract (sizes only, no
group; the dry run's) unless the world has exactly their 256 or 512 ranks.
The roofline constants are the H100 SXM's data-sheet figures, not a
measurement.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch.sharding import ClientMesh, MeshCtx

# Roofline constants of one card: NVIDIA H100 SXM5 data sheet (700 W
# board power limit), not measured here.
PEAK_FLOPS_BF16 = 989e12          # dense bf16 tensor-core FLOP/s per card
PEAK_FLOPS_F32 = 67e12            # f32 CUDA-core FLOP/s per card (no TF32)
HBM_BW = 3.35e12                  # HBM3 bytes/s per card
NVLINK_BW = 450e9                 # NVLink 4 bytes/s per card, one direction


def in_torchrun() -> bool:
    """Whether torchrun (or another launcher) set this process's rank."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def client_mesh() -> ClientMesh:
    """The ``("data",)`` mesh of the initialised default process group;
    raises when no group is initialised."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("no process group is initialised: start the run under "
                           "torchrun or call torch.distributed.init_process_group")
    return ClientMesh(axis_names=("data",), sizes=(dist.get_world_size(),),
                      rank=dist.get_rank())


def rank_device(device: Optional[str] = None) -> torch.device:
    """This rank's device: the CPU when ``device`` says so, else
    ``cuda:LOCAL_RANK`` modulo the node's cards."""
    if torch.device(device or "cuda").type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu for gloo on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                        % torch.cuda.device_count())


def _join(device: Optional[str] = None) -> None:
    """Join torchrun's process group unless one is initialised already: on
    the card NCCL, or gloo where the node runs more ranks than it has cards
    (NCCL will not put two ranks on one card); gloo on the CPU."""
    import torch.distributed as dist
    if not in_torchrun() and not dist.is_initialized():
        raise RuntimeError("RANK/WORLD_SIZE are not set: launch with "
                           "python -m torch.distributed.run")
    dev = rank_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        per_node = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        backend = "nccl" if per_node <= torch.cuda.device_count() else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend)


def make_tp_mesh(data_axis: int = 0, device: Optional[str] = None) -> MeshCtx:
    """The (data, model) mesh of torchrun's world: ``data_axis`` data
    coordinates (0: every rank, as the JAX launcher's ``--data-axis 0``,
    (n, 1)) by world / data_axis model coordinates."""
    import torch.distributed as dist
    _join(device)
    world = dist.get_world_size()
    d = data_axis or world
    if d < 1 or world % d:
        raise ValueError(f"--data-axis {data_axis} does not divide the world of {world}")
    return MeshCtx.create((d, world // d))


def make_production_mesh(*, multi_pod: bool = False) -> MeshCtx:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with batch axes ("pod", "data"): over the process group when the world
    has exactly that many ranks, abstract otherwise."""
    import torch.distributed as dist
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    batch_axes = axes[:-1]
    n = 1
    for s in shape:
        n *= s
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() == n:
        return MeshCtx.create(shape, axes, batch_axes)
    return MeshCtx.abstract(shape, axes, batch_axes)


def make_meshctx(*, multi_pod: bool = False) -> MeshCtx:
    return make_production_mesh(multi_pod=multi_pod)


def make_client_mesh(device: Optional[str] = None) -> ClientMesh:
    """Join torchrun's process group (unless one is initialised already) and
    return its client mesh.  On the card (``rank_device``) the group runs
    NCCL, or gloo where the node runs more ranks than it has cards; on the
    CPU it runs gloo."""
    _join(device)
    return client_mesh()
