"""The client mesh of a launched run, the counterpart of
``repro.launch.mesh``: a one-axis ``("data",)`` mesh of every rank that
torchrun started, the stacked client axis sharded over it.

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m repro_torch.launch.train --arch roberta-base --fl-clients 4 ...

torchrun sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the rendezvous
address; ``make_client_mesh`` joins the process group from them.  On the
card each rank takes ``cuda:LOCAL_RANK`` over NCCL; NCCL will not put two
ranks on one card, so where the node starts more ranks than it has cards
they share the cards over gloo.  ``device="cpu"`` runs gloo on the CPU.

The (16, 16) and (2, 16, 16) production meshes of the JAX module go with
the tensor-parallel slice (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from repro_torch.sharding import ClientMesh


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


def make_client_mesh(device: Optional[str] = None) -> ClientMesh:
    """Join torchrun's process group (unless one is initialised already) and
    return its client mesh.  On the card (``rank_device``) the group runs
    NCCL, or gloo where the node runs more ranks than it has cards; on the
    CPU it runs gloo."""
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
    return client_mesh()
