"""The process mesh of a run with one process per partition, the
reference's ``repro.launch.mesh`` over ``torch.distributed``.

``python -m torch.distributed.run --nproc-per-node k ...`` starts k ranks
and sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE`` (and the rendezvous address) in each;
:func:`init_process_group_from_env` reads them, picks the backend and the
rank's device and joins the group, and :func:`make_local_mesh` lays the
ranks out as a ``("data", "model")`` device mesh, as the reference's
``make_local_mesh`` lays out the devices it finds.

The backend rule (:func:`choose_backend`):

* ``gloo`` on the CPU;
* ``gloo`` when ranks share a card (more ranks on the host than cards):
  the trainers then stage what they exchange through pinned host memory;
* ``nccl`` when every rank on the host has a card of its own
  (``LOCAL_WORLD_SIZE <= torch.cuda.device_count()``).

Asking for ``nccl`` where ranks would share a card raises ``ValueError``:
NCCL refuses two ranks on one GPU, with an error that does not say so.
Each rank's device is ``cuda:{LOCAL_RANK % device_count}``, or the CPU.
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device

__all__ = ["choose_backend", "env_world", "init_process_group_from_env",
           "make_local_mesh", "batch_axes", "data_rank", "data_size",
           "data_group"]


def env_world() -> int:
    """``WORLD_SIZE`` as ``torch.distributed.run`` sets it (1 when unset)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def choose_backend(device_type: str, local_world_size: int,
                   device_count: int, requested: Optional[str] = None) -> str:
    """The module docstring's rule; ``requested`` is checked against it
    (``ValueError`` for ``nccl`` on the CPU or on a shared card)."""
    if requested not in (None, "gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl, got {requested!r}")
    if device_type != "cuda":
        if requested == "nccl":
            raise ValueError("the nccl backend needs CUDA devices; the CPU "
                             "runs gloo")
        return "gloo"
    own_card = 0 < local_world_size <= device_count
    if requested == "nccl" and not own_card:
        raise ValueError(
            f"nccl needs a card per rank: {local_world_size} ranks on this "
            f"host share {device_count} card(s); use gloo (the default "
            f"there), which stages the exchange through host memory")
    return requested or ("nccl" if own_card else "gloo")


def init_process_group_from_env(device: DeviceLike = "cuda",
                                backend: Optional[str] = None,
                                init_method: Optional[str] = None,
                                timeout_s: float = 600.0
                                ) -> Tuple[torch.device, str]:
    """Join the process group of a ``torch.distributed.run`` launch; returns
    this rank's ``(device, backend)``.

    The entry points (``pipeline run``, ``launch.train``) pass no
    ``backend`` and take the rule's choice. A program that starts its own
    ranks and must have one backend (say ``gloo`` where ranks have cards
    of their own, to compare it with ``nccl``) passes it, and it is held
    to the rule: ``nccl`` on a shared card or the CPU raises.

    ``init_method`` defaults to ``env://`` (the launcher's rendezvous); a
    ``file://`` path runs one without a port. Joining twice raises."""
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    dev = resolve_device(device)
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = choose_backend(dev.type, local_world, count, backend)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s),
        **({"device_id": dev} if backend == "nccl" else {}))
    return dev, backend


def make_local_mesh(model: int = 1):
    """A ``(world // model, model)`` mesh named ``("data", "model")`` over
    the initialized process group (raises without one)."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_local_mesh needs an initialized process "
                           "group (init_process_group_from_env)")
    world = dist.get_world_size()
    if model < 1 or world % model:
        raise ValueError(f"model={model} does not divide the world size "
                         f"{world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world // model, model),
                            mesh_dim_names=("data", "model"))


def batch_axes(mesh) -> Tuple[str, ...]:
    """Axes that shard the batch (data parallel, pod-extended)."""
    names = mesh.mesh_dim_names
    return ("pod", "data") if "pod" in names else ("data",)


def data_size(mesh) -> int:
    """The size of the mesh's ``data`` axis."""
    return int(mesh.size(mesh.mesh_dim_names.index("data")))


def data_rank(mesh) -> int:
    """This process's coordinate on the ``data`` axis."""
    return int(mesh.get_local_rank("data"))


def data_group(mesh):
    """The process group along the ``data`` axis."""
    return mesh.get_group("data")
