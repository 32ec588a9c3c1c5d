"""Process groups and device meshes.

Port of ``repro/launch/mesh.py``.  The port's meshes are
``torch.distributed.device_mesh.DeviceMesh`` objects over an initialized
process group: NCCL on the card, gloo only where the caller asks for the
CPU (the tests).  Nothing here falls back: a mesh on ``"cuda"`` without
CUDA or NCCL raises, and so does a launched world of the wrong size.
Functions, not module-level constants, so importing this module touches
no device and no process group.
"""

from __future__ import annotations

import datetime
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

PRODUCTION_SHAPE = (16, 16)
PRODUCTION_AXES = ("data", "model")
MULTI_POD_SHAPE = (2, 16, 16)
MULTI_POD_AXES = ("pod", "data", "model")


def backend_for(device: "str | torch.device") -> str:
    """The collective backend of a device type: ``"nccl"`` for ``"cuda"``
    (raises when CUDA or NCCL is missing), ``"gloo"`` for ``"cpu"``."""
    kind = torch.device(device).type
    if kind == "cpu":
        return "gloo"
    if kind != "cuda":
        raise ValueError(f"no collective backend for device type {kind!r}")
    if not torch.cuda.is_available():
        raise RuntimeError("a mesh on 'cuda' needs CUDA, which is not available")
    if not dist.is_nccl_available():
        raise RuntimeError("a mesh on 'cuda' needs NCCL, which this torch lacks")
    return "nccl"


def init_group(device: "str | torch.device", store_path: str, *, rank: int = 0,
               world_size: int = 1, timeout_s: float = 120.0) -> str:
    """Start this process's rank of the default process group on a
    ``FileStore`` at ``store_path`` (every rank names the same file; no
    network address).  The backend is :func:`backend_for` the device; on
    ``"cuda"`` the rank's card is ``rank % device_count``.  Returns the
    backend."""
    backend = backend_for(device)
    kwargs = {}
    if backend == "nccl":
        index = rank % torch.cuda.device_count()
        torch.cuda.set_device(index)
        kwargs["device_id"] = torch.device("cuda", index)
    os.makedirs(os.path.dirname(os.path.abspath(store_path)), exist_ok=True)
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    return backend


def make_mesh(device: "str | torch.device", shape: tuple[int, ...],
              axes: tuple[str, ...]) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialized
    default group, whose world size must be the shape's product."""
    backend = backend_for(device)
    if not dist.is_initialized():
        raise RuntimeError(f"a mesh needs a process group: start one ({backend}) first, "
                           f"e.g. with launch.mesh.init_group")
    need = math.prod(shape)
    world = dist.get_world_size()
    if world != need:
        raise RuntimeError(f"a {shape} mesh over {axes} needs a world of {need} ranks; "
                           f"this one has {world}")
    if dist.get_backend() != backend:
        raise RuntimeError(f"a mesh on {torch.device(device).type!r} needs a {backend} "
                           f"group; this one is {dist.get_backend()}")
    return init_device_mesh(torch.device(device).type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The production mesh on ``"cuda"``: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` with ``"pod"``.  Raises, naming the
    world it needs, when the launched world is another size."""
    if multi_pod:
        return make_mesh("cuda", MULTI_POD_SHAPE, MULTI_POD_AXES)
    return make_mesh("cuda", PRODUCTION_SHAPE, PRODUCTION_AXES)


def make_host_mesh(device: "str | torch.device" = "cuda") -> DeviceMesh:
    """The one-rank ``(1, 1)`` mesh over ``("data", "model")`` on the
    caller's device (axes present, size 1)."""
    return make_mesh(device, (1, 1), PRODUCTION_AXES)

