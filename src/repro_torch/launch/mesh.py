"""Process groups and device meshes.

Port of ``repro/launch/mesh.py``.  The port's meshes are
``torch.distributed.device_mesh.DeviceMesh`` objects over an initialized
process group: NCCL on the card, gloo only where the caller asks for the
CPU (the tests).  Nothing here falls back: a mesh on ``"cuda"`` without
CUDA or NCCL raises, and so does a launched world of the wrong size.
Functions, not module-level constants, so importing this module touches
no device and no process group.

The dry run (``launch/dryrun.py``) builds the production meshes with no
cards: :func:`init_fake_group` starts torch's ``fake`` backend
(``torch.testing._internal.distributed.fake_pg``), whose collectives
return at once and move nothing, with this process as rank 0, and
``make_production_mesh(fake=True)`` lays the mesh over it on device type
``"cpu"``.  The roofline constants are the H100 SXM5 80GB's data-sheet
peaks, not measured (the reference's are v5e's, ``repro/launch/
mesh.py:12-14``).
"""

from __future__ import annotations

import datetime
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# NVIDIA H100 SXM5 80GB data-sheet values (not measured), read by the
# dry run's roofline terms
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s per card
HBM_BW = 3.35e12                # HBM3 bytes/s per card
LINK_BW = 450e9                 # NVLink bytes/s per card, each way
HBM_BYTES = 80 * 2**30          # the card's memory, as the dry run's fit test reads it

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


def init_fake_group(world_size: int) -> None:
    """Start a default process group of ``world_size`` ranks over torch's
    ``fake`` backend, this process rank 0.  Refuses (``RuntimeError``)
    when a process group already exists: a fake group must never stand in
    for a real one."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(f"a process group ({dist.get_backend()}, world "
                           f"{dist.get_world_size()}) already exists; a fake group needs none")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False, fake: bool = False) -> DeviceMesh:
    """The production mesh on ``"cuda"``: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` with ``"pod"``.  Raises, naming the
    world it needs, when the launched world is another size.  With
    ``fake`` the mesh lies on device type ``"cpu"`` over the fake group of
    :func:`init_fake_group`, which must have the mesh's size."""
    shape, axes = (MULTI_POD_SHAPE, MULTI_POD_AXES) if multi_pod else \
        (PRODUCTION_SHAPE, PRODUCTION_AXES)
    if fake:
        return make_fake_mesh(shape, axes)
    return make_mesh("cuda", shape, axes)


def make_fake_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    """A ``"cpu"`` mesh of ``shape`` over the fake group of
    :func:`init_fake_group`, whose world must be the shape's product."""
    if not dist.is_initialized() or dist.get_backend() != "fake":
        raise RuntimeError("a fake mesh needs the fake group: start it with init_fake_group")
    if dist.get_world_size() != math.prod(shape):
        raise RuntimeError(f"a {shape} mesh needs a fake world of {math.prod(shape)} ranks; "
                           f"this one has {dist.get_world_size()}")
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_host_mesh(device: "str | torch.device" = "cuda") -> DeviceMesh:
    """The one-rank ``(1, 1)`` mesh over ``("data", "model")`` on the
    caller's device (axes present, size 1)."""
    return make_mesh(device, (1, 1), PRODUCTION_AXES)

