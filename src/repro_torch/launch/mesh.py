"""Device meshes of the port: ``repro.launch.mesh`` over ``torch.distributed``.

A mesh has named axes (``data`` x ``model``, optionally a leading ``pod``).
The sharding recipes (``repro_torch.dist.sharding``) read only its
``shape``, a dict of axis sizes, so :class:`MeshShape` serves them without a
process group: ``make_production_mesh`` and ``make_debug_mesh`` return one,
with the reference's shapes and axis names.  :func:`init_mesh` lays a
:class:`Mesh` over the running world: a
``torch.distributed.device_mesh.DeviceMesh``, one process group per axis
and this rank's coordinate on each.

The caller names the backend and the device.  Nothing falls back from NCCL
to gloo or from the card to the CPU: NCCL wants one card per rank, so a
world with more ranks than cards (two ranks sharing one H100) runs on gloo,
whose collectives ``repro_torch.dist.comm`` stages through host memory.

:func:`fake_mesh` plays one rank of a mesh of any size in this process
(the dry run's counterpart of the reference's
``--xla_force_host_platform_device_count``): a world on the ``"fake"``
backend, whose collectives return at once and move nothing, over tensors
on the ``meta`` device, which hold shapes and no memory.
"""
from __future__ import annotations

import contextlib
import math
import os
from datetime import timedelta
from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")

# NVIDIA H100 SXM5 80GB (the port's card), per device, for rooflines:
HBM_BW = 3.35e12                  # bytes/s, HBM3
PEAK_FLOPS_BF16 = 989e12          # FLOP/s, dense tensor-core bf16
PEAK_FLOPS_F32 = 67e12            # FLOP/s, f32 on the CUDA cores
NVLINK_BW = 450e9                 # bytes/s each way, NVLink 4 (18 links)


class MeshShape:
    """Axis names and sizes, and nothing to run on: what the sharding
    recipes and the runners' accounting read (``dict(mesh.shape)``)."""

    def __init__(self, dims: Sequence[int], names: Sequence[str] = AXES):
        dims, names = tuple(int(d) for d in dims), tuple(names)
        if len(dims) != len(names):
            raise ValueError(f"mesh dims {dims} vs axis names {names}")
        self.dims, self.names = dims, names
        self.shape: Dict[str, int] = dict(zip(names, dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    def axis_size(self, name: str) -> int:
        return self.shape.get(name, 1)

    @property
    def distributed(self) -> bool:
        """True when collectives run: a mesh of several ranks with groups."""
        return False

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.shape})"


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape((2, 16, 16), POD_AXES)
    return MeshShape((16, 16), AXES)


def make_debug_mesh(data: int = 2, model: int = 2, *,
                    pods: int = 0) -> MeshShape:
    if pods:
        return MeshShape((pods, data, model), POD_AXES)
    return MeshShape((data, model), AXES)


class Mesh(MeshShape):
    """A mesh over the running world: ``device_mesh`` (the
    ``DeviceMesh``), ``groups`` (axis -> process group), ``coords`` (axis
    -> this rank's index on it), ``backend`` and ``device``."""

    def __init__(self, dims, names, *, device_mesh, backend: str,
                 device: torch.device):
        super().__init__(dims, names)
        self.device_mesh = device_mesh
        self.backend = backend
        self.device = device
        self.rank = dist.get_rank()
        self.groups = {n: device_mesh.get_group(n) for n in names}
        self.coords: Dict[str, int] = {
            n: device_mesh.get_local_rank(n) for n in names}

    @property
    def distributed(self) -> bool:
        return self.size > 1

    def group(self, name: str):
        return self.groups[name]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank {self.rank}, coords {self.coords}, "
                f"{self.backend} on {self.device})")


def wire_device(mesh) -> torch.device:
    """Where a collective's tensors made on the host (serving headers, a
    device call's host arrays, small statistics) go: the host under gloo
    and the fake backend, which take host tensors as they are (nothing
    staged), and the rank's card under NCCL, which takes CUDA tensors
    only."""
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


_LAST: Optional[Mesh] = None         # what init_mesh built last
_ACTIVE: Optional[MeshShape] = None   # what use_mesh set


def current_mesh() -> Optional[MeshShape]:
    """The mesh of the enclosing :func:`use_mesh` (None outside one): the
    expert-parallel MoE looks its axis's group up here, as the reference
    resolves an axis name inside ``shard_map``."""
    return _ACTIVE


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the :func:`current_mesh` inside the block."""
    global _ACTIVE
    saved, _ACTIVE = _ACTIVE, mesh
    try:
        yield mesh
    finally:
        _ACTIVE = saved


#: what ``init_process_group`` is given for each backend name (the fake
#: backend serves host and meta tensors, point-to-point ops included)
_BACKEND_ARG = {"gloo": "gloo", "nccl": "nccl", "fake": "cpu:fake,meta:fake"}


def check_backend(backend: str, device, world_size: int) -> None:
    """Refuse a backend that cannot run the world on ``device``."""
    dev = torch.device(device)
    if backend not in _BACKEND_ARG:
        raise ValueError(f"backend {backend!r}; expected gloo|nccl|fake")
    if (backend == "fake") != (dev.type == "meta"):
        raise ValueError(f"backend {backend} on {dev}: the fake backend "
                         "runs meta tensors, and only it does")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError(f"backend nccl runs on CUDA devices, not {dev}")
        n = torch.cuda.device_count()
        if world_size > n:
            raise ValueError(
                f"backend nccl needs a card per rank: {world_size} ranks on "
                f"{n} card(s); run ranks that share a card on gloo")
    elif backend == "gloo" and dev.type not in ("cpu", "cuda"):
        raise ValueError(f"backend gloo runs on cpu or cuda, not {dev}")


def init_mesh(dims: Sequence[int], names: Sequence[str] = AXES, *,
              backend: str, device, store=None, rank: Optional[int] = None,
              world_size: Optional[int] = None,
              timeout_s: float = 60.0) -> Mesh:
    """A :class:`Mesh` of shape ``dims`` over the world, which it starts
    when none is running: from ``store``, ``rank`` and ``world_size`` when
    given, else from the environment ``torch.distributed.run`` sets.  The
    mesh must cover the world exactly."""
    global _LAST
    from torch.distributed.device_mesh import DeviceMesh
    dims, names = tuple(int(d) for d in dims), tuple(names)
    dev = torch.device(device)
    if not dist.is_initialized():
        world = world_size if world_size is not None else \
            int(os.environ.get("WORLD_SIZE", "1"))
        check_backend(backend, dev, world)
        kw = dict(backend=_BACKEND_ARG[backend],
                  timeout=timedelta(seconds=timeout_s))
        if store is not None:
            kw.update(store=store, rank=rank, world_size=world_size)
        dist.init_process_group(**kw)
    elif dist.get_backend() != _BACKEND_ARG[backend]:
        raise ValueError(f"the world runs {dist.get_backend()}, not "
                         f"{backend}")
    world = dist.get_world_size()
    check_backend(backend, dev, world)
    if math.prod(dims) != world:
        raise ValueError(f"mesh {dims} needs {math.prod(dims)} ranks; the "
                         f"world has {world}")
    ids = torch.arange(world).reshape(dims)
    # a DeviceMesh takes no meta device: the fake world's groups sit on
    # the host, its tensors on meta
    dm = DeviceMesh("cpu" if dev.type == "meta" else dev.type, ids,
                    mesh_dim_names=names)
    _LAST = Mesh(dims, names, device_mesh=dm, backend=backend, device=dev)
    return _LAST


@contextlib.contextmanager
def fake_mesh(dims: Sequence[int], names: Optional[Sequence[str]] = None, *,
              rank: int = 0):
    """A :class:`Mesh` of shape ``dims`` on which this process plays rank
    ``rank`` of a ``"fake"`` world of ``prod(dims)`` ranks, tensors on the
    meta device: its collectives move nothing and the runners on it
    allocate nothing, so it traces one rank of a mesh of any size.  It
    refuses to start while a world is running, and destroys its world on
    exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    global _LAST
    dims = tuple(int(d) for d in dims)
    names = tuple(names) if names is not None else \
        (AXES if len(dims) == 2 else POD_AXES)
    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a process group is already running")
    world = math.prod(dims)
    if not 0 <= rank < world:
        raise ValueError(f"fake_mesh: rank {rank} of {world}")
    saved = _LAST
    try:
        yield init_mesh(dims, names, backend="fake", device="meta",
                        store=FakeStore(), rank=rank, world_size=world)
    finally:
        _LAST = saved
        if dist.is_initialized():
            dist.destroy_process_group()


def resolve(mesh) -> MeshShape:
    """A mesh argument of the runners as a :class:`MeshShape`: a
    ``MeshShape`` or ``Mesh`` as it is; a ``"D,M"`` string or a tuple as the
    (data, model) shape, which must fit the world: a 1 x 1 shape runs with
    no process group, a larger one on the mesh :func:`init_mesh` built
    last when that has the same shape."""
    if isinstance(mesh, MeshShape):
        return mesh
    dims = tuple(int(x) for x in mesh.split(",")) if isinstance(mesh, str) \
        else tuple(int(x) for x in mesh)
    names = AXES if len(dims) == 2 else POD_AXES
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(dims) > world:
        raise ValueError(f"mesh {dims} is larger than the world ({world} "
                         "rank(s)): start one with init_mesh")
    if math.prod(dims) == 1:
        return MeshShape(dims, names)
    cur = _LAST
    if cur is None or cur.dims != dims:
        raise ValueError(f"mesh {dims}: no mesh of that shape over the "
                         "world; build it with init_mesh")
    return cur
