"""The process group and the meshes over it (port of
``repro/launch/mesh.py``).

The reference builds ``jax.sharding.Mesh``es over the visible devices.
Here a device is a rank of the default ``torch.distributed`` process
group (one GPU per rank on NCCL, one CPU process per rank on gloo), and a
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over those ranks.

``init_world(device)`` starts the default group: from torchrun's
``env://`` variables when they are set, else on a ``FileStore``
(``init_file``, ``rank`` and ``world_size`` given, or a world of one in a
temporary directory).  CUDA runs NCCL, with ``device_id=`` so that the
communicator exists before a CUDA graph captures a collective; the CPU
runs gloo.  Neither falls back to the other.  NCCL takes one GPU per rank,
so a rank without a GPU of its own raises.

Meshes: ``make_expert_mesh`` and ``make_train_mesh`` (router training),
``make_host_mesh(data, model)`` (an LM ``("data", "model")`` mesh over the
ranks there are, clipped to the world's size as the reference clips it to
its devices) and ``make_production_mesh`` (the reference's 16 x 16 pod, or
2 x 16 x 16 with ``("pod", "data", "model")``; it raises, as
``jax.make_mesh`` does, in a world with fewer ranks).  A mesh over fewer
ranks than the world takes the first ones.  ``make_mesh(shape, names)``
is the reference's ``make_mesh_compat`` (jax's axis types have no meaning
here).  The reference's TPU v5e constants for its roofline become an
H100's (``PEAK_FLOPS_BF16``, ``HBM_BW``, ``NVLINK_BW``), each its data
sheet's figure for the SXM5 80GB part at 700 W.  Importing this module
starts nothing.
"""
from __future__ import annotations

import datetime
import functools
import math
import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import DeviceLike, resolve

_TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _rank_device(dev: torch.device, local_rank: int,
                 local_world: int) -> torch.device:
    """This rank's GPU: ``cuda:local_rank``, or ``dev`` itself in a world
    of one.  Raises where two ranks would share a GPU."""
    if dev.type != "cuda":
        return dev
    if local_world == 1:
        return torch.device("cuda", torch.cuda.current_device()
                            if dev.index is None else dev.index)
    n_gpu = torch.cuda.device_count()
    if local_rank >= n_gpu:
        raise RuntimeError(
            f"NCCL runs one rank per GPU: local rank {local_rank} of "
            f"{local_world} has no GPU of its own ({n_gpu} visible), so it "
            "would share one another rank holds")
    return torch.device("cuda", local_rank)


def init_world(device: DeviceLike = None, *, init_file: Optional[str] = None,
               rank: int = 0, world_size: int = 1,
               timeout: Optional[datetime.timedelta] = None) -> torch.device:
    """Start the default process group for ``device`` (CUDA by default)
    and return this rank's device.  Under torchrun the group comes from
    its environment; otherwise from a ``FileStore`` at ``init_file`` with
    ``rank`` of ``world_size`` (a world of one in a temporary directory
    without one).  Returns at once when the group exists with the backend
    ``device`` needs; raises when it runs the other."""
    dev = resolve(device)
    backend = backend_for(dev)
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(f"the process group runs {have}; device {dev} "
                               f"needs {backend}")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        return _rank_device(dev, local, dist.get_world_size())
    kw = {} if timeout is None else {"timeout": timeout}
    if all(k in os.environ for k in _TORCHRUN):
        local = int(os.environ.get("LOCAL_RANK", 0))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                         os.environ["WORLD_SIZE"]))
        dev = _rank_device(dev, local, local_world)
        kw["init_method"] = "env://"
    else:
        if init_file is None:
            if world_size != 1:
                raise ValueError("a world of more than one rank needs "
                                 "init_file (or torchrun's environment)")
            init_file = os.path.join(tempfile.mkdtemp(prefix="repro_world"),
                                     "store")
        dev = _rank_device(dev, rank, world_size)
        kw.update(store=dist.FileStore(init_file, world_size), rank=rank,
                  world_size=world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, **kw)
    _mesh.cache_clear()
    _grid.cache_clear()
    return dev


def close_world() -> None:
    """Destroy the default process group (and the meshes built on it)."""
    _mesh.cache_clear()
    _grid.cache_clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def device_order(n_devices: Optional[int] = None) -> list:
    """The first ``n_devices`` ranks of the world in process-major order,
    which is rank order: each rank is a process of its own."""
    ranks = list(range(dist.get_world_size()))
    return ranks[:n_devices] if n_devices else ranks


@functools.lru_cache(maxsize=None)
def _mesh(n: int, data: Optional[int]):
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.tensor(device_order(n))
    if data is None:
        return DeviceMesh(device_type, ranks, mesh_dim_names=("expert",))
    return DeviceMesh(
        device_type, ranks.reshape(data, n // data),
        mesh_dim_names=("data", "expert"))


def make_expert_mesh(n_devices: Optional[int] = None):
    """1-D mesh over the ``expert`` axis (the engine's ``"shard"`` backend
    and the capacity-sharded replay buffer), over every rank by default;
    cached, so a step may call it freely.  Needs ``init_world`` first."""
    return _mesh(n_devices or dist.get_world_size(), None)


def make_train_mesh(n_devices: Optional[int] = None,
                    data: Optional[int] = None):
    """Mesh for router training.  ``data=None`` is the 1-D ``expert``
    mesh: ``training.make_iteration(mesh=...)`` splits the replay buffer's
    capacity over it, everything else replicated.  ``data=k`` is a 2-D
    ``("data", "expert")`` mesh (ranks in ``device_order``, row-major):
    the envs also split over ``data``, bit-identical to the 1-D path.
    ``data=1`` is a degenerate but valid 2-D mesh, which drives the gather
    path on one device."""
    n = n_devices or dist.get_world_size()
    if data is not None and (data < 1 or n % data):
        raise ValueError(
            f"n_devices={n} not divisible into a data axis of {data}")
    return _mesh(n, data)


@functools.lru_cache(maxsize=None)
def _grid(shape: tuple, names: tuple):
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.tensor(device_order(math.prod(shape))).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def make_mesh(shape, names):
    """A mesh of axes ``names`` and sizes ``shape`` over the first ranks
    of the world (the reference's ``make_mesh_compat``); cached.  Raises,
    with ``jax.make_mesh``'s message, in a smaller world."""
    shape, n = tuple(shape), dist.get_world_size()
    if n < math.prod(shape):
        raise ValueError(f"Number of devices {n} must be >= the product of "
                         f"mesh_shape {shape}")
    return _grid(shape, tuple(names))


def make_production_mesh(*, multi_pod: bool = False):
    """16 x 16 = 256 ranks ``("data", "model")``; 2 x 16 x 16 = 512
    ``("pod", "data", "model")`` when ``multi_pod``.  Raises, with
    ``jax.make_mesh``'s message, in a smaller world."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_mesh((16, 16), ("data", "model"))


def make_host_mesh(data: int = 1, model: int = 1):
    """A ``("data", "model")`` mesh over the ranks there are, clipped as
    the reference clips it: ``data = min(data, n)``, ``model = max(1,
    min(model, n // data))``; cached.  Needs ``init_world`` first."""
    n = dist.get_world_size()
    data = min(data, n)
    model = max(1, min(model, n // max(data, 1)))
    return _grid((data, model), ("data", "model"))


# NVIDIA H100 SXM5 80GB at 700 W, from its data sheet (dense rates)
PEAK_FLOPS_BF16 = 989e12       # bf16 on the tensor cores, per card
HBM_BW = 3.35e12               # bytes/s of HBM3 per card
NVLINK_BW = 450e9              # bytes/s per direction of NVLink 4, per card
