"""The (data, model) process mesh.

The port of ``pislam_tpu/parallel/mesh.py``. JAX runs one program over
many devices of one process; PyTorch runs one process (rank) per device, so
the mesh here is a ``torch.distributed`` ``DeviceMesh`` of the ranks of the
initialised process group (``parallel/elastic.initialize_multihost``):

* "data"  -- frames: each rank extracts / tracks its own camera streams;
* "model" -- the map: each rank owns a slab of landmark, keyframe-store or
             BA rows, and the slabs merge through one collective over the
             axis's group (``parallel/dist.py``).

Every rank holds the whole state; what the axes shard is the work. So
``data_sharding`` / ``model_sharding`` / ``replicated`` here give the rows
of an axis that this rank works on, not a layout of memory.
"""

from __future__ import annotations

import torch
import torch.distributed as tdist
from torch.distributed.device_mesh import DeviceMesh

from ..config import MeshConfig


def make_mesh(cfg: MeshConfig = MeshConfig()) -> DeviceMesh:
    """A (data_parallel, model_parallel) mesh over every rank of the process
    group, named (cfg.data_axis, cfg.model_axis); all ranks on the data axis
    where data_parallel * model_parallel is not the world size. Collective:
    every rank calls it. Its device type follows the group's backend (NCCL:
    cuda, else cpu)."""
    if not tdist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.elastic.initialize_multihost first (or run under torchrun)")
    world = tdist.get_world_size()
    dp, mp = cfg.data_parallel, cfg.model_parallel
    if dp * mp != world:
        dp, mp = world, 1
    device_type = "cuda" if tdist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(world).reshape(dp, mp)
    return DeviceMesh(device_type, ranks, mesh_dim_names=(cfg.data_axis, cfg.model_axis))


def comm_device(group=None) -> torch.device:
    """The device a collective of ``group`` (default: the whole world) takes
    its tensors on: the current card for NCCL, else the CPU."""
    if tdist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def shard_rows(mesh: DeviceMesh, axis: str, n: int) -> slice:
    """The rows of n that this rank owns along ``axis``: equal contiguous
    slabs in axis order (n must divide by the axis size)."""
    size = axis_size(mesh, axis)
    if n % size:
        raise ValueError(f"{n} rows do not split into {size} equal shards on {axis!r}")
    per = n // size
    lo = axis_index(mesh, axis) * per
    return slice(lo, lo + per)


def data_sharding(mesh: DeviceMesh, n: int) -> slice:
    return shard_rows(mesh, mesh.mesh_dim_names[0], n)


def model_sharding(mesh: DeviceMesh, n: int) -> slice:
    return shard_rows(mesh, mesh.mesh_dim_names[1], n)


def replicated(mesh: DeviceMesh, n: int) -> slice:
    return slice(0, n)
