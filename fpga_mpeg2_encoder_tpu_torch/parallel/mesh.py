"""Process meshes for the scale-out paths, over ``torch.distributed``.

The scaling axes are those of the JAX package:

* ``stream`` - data parallelism over independent video streams: no
  collectives, so every stream stays bit-exact whatever the mesh;
* ``slice``  - one frame's macroblock rows sharded over ranks, with a
  halo exchange of the previous frame's reconstruction between neighbours
  (parallel/halo.py).

A mesh is a ``DeviceMesh`` over the ranks of the default process group,
which the caller initialises (``dist.init_process_group`` with its address,
world size and rank: NCCL for cards, gloo for the CPU).  Each rank is one
process driving one device.  The JAX package's ``stream_sharding`` and
``replicated`` are placement objects of a single controller that holds
global arrays; torch has no global arrays, so ``local_range`` takes their
place: it gives the streams or macroblock rows a rank owns, the contiguous
block that sharding an axis gives it.  What JAX replicates, every rank holds
whole.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _device_type(device: str) -> str:
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch sees no CUDA device")
        # NCCL needs each rank's card current before its first collective
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    elif kind != "cpu":
        raise ValueError(f"unsupported device {device}")
    return kind


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device: str) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("initialise the default process group first "
                           "(torch.distributed.init_process_group)")
    need = 1
    for n in shape:
        need *= n
    if dist.get_world_size() != need:
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {need} ranks, "
                         f"the process group has {dist.get_world_size()}")
    return DeviceMesh(_device_type(device), torch.arange(need).reshape(shape),
                      mesh_dim_names=axes)


def make_mesh(n_devices: Optional[int] = None, axis: str = "stream",
              device: str = "cuda") -> DeviceMesh:
    """1-D mesh over all ``n_devices`` ranks of the process group (default:
    its world size)."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return _mesh((n,), (axis,), device)


def make_mesh2d(n_stream: int, n_slice: int, axes: tuple = ("stream", "slice"),
                device: str = "cuda") -> DeviceMesh:
    """2-D mesh: independent streams on the first axis (no collectives),
    slice-row shards on the second (the halo exchange and the row gather).
    Ranks of one slice group are adjacent, so on one host they share the
    fastest links."""
    return _mesh((n_stream, n_slice), tuple(axes), device)


def local_range(n: int, mesh: DeviceMesh, axis: str) -> range:
    """The items (streams, or macroblock rows) of ``n`` that this rank owns
    along ``axis``: the contiguous block its coordinate gives it."""
    size = mesh[axis].size()
    if n % size:
        raise ValueError(f"{n} items do not divide {size} shards of axis {axis!r}")
    per = n // size
    k = mesh.get_local_rank(axis)
    return range(k * per, (k + 1) * per)
