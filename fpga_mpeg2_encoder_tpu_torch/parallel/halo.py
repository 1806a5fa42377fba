"""Slice-row sharding support: the halo exchange of the previous frame's
reconstruction.

P-frame motion estimation for a macroblock row needs +-YR rows (YR <= 6) of
the previous frame's reconstruction beyond its own shard.  When a frame's
slice rows are sharded over ranks, those rows live on the neighbouring
ranks; ``exchange_halo`` moves them with one batch of point-to-point sends
and receives to the rank above and the rank below (NCCL between cards, gloo
on the CPU), in place of the JAX package's two ``lax.ppermute`` shifts.
The reference needs no such machinery only because it is a single chip; the
RTL's equivalent hazard is handled by the one-slice write-delay memory
(RTL/mpeg2encoder.v:2364-2424).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from .mesh import local_range


def exchange_halo(x: torch.Tensor, halo: int, group) -> torch.Tensor:
    """Pad this rank's row block (rows, W) with ``halo`` rows from its
    neighbours in ``group`` -> (rows + 2*halo, W).  Edge ranks receive zeros
    (their out-of-frame candidates are masked, RTL:1642-1645, so the value
    never matters), as motion.pad_halo pads the whole frame."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    from_above = x.new_zeros((halo,) + x.shape[1:])
    from_below = x.new_zeros((halo,) + x.shape[1:])
    ops = []
    if idx > 0:              # my first rows are the bottom halo of the rank above
        up = dist.get_global_rank(group, idx - 1)
        ops += [dist.P2POp(dist.isend, x[:halo].contiguous(), up, group),
                dist.P2POp(dist.irecv, from_above, up, group)]
    if idx < n - 1:          # my last rows are the top halo of the rank below
        down = dist.get_global_rank(group, idx + 1)
        ops += [dist.P2POp(dist.isend, x[-halo:].contiguous(), down, group),
                dist.P2POp(dist.irecv, from_below, down, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([from_above, x, from_below], dim=0)


def sharded_row_sad(cur: torch.Tensor, prev: torch.Tensor, mesh: DeviceMesh, yr: int,
                    axis: str = "slice") -> torch.Tensor:
    """Validation kernel of the exchange: the full-pel SAD volume of a frame
    whose macroblock rows are sharded over ``axis``, each rank searching its
    own rows with a halo of ``yr`` rows from its neighbours.  ``cur`` and
    ``prev`` are the whole (H, W) frame on every rank; returns the whole
    ((2yr+1)**2, nby, nbx) int32 volume on every rank, identical to the
    single-device computation."""
    h, w = cur.shape
    group = mesh.get_group(axis)
    rows = local_range(h // 16, mesh, axis)
    cur_l = cur[16 * rows.start:16 * rows.stop].to(torch.int32)
    prev_l = prev[16 * rows.start:16 * rows.stop].to(torch.int32)
    prev_p = F.pad(exchange_halo(prev_l, yr, group), (yr, yr))
    hl = cur_l.shape[0]
    outs = []
    for dy in range(-yr, yr + 1):
        for dx in range(-yr, yr + 1):
            win = prev_p[yr + dy:yr + dy + hl, yr + dx:yr + dx + w]
            d = (cur_l - win).abs()
            outs.append(d.reshape(hl // 16, 16, w // 16, 16).sum(dim=(1, 3)))
    local = torch.stack(outs).to(torch.int32)
    parts = [torch.empty_like(local) for _ in range(mesh[axis].size())]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts, dim=1)
