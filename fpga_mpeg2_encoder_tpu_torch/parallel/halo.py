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


def exchange_halo(x: torch.Tensor, halo: int, group, out=None) -> torch.Tensor:
    """Pad this rank's row block ``x`` with ``halo`` rows from its
    neighbours in ``group``: the rows are dim -2, so ``x`` is one plane
    (rows, W) or a stack of them (B, rows, W), padded to rows + 2*halo.
    Edge ranks receive zeros (their out-of-frame candidates are masked,
    RTL:1642-1645, so the value never matters), as motion.pad_halo pads the
    whole frame.  One batch of sends and receives serves the whole stack.

    With ``out`` (the padded shape, dtype and device) the block is written
    there and ``out`` returned: this rank's rows are copied in and the
    neighbours' rows received straight into it where its halo rows are
    contiguous (a single plane), through a buffer otherwise.  Halo rows at
    a frame edge are not written: zero them once.  Every copy and receive
    is ordered on the current stream, so ``x`` may be a tensor that the next
    work on that stream overwrites."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    rows = x.shape[-2]
    shape = x.shape[:-2] + (rows + 2 * halo, x.shape[-1])
    if out is None:
        out = x.new_zeros(shape)
    elif tuple(out.shape) != tuple(shape) or out.dtype != x.dtype or out.device != x.device:
        raise ValueError(f"halo of {tuple(x.shape)} {x.dtype} on {x.device}: out is "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}, want "
                         f"{tuple(shape)}")
    out.narrow(-2, halo, rows).copy_(x)
    ops, landed = [], []
    # my first rows are the bottom halo of the rank above, my last rows the
    # top halo of the rank below
    for peer, mine, theirs in ((idx - 1, 0, 0), (idx + 1, rows - halo, rows + halo)):
        if not 0 <= peer < n:
            continue
        peer = dist.get_global_rank(group, peer)
        dst = out.narrow(-2, theirs, halo)
        buf = dst if dst.is_contiguous() else \
            torch.empty(dst.shape, dtype=dst.dtype, device=dst.device)
        ops += [dist.P2POp(dist.isend, x.narrow(-2, mine, halo).contiguous(), peer, group),
                dist.P2POp(dist.irecv, buf, peer, group)]
        landed.append((dst, buf))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for dst, buf in landed:
        if buf is not dst:
            dst.copy_(buf)
    return out


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
