"""The glue and subsample kernels' wrappers (ops/kernels/glue.py and
ops/kernels/colorspace.py) on the CPU, where they run their plain versions,
against the JAX package's symbolize_frame and subsample_420.

JAX's symbolize_frame forms the glue's outputs inside its jitted step: on
its acsym-kernel path it builds the kernel's operands (zmod, and ``small``,
the non-AC slots with zeros at the AC slots) and hands them to
ac_slot_grid_pallas.  The tests put a stand-in for that kernel in its place
which returns one operand as it is, so the JAX function gives its own zmod,
or its header rows over its ``small``, and these are compared with the
port's exactly (tolerance 0, as uint32), dead codes at zero-length slots
included.  Inputs are made with numpy from a seed."""
import contextlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from fpga_mpeg2_encoder_tpu.ops import colorspace as jcolorspace
from fpga_mpeg2_encoder_tpu.ops import entropy as jentropy
from fpga_mpeg2_encoder_tpu.ops.pallas import acsym as jacsym
from fpga_mpeg2_encoder_tpu_torch.ops import colorspace
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import _build
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import colorspace as k_colorspace
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import glue as k_glue
from fpga_mpeg2_encoder_tpu_torch.utils.testdata import STACK_LAYOUTS, stack_layout

Q_LEVEL = 2
# (i_frame, frame_no): an I-frame at 0; P-frames across a minute's rollover
# (1440 frames), an hour's (86 400) and past the hour's clamp at 63
FRAMES = [(0, 0), (3, 1439), (1, 1440), (5, 86399), (2, 86400), (0, 64 * 86400 + 1234)]


@contextlib.contextmanager
def _operand_of_jax(which):
    """JAX's symbolize_frame on its acsym-kernel path, the kernel replaced
    by a function that returns its operand ``which`` ("small" or "zmod")."""
    saved = (jacsym.ac_slot_grid_pallas, jentropy._ACSYM_IMPL)
    jacsym.ac_slot_grid_pallas = (lambda zmod, small: small) if which == "small" \
        else (lambda zmod, small: zmod)
    jentropy._ACSYM_IMPL = "pallas"
    try:
        yield
    finally:
        jacsym.ac_slot_grid_pallas, jentropy._ACSYM_IMPL = saved


_JITS = {}


def _jax_glue(which, include_headers, zig, inter, mvx, mvy, i_frame, frame_no, first_row):
    """JAX's zmod (which="zmod"), or its ``small`` under its header rows
    (which="small", include_headers), as uint32.  The GOP position, frame
    number and first row are traced, so one compile serves every frame."""
    key = (which, include_headers)
    if key not in _JITS:
        _JITS[key] = jax.jit(lambda z, i, x, y, f, n, r: jentropy.symbolize_frame(
            z, i, x, y, f, n, Q_LEVEL, first_row=r, include_headers=include_headers).slots)
    with _operand_of_jax(which):      # a retrace (a new shape) sees the stand-in too
        out = _JITS[key](jnp.asarray(zig), jnp.asarray(inter), jnp.asarray(mvx),
                         jnp.asarray(mvy), jnp.int32(i_frame), jnp.int32(frame_no),
                         jnp.int32(first_row))
    return np.asarray(out).view(np.uint32)


def _operands(nby, nbx, seed, kind):
    """quant_zig, inter, mvx, mvy from a seed.  "mixed": sparse levels, DCs
    of every small size, all-zero tiles and inter DCs of 0 and +-1, intra
    macroblocks among inter ones; "extreme": DCs at +-2047 and +-2048 (DC
    differences up to 4095, size 12), escape-coded inter DCs and MVs at the
    int32 range's ends; "zero": all-zero coefficients, every macroblock
    inter; "intra": every macroblock intra."""
    rng = np.random.default_rng(seed)
    zig = np.zeros((nby, nbx, 6, 64), np.int32)
    m = rng.random(zig.shape) < 0.1
    zig[m] = rng.integers(-60, 61, m.sum())
    zig[..., 0] = rng.integers(-300, 301, (nby, nbx, 6))
    zig[rng.random((nby, nbx, 6)) < 0.2] = 0                      # all-zero tiles
    few = rng.random((nby, nbx, 6)) < 0.3
    zig[..., 0][few] = rng.choice([-1, 0, 1], few.sum())
    inter = rng.random((nby, nbx)) < 0.6
    mvx = rng.integers(-16, 17, (nby, nbx)).astype(np.int32)
    mvy = rng.integers(-16, 17, (nby, nbx)).astype(np.int32)
    if kind == "extreme":
        zig[..., 0] = rng.choice([-2048, -2047, -41, -40, 39, 40, 2047, 1], (nby, nbx, 6))
        mvx[0] = np.iinfo(np.int32).max
        mvx[-1] = np.iinfo(np.int32).min
        mvy[:, ::2] = -16
        mvy[:, 1::2] = 15
    elif kind == "zero":
        zig[:] = 0
        inter[:] = True
    elif kind == "intra":
        inter[:] = False
    return zig, inter, mvx, mvy


def _port_glue(zig, inter, mvx, mvy, i_frame, frame_no, first_row, header_slots):
    before = dict(_build.LAUNCHES)
    out = k_glue.symbol_glue(torch.from_numpy(zig), torch.from_numpy(inter),
                             torch.from_numpy(mvx), torch.from_numpy(mvy), i_frame,
                             frame_no, Q_LEVEL, first_row, header_slots)
    assert _build.LAUNCHES == before            # the plain version: no launch
    return out


def _u32(t):
    assert t.dtype == torch.int32
    return t.numpy().view(np.uint32)


def _check(nby, nbx, seed, kind, i_frame, frame_no, first_row, include_headers):
    zig, inter, mvx, mvy = _operands(nby, nbx, seed, kind)
    s = 3 + 394 * nbx
    zmod, small, hdr = _port_glue(zig, inter, mvx, mvy, i_frame, frame_no, first_row,
                                  s if include_headers else None)
    args = (zig, inter, mvx, mvy, i_frame, frame_no, first_row)
    want_small = _jax_glue("small", include_headers, *args)
    got_small = _u32(small) if hdr is None else np.concatenate([_u32(hdr), _u32(small)])
    assert got_small.shape == want_small.shape
    assert np.array_equal(got_small, want_small)
    want_zmod = _jax_glue("zmod", False, *args)
    assert np.array_equal(_u32(zmod), want_zmod)
    return got_small


@pytest.mark.parametrize("include_headers", [True, False])
@pytest.mark.parametrize("first_row", [0, 7])
@pytest.mark.parametrize("i_frame,frame_no", FRAMES)
@pytest.mark.parametrize("nbx", [4, 26])
def test_glue_matches_jax(nbx, i_frame, frame_no, first_row, include_headers):
    """nbx 26 (416 px) is where the JAX acsym kernel once corrupted slots;
    the frames cross the timecode's rollovers and the hour's clamp."""
    grid = _check(3, nbx, nbx + i_frame, "mixed", i_frame, frame_no, first_row,
                  include_headers)
    assert ((grid >> 27) >= 16).any() and (grid >= 1 << 31).any()


@pytest.mark.parametrize("kind", ["extreme", "zero", "intra"])
@pytest.mark.parametrize("i_frame", [0, 1])
def test_glue_content_matches_jax(kind, i_frame):
    """DCs and MVs at their extremes (size-12 DC differences, escaped inter
    DCs, MV differences that wrap), all-zero frames, intra macroblocks in a
    P-frame (type 0x23)."""
    grid = _check(4, 4, 40 + i_frame, kind, i_frame, 100, 3, True)
    mbs = grid[2:, 3:].reshape(4, 4, 394)
    if kind == "intra" and i_frame:
        assert (mbs[..., 0] == (0x23 | 6 << 27)).all()
    if kind == "extreme":
        assert ((mbs[..., 4::65][..., :6] >> 27) == 24).any()       # escaped inter DCs
        zig, inter = _operands(4, 4, 40 + i_frame, kind)[:2]
        dc = zig[..., 0].astype(np.int64)
        pub = np.where(inter[..., None], 0, dc)[..., :4].reshape(4, 16)
        pred = np.concatenate([np.zeros((4, 1), np.int64), pub[:, :-1]], 1).reshape(4, 4, 4)
        assert (np.abs(dc[..., :4] - pred)[~inter] >= 2048).any()   # DC size 12


@pytest.mark.parametrize("i_frame,frame_no", FRAMES)
def test_glue_header_rows_alone_match_jax(i_frame, frame_no):
    """The frame tail's launch (no macroblock): the two header rows, 16
    slots wide, as JAX's _header_rows packs them."""
    got = k_glue.header_rows(torch.tensor(i_frame, dtype=torch.int32), frame_no, 16, "cpu")
    codes, lens = jentropy._header_rows(jnp.int32(i_frame), jnp.int32(frame_no), 16)
    want = np.asarray(jentropy.pack_slot(codes, lens))
    assert np.array_equal(_u32(got), want)


def test_glue_wrapper_checks_devices():
    """Mixed devices or a GOP tensor elsewhere raise; nothing moves."""
    zig, inter, mvx, mvy = (torch.from_numpy(a) for a in _operands(1, 2, 0, "mixed"))
    with pytest.raises(ValueError, match="several devices"):
        k_glue.symbol_glue(zig, inter.to("meta"), mvx, mvy, 0, 0, 2)
    with pytest.raises(ValueError, match="GOP state"):
        k_glue.symbol_glue(zig, inter, mvx, mvy, torch.zeros((2,), dtype=torch.int32), 0, 2)


def _planes(h, w, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return [rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(3)]
    # 2x2 cells whose horizontal-then-vertical means differ from the other
    # order's and from one mean of four: (2, 0 / 1, 1) and extremes
    cells = np.array([[[2, 0], [1, 1]], [[255, 254], [254, 254]], [[0, 255], [255, 0]],
                      [[1, 0], [0, 0]]], np.uint8)
    pick = rng.integers(0, len(cells), (h // 2, w // 2))
    plane = cells[pick].transpose(0, 2, 1, 3).reshape(h, w)
    return [plane, plane.copy(), np.ascontiguousarray(plane[::-1])]


@pytest.mark.parametrize("impl", ["strided", "bitcast"])
@pytest.mark.parametrize("kind", ["noise", "cells"])
@pytest.mark.parametrize("w,h", [(48, 32), (416, 64), (720, 576)])
def test_subsample_matches_jax(w, h, kind, impl, monkeypatch):
    """Chroma widths 24 and 360 are 8 mod 16, 208 is a multiple of 16; JAX's
    two formulations of the same function."""
    y, u, v = _planes(h, w, w + h, kind)
    before = dict(_build.LAUNCHES)
    got = k_colorspace.subsample_420(*(torch.from_numpy(p) for p in (y, u, v)))
    assert _build.LAUNCHES == before
    monkeypatch.setattr(jcolorspace, "_SUBSAMPLE_IMPL", impl)
    want = jcolorspace.subsample_420(jnp.asarray(y), jnp.asarray(u), jnp.asarray(v))
    for g, wnt in zip(got, want):
        assert g.dtype == torch.uint8 and g.shape == wnt.shape
        assert np.array_equal(g.numpy(), np.asarray(wnt))
    if kind == "cells":
        mean4 = (u.reshape(h // 2, 2, w // 2, 2).astype(int).sum((1, 3)) + 2) >> 2
        assert not np.array_equal(got[1].numpy(), mean4)


@pytest.mark.parametrize("layout", STACK_LAYOUTS)
def test_subsample_stack_plain_reads_frame_k(layout):
    """The stack entry's plain version at each frame k of (F, H, W) stacks
    in each layout: frame k's Y plane copied into the step's plane, and
    subsample_420 of frame k, which equals JAX's; no launch counted.  The
    plane table holds each stack's address and frame stride."""
    w, h, f = 48, 32, 3
    frames = [_planes(h, w, 5 + i, "cells" if i % 2 else "noise") for i in range(f)]
    stacks = stack_layout([torch.from_numpy(np.stack(p)) for p in zip(*frames)], layout)
    table = torch.zeros(6, dtype=torch.int64)
    k_colorspace.plane_table(stacks, table)
    assert table.tolist() == [v for s in stacks for v in (s.data_ptr(), s.stride(0))]
    for k in range(f):
        y = torch.zeros((h, w), dtype=torch.uint8)
        before = dict(_build.LAUNCHES)
        got = k_colorspace.subsample_420_stack(stacks, table, torch.tensor([k]), y)
        assert _build.LAUNCHES == before and got[0] is y
        want = jcolorspace.subsample_420(*(jnp.asarray(p) for p in frames[k]))
        for g, wnt in zip(got, want):
            assert g.dtype == torch.uint8 and np.array_equal(g.numpy(), np.asarray(wnt)), k
        assert all(torch.equal(g, p) for g, p in
                   zip(got, colorspace.subsample_420(*(s[k] for s in stacks))))


def test_subsample_stack_in_place_rule():
    """The stack entry reads a stack in place when each frame's rows are
    contiguous and its data and frame stride are multiples of 16 bytes:
    slices at any frame, a plane of an (F, 3, H, W) stack, a frame repeated
    (stride 0), a batch's (B, F, H, W) stack and a channel slice of one;
    not a column-strided view, a transposed one, data 8 bytes off, a frame
    stride of H·W + 8, a channel stride of F·H·W + 8."""
    f, h, w = 3, 32, 48
    buf = torch.zeros(f * h * w + 64, dtype=torch.uint8)
    assert buf.data_ptr() % 16 == 0
    whole = buf[:f * h * w].view(f, h, w)
    batch = torch.zeros((2, f + 1, h, w), dtype=torch.uint8)
    for s in (whole, whole[1:], torch.zeros((f, 3, h, w), dtype=torch.uint8)[:, 2],
              whole[0].expand(f, h, w), batch, batch[:, 1:]):
        assert k_colorspace.in_place(s)
    for s in (torch.zeros((f, h, 2 * w), dtype=torch.uint8)[..., ::2],
              torch.zeros((f, w, h), dtype=torch.uint8).transpose(1, 2),
              buf[8:8 + f * h * w].view(f, h, w), buf.as_strided((f, h, w), (h * w + 8, w, 1)),
              torch.zeros(2 * f * h * w + 8, dtype=torch.uint8).as_strided(
                  (2, f, h, w), (f * h * w + 8, h * w, w, 1))):
        assert not k_colorspace.in_place(s)
