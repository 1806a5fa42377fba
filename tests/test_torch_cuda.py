"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file imports
neither jax nor the JAX package, so it also runs on a machine that has only
PyTorch; there tests/conftest.py (which imports jax) is left out:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

All equality is exact: this is an integer codec.  The shapes are small
(64x64, 416x64 with nbx = 26, 1920x32 with nbx = 120, and 2048x32 with
nbx = 128, the widest frame), but for the motion kernels, which also run
at the cells' 720x576 and 1920x1152; chip_smoke.py covers 1920x1152.  The transform
kernel's stages are also run alone on int32 tiles (transform_stage), to
reach the wraps and clamps that pixels never reach.  The acsym and pack_slots
kernels also get made-up operands that reach every run, escape, tile edge,
look-back chain and cap.  Slots are int32 holding the uint32 pattern.
"""
import contextlib
import gc
import json
import re
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from fpga_mpeg2_encoder_tpu_torch import Encoder, EncoderConfig, SequenceConfig
from fpga_mpeg2_encoder_tpu_torch.core import tables
from fpga_mpeg2_encoder_tpu_torch.core.bitstream import (
    BitWriter, SEQUENCE_END_CHUNKS, sequence_header_chunks)
from fpga_mpeg2_encoder_tpu_torch.golden import encoder as G
from fpga_mpeg2_encoder_tpu_torch.ops import bitpack, colorspace, dct, entropy, motion
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import _build
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import acsym as k_acsym
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import carry as k_carry
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import colorspace as k_colorspace
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import glue as k_glue
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import me as k_me
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import pack as k_pack
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import transform as k_tf
from fpga_mpeg2_encoder_tpu_torch.models import encoder as M
from fpga_mpeg2_encoder_tpu_torch.models.encoder import encode_frame_core
from fpga_mpeg2_encoder_tpu_torch.parallel.dp import BatchEncoder, encode_gops_batched
from fpga_mpeg2_encoder_tpu_torch.parallel import spatial as S
from fpga_mpeg2_encoder_tpu_torch.parallel.mesh import make_mesh, make_mesh2d
from fpga_mpeg2_encoder_tpu_torch.parallel.spatial import band_with_halo, frame_tail, make_local_step
from fpga_mpeg2_encoder_tpu_torch.runtime import graphs
from fpga_mpeg2_encoder_tpu_torch.utils import profiling
from fpga_mpeg2_encoder_tpu_torch.utils.testdata import (
    GOLDEN_MATRIX, STACK_LAYOUTS, chroma_maps, random_sequence, stack_layout, video)

pytestmark = pytest.mark.cuda
MAIN_PATH = ("subsample", "me_fused", "transform", "glue", "acsym", "pack_slots", "merge_rows")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _frame_on(dev, w, h, kind="pan"):
    """Two subsampled frames on ``dev`` and the P-frame's motion result."""
    f0, f1 = video(w, w, h, 2, kind)
    p0 = colorspace.subsample_420(*(torch.as_tensor(p, device=dev) for p in f0))
    p1 = colorspace.subsample_420(*(torch.as_tensor(p, device=dev) for p in f1))
    return p1, motion.estimate_and_predict_planes(*p1, *p0, False, 6, 3)


def _launched(name, fn):
    before = _build.LAUNCHES[name]
    out = fn()
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 1
    return out


@pytest.mark.parametrize("w", [64, 416])
@pytest.mark.parametrize("q_level", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["pan", "noise"])
def test_transform_kernel_equals_plain(dev, w, q_level, kind):
    (y, u, v), mr = _frame_on(dev, w, 64, kind)
    gen = np.random.default_rng(q_level)
    for inter in (mr.inter, torch.as_tensor(gen.random(mr.inter.shape) < 0.5, device=dev),
                  torch.zeros_like(mr.inter)):
        args = (y, u, v, mr.pred_y, mr.pred_u, mr.pred_v, inter)
        got = _launched("transform", lambda: k_tf.transform_recon(*args, q_level))
        for g, want in zip(got, dct.transform_recon(*args, q_level)):
            assert g.dtype == want.dtype and torch.equal(g, want)


def _stage_equal(dev, stage, x, inter=None, q_level=1):
    """transform_stage on the card (the transform kernel's device code)
    against ops/dct.py's stage on the same card."""
    x = torch.as_tensor(x, dtype=torch.int32, device=dev)
    if inter is not None:
        inter = torch.as_tensor(inter, device=dev)
    got = k_tf.transform_stage(stage, x, inter, q_level)
    torch.cuda.synchronize()
    want = k_tf.transform_stage(stage, x.cpu(), None if inter is None else inter.cpu(),
                                q_level)
    for g, w in zip(got if stage == "quantize" else (got,),
                    want if stage == "quantize" else (want,)):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("q_level", [1, 2, 3, 4])
def test_transform_intra_quantiser_exhaustive(dev, q_level):
    """The kernel's division-free intra quantiser against the plain
    floor division: |f| chosen so that (|f| + off) & 0xFFFF sweeps every
    16-bit value at every position, so every numerator is reached."""
    a = np.arange(65536, dtype=np.int64)[:, None]
    wq = np.asarray(tables.INTRA_Q, np.int64).reshape(-1)
    off = (wq * ((3 << q_level) + 2)) >> 3
    f = ((a - off[None, :]) & 0xFFFF).reshape(-1, 8, 8)
    for sign in (1, -1):
        _stage_equal(dev, "quantize", sign * f, np.zeros(len(f), bool), q_level)


@pytest.mark.parametrize("q_level", [1, 2, 3, 4])
def test_transform_stages_equal_plain(dev, q_level):
    """Each stage of the kernel on values that pixels never give: the FDCT's
    17-bit wrap, the quantiser's 16-bit wraps and clamps, the dequantiser's
    clamps, the IDCT's 18-bit truncation, its 32-bit wrap and its clamp."""
    rng = np.random.default_rng(q_level)
    _stage_equal(dev, "fdct", rng.integers(-4095, 4096, (4096, 8, 8)))
    f = rng.integers(-70000, 70001, (4096, 8, 8))
    _stage_equal(dev, "quantize", f, rng.random(4096) < 0.5, q_level)
    iq = rng.choice(np.array([-2047, 2047, -2048, 0, 1 << 20, -(1 << 20)]), (2048, 8, 8))
    _stage_equal(dev, "idct", np.concatenate([iq, rng.integers(-2047, 2048, (2048, 8, 8))]))


@pytest.mark.parametrize("w", [64, 416])
@pytest.mark.parametrize("kind", ["pan", "noise"])
def test_acsym_kernel_equals_plain(dev, w, kind):
    (y, u, v), mr = _frame_on(dev, w, 64, kind)
    qzig = dct.transform_recon(y, u, v, mr.pred_y, mr.pred_u, mr.pred_v, mr.inter, 1)[0]
    for i_frame in (0, 1):
        zmod, small = entropy.ac_inputs(qzig, mr.inter, mr.mvx, mr.mvy, i_frame, 1)
        got = _launched("acsym", lambda: k_acsym.ac_slot_grid(zmod, small))
        assert got.dtype == torch.int32 and torch.equal(got, entropy.ac_slot_grid(zmod, small))


def _acsym_operands(nby, nbx, seed):
    """zmod and small for acsym that reach every case: per tile, runs of 0,
    31, 32 and 62 and runs across the two 32-bit halves of the emit mask;
    levels just inside and outside each B.14 region and the escapes +-2047;
    all-zero and all-nonzero tiles; the position-0 emit flag on and off
    (I-frame tiles set it); the rest random.  small carries garbage at the
    AC slots, which the grid must not keep."""
    rng = np.random.default_rng(seed)
    z = np.zeros((nby * nbx * 6, 64), np.int64)
    # (positions, levels) of one tile each; position 0 is the emit flag
    cases = [
        ([0, 32], [1, 5]),                     # run 31 from the flag
        ([0, 33], [1, 1]),                     # run 32: escape
        ([0, 63], [1, -1]),                    # run 62, the longest
        ([63], [2]),                           # run 62 without the flag: escape
        ([31, 32], [3, -3]),                   # run 0 across the halves
        ([20, 45], [1, 1]),                    # run 24 across the halves
        ([5], [1]), ([0, 5], [1, 1]),          # the flag decides run 5 or 4
        ([0, 1], [1, 40]), ([0, 1], [1, 41]), ([0, 1], [1, -40]),  # run 0 region
        ([0, 1], [1, -41]), ([1], [40]),
        ([0, 2], [1, 18]), ([0, 2], [1, 19]), ([0, 2], [1, -18]),  # run 1 region
        ([0, 10], [1, 2]), ([0, 10], [1, 3]), ([0, 18], [1, -2]),  # runs 8-16
        ([0, 20], [1, 1]), ([0, 20], [1, 2]), ([0, 32], [1, -1]),  # runs 17-31
        ([0, 9], [1, 8]), ([0, 9], [1, 9]), ([0, 4], [1, 6]),      # runs <= 7
        ([1, 2], [2047, -2047]), ([63], [-2047]),                   # 12-bit escapes
        (list(range(64)), list(rng.integers(1, 3, 64))),            # all nonzero
        ([], []),                                                   # all zero
    ]
    tiles = rng.permutation(len(z))
    for k, (pos, lev) in zip(tiles, cases * (len(z) // len(cases) // 3 + 1)):
        z[k, pos] = lev
    rest = tiles[len(cases) * (len(z) // len(cases) // 3 + 1):]
    m = rng.random((len(rest), 64)) < 0.2
    z[rest] = np.where(m, rng.choice([-2047, -300, -41, -3, -1, 1, 2, 17, 40, 2047], (len(rest), 64)), 0)
    z[rest, 0] = rng.random(len(rest)) < 0.5
    z[:, 0] = z[:, 0] != 0
    s = 3 + 394 * nbx
    small = rng.integers(-(1 << 31), 1 << 31, (nby, s), dtype=np.int64).astype(np.int32)
    return (torch.as_tensor(z.astype(np.int32).reshape(nby, nbx * 384)),
            torch.as_tensor(small))


@pytest.mark.parametrize("nby,nbx", [(5, 1), (3, 26), (2, 120), (7, 3)])
def test_acsym_kernel_cases(dev, nby, nbx):
    """Every run, escape and B.14 edge, at nbx 1, 26 and 120 and a frame
    whose macroblock count is no multiple of the block's 4; most blocks'
    spans start off a 16-byte boundary."""
    zmod, small = (t.to(dev) for t in _acsym_operands(nby, nbx, nbx))
    got = _launched("acsym", lambda: k_acsym.ac_slot_grid(zmod, small))
    want = entropy.ac_slot_grid(zmod, small)
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    lens = entropy.slot_len(want)
    assert bool((lens == 24).any()) and bool((want < 0).any())


# ---- the symbol glue and subsample kernels ------------------------------------

GOP_FRAMES = [(0, 0), (3, 1439), (1, 1440), (5, 86399), (2, 86400), (0, 64 * 86400 + 1234)]


def _glue_equal(q, inter, mvx, mvy, i_frame, frame_no, q_level, first_row, header_slots):
    """The glue kernel (one launch) against entropy.ac_inputs and
    _header_rows on the same card."""
    got = _launched("glue", lambda: k_glue.symbol_glue(q, inter, mvx, mvy, i_frame, frame_no,
                                                       q_level, first_row, header_slots))
    zmod, small = entropy.ac_inputs(q, inter, mvx, mvy, i_frame, q_level, first_row)
    assert got[0].dtype == got[1].dtype == torch.int32
    assert got[0].data_ptr() % 16 == 0                       # acsym's vector loads
    assert torch.equal(got[0], zmod) and torch.equal(got[1], small)
    if header_slots is None:
        assert got[2] is None
    else:
        assert torch.equal(got[2], entropy._header_rows(i_frame, frame_no, header_slots,
                                                        q.device))
    return got


@pytest.mark.parametrize("w,h", [(1920, 1152), (720, 576), (416, 64), (64, 64)])
@pytest.mark.parametrize("i_frame", [0, 1])
def test_glue_kernel_equals_plain(dev, w, h, i_frame):
    """The glue kernel on a frame's real operands (the subsample, motion and
    transform kernels' outputs), I and P, the whole frame with its header
    rows and a band of rows from first_row 5 without them."""
    f0, f1 = video(w + h, w, h, 2)
    p0 = k_colorspace.subsample_420(*(torch.as_tensor(p, device=dev) for p in f0))
    p1 = k_colorspace.subsample_420(*(torch.as_tensor(p, device=dev) for p in f1))
    mr = k_me.estimate_and_predict_planes(*p1, *p0, i_frame == 0, 6, 3)
    q = k_tf.transform_recon(*p1, mr.pred_y, mr.pred_u, mr.pred_v, mr.inter, 2)[0]
    s = 3 + 394 * (w // 16)
    _glue_equal(q, mr.inter, mr.mvx, mr.mvy, i_frame, 7 + i_frame, 2, 0, s)
    rows = slice(1, h // 16)
    band = [t[rows].contiguous() for t in (q, mr.inter, mr.mvx, mr.mvy)]
    _glue_equal(*band, torch.tensor(i_frame, dtype=torch.int32, device=dev), 7, 4, 5, None)


def _glue_operands(dev, nby, nbx, seed, kind):
    """quant_zig, inter, mvx, mvy on ``dev``: "mixed" (sparse levels, DCs
    of every small size, all-zero tiles, inter DCs of 0 and +-1, intra
    macroblocks among inter ones), "extreme" (DCs at +-2047 and +-2048, so
    DC differences of size 12; escaped inter DCs; B.14's run-0 edge at
    +-40, +-41; MVs at the int32 range's ends and differences of +-16
    and +-31), "zero" (every macroblock inter and empty) or "intra"."""
    rng = np.random.default_rng(seed)
    zig = np.zeros((nby, nbx, 6, 64), np.int32)
    m = rng.random(zig.shape) < 0.1
    zig[m] = rng.integers(-60, 61, m.sum())
    zig[..., 0] = rng.integers(-300, 301, (nby, nbx, 6))
    zig[rng.random((nby, nbx, 6)) < 0.2] = 0
    few = rng.random((nby, nbx, 6)) < 0.3
    zig[..., 0][few] = rng.choice([-1, 0, 1], few.sum())
    inter = rng.random((nby, nbx)) < 0.6
    mvx = rng.integers(-16, 17, (nby, nbx)).astype(np.int32)
    mvy = rng.integers(-16, 17, (nby, nbx)).astype(np.int32)
    if kind == "extreme":
        zig[..., 0] = rng.choice([-2048, -2047, -41, -40, 40, 41, 2047, -1, 1], (nby, nbx, 6))
        mvx[0] = np.iinfo(np.int32).max
        mvx[-1] = np.iinfo(np.int32).min
        mvy[:, ::2] = -16
        mvy[:, 1::2] = 15
    elif kind == "zero":
        zig[:] = 0
        inter[:] = True
    elif kind == "intra":
        inter[:] = False
    return tuple(torch.as_tensor(a, device=dev) for a in (zig, inter, mvx, mvy))


@pytest.mark.parametrize("nby,nbx", [(5, 1), (3, 26), (2, 120), (7, 3), (1, 128)])
@pytest.mark.parametrize("kind", ["mixed", "extreme", "zero", "intra"])
def test_glue_kernel_cases(dev, nby, nbx, kind):
    """Made-up operands at nbx 1 (a slice header before every macroblock),
    26, 120, 128 and 3 (7 x 3 is no multiple of the block's 8 macroblocks),
    over the GOP positions and frame numbers that cross the timecode's
    rollovers and the hour's clamp, with the header rows (their width odd,
    so their tail is two words) and without."""
    ops = _glue_operands(dev, nby, nbx, 10 * nby + nbx, kind)
    s = 3 + 394 * nbx
    for k, (i_frame, frame_no) in enumerate(GOP_FRAMES):
        gop = torch.tensor(i_frame, dtype=torch.int32, device=dev) if k % 2 else i_frame
        got = _glue_equal(*ops, gop, frame_no, 1 + k % 4, 3 * k, s if k % 3 else None)
    lens = entropy.slot_len(got[1])
    if kind == "extreme":
        assert bool((lens == 24).any())


@pytest.mark.parametrize("s", [16, 3 + 394 * 4, 3 + 394 * 120])
def test_glue_kernel_header_rows_alone(dev, s):
    """The frame tail's launch (no macroblock): the header rows for I and P
    frames across the timecode's rollovers and the hour's clamp."""
    for i_frame, frame_no in GOP_FRAMES + [(1, 2**31 - 1)]:
        got = _launched("glue", lambda: k_glue.header_rows(i_frame, frame_no, s, dev))
        assert torch.equal(got, entropy._header_rows(i_frame, frame_no, s, dev))


def test_graph_glue_reads_the_gop_state_at_replay(dev):
    """A captured glue launch reads the GOP position and the frame number
    from device memory: changed between replays, each replay's slots and
    header rows equal the plain version's for the new values, one launch
    counted a replay."""
    ops = _glue_operands(dev, 3, 26, 5, "mixed")
    i_t = torch.zeros((), dtype=torch.int32, device=dev)
    f_t = torch.zeros((), dtype=torch.int32, device=dev)
    s = 3 + 394 * 26
    step = graphs.Step(lambda: k_glue.symbol_glue(*ops, i_t, f_t, 2, 4, s), dev)
    for i_frame, frame_no in GOP_FRAMES:
        i_t.fill_(i_frame)
        f_t.fill_(frame_no)
        _build.reset_launches()
        zmod, small, hdr = step()
        torch.cuda.synchronize()
        assert _build.LAUNCHES["glue"] == 1
        want = entropy.ac_inputs(*ops, i_frame, 2, 4)
        assert torch.equal(zmod, want[0]) and torch.equal(small, want[1])
        assert torch.equal(hdr, entropy._header_rows(i_frame, frame_no, s, dev))


def _subsample_planes(dev, w, h, kind):
    rng = np.random.default_rng(w + h)
    if kind == "noise":
        planes = [rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(3)]
    else:
        # 2x2 cells whose horizontal-then-vertical means differ from the
        # other order's and from one mean of four
        cells = np.array([[[2, 0], [1, 1]], [[255, 254], [254, 254]], [[0, 255], [255, 0]],
                          [[1, 0], [0, 0]]], np.uint8)
        plane = cells[rng.integers(0, 4, (h // 2, w // 2))].transpose(0, 2, 1, 3).reshape(h, w)
        planes = [plane, plane, np.ascontiguousarray(plane[::-1])]
    return [torch.as_tensor(p, device=dev) for p in planes]


@pytest.mark.parametrize("w,h", [(1920, 1152), (720, 576), (416, 64), (64, 64), (48, 32)])
@pytest.mark.parametrize("kind", ["noise", "cells", "video"])
def test_subsample_kernel_equals_plain(dev, w, h, kind):
    """Both chroma planes in one launch against the plain version; chroma
    widths 360 and 24 are 8 mod 16.  Y is passed through as it is."""
    planes = ([torch.as_tensor(p, device=dev) for p in video(w, w, h, 1)[0]]
              if kind == "video" else _subsample_planes(dev, w, h, kind))
    got = _launched("subsample", lambda: k_colorspace.subsample_420(*planes))
    want = colorspace.subsample_420(*planes)
    assert got[0] is planes[0]
    for g, wnt in zip(got[1:], want[1:]):
        assert g.dtype == torch.uint8 and g.is_contiguous() and torch.equal(g, wnt)


@pytest.mark.parametrize("w,h", [(720, 576), (416, 64), (48, 32)])
@pytest.mark.parametrize("layout", [x for x in STACK_LAYOUTS if x != "strided"])
def test_subsample_stack_kernel_equals_plain(dev, layout, w, h):
    """The stack entry, one launch a frame, reads frame k of (F, H, W)
    stacks through the plane table and k in device memory, at every k, in
    each layout the kernel reads in place (a slice whose frame before the
    first differs; push_chunk's planes; three frame strides): its chroma
    equals the plain subsample_420 of frame k, and its Y plane frame k's,
    written into a plane that held something else."""
    f = 3
    frames = [_subsample_planes(dev, w, h, "noise" if i != 1 else "cells") for i in range(f)]
    stacks = stack_layout([torch.stack(p) for p in zip(*frames)], layout)
    table = torch.empty(6, dtype=torch.int64, device=dev)
    k_colorspace.plane_table(stacks, table)
    k = torch.zeros(1, dtype=torch.int64, device=dev)
    for i in range(f):
        k.fill_(i)
        y = torch.full((h, w), 7, dtype=torch.uint8, device=dev)
        got = _launched("subsample", lambda: k_colorspace.subsample_420_stack(stacks, table,
                                                                               k, y))
        want = colorspace.subsample_420(*frames[i])
        assert got[0] is y
        for g, wnt in zip(got, want):
            assert g.dtype == torch.uint8 and g.is_contiguous() and torch.equal(g, wnt), i


def test_glue_subsample_wrappers_check_inputs(dev):
    q, inter, mvx, mvy = _glue_operands(dev, 2, 3, 0, "mixed")
    odd = torch.zeros(q.numel() + 1, dtype=torch.int32, device=dev)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):                # 16-byte loads
        k_glue.symbol_glue(odd, inter, mvx, mvy, 0, 0, 2)
    with pytest.raises(TypeError, match="dtype"):
        k_glue.symbol_glue(q, inter, mvx.to(torch.int64), mvy, 0, 0, 2)
    with pytest.raises(ValueError, match="GOP state"):
        k_glue.symbol_glue(q, inter, mvx, mvy, torch.zeros(2, dtype=torch.int32,
                                                           device=dev), 0, 2)
    y = torch.zeros((32, 48), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        k_colorspace.subsample_420(y, y[:, :40], y[:, :40])
    flat = torch.zeros(32 * 48 + 1, dtype=torch.uint8, device=dev)[1:].view(32, 48)
    with pytest.raises(ValueError, match="aligned"):
        k_colorspace.subsample_420(y, flat, y)
    with pytest.raises(ValueError, match="several devices"):
        k_colorspace.subsample_420(y, y.cpu(), y)
    table = torch.zeros(6, dtype=torch.int64, device=dev)
    k = torch.zeros(1, dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="multiple of 16"):
        k_colorspace.subsample_420_stack((y[None],) * 3, table, k, y[:, :40])
    with pytest.raises(ValueError, match="aligned"):
        k_colorspace.subsample_420_stack((y[None],) * 3, table, k, flat)
    with pytest.raises(TypeError, match="dtype"):
        k_colorspace.subsample_420_stack((y[None],) * 3, table.int(), k, y)


def _slots(dev, r, s, seed, density=0.5, dirty=False):
    """Mixed-length symbols as int32 slots; a third of the zero-length slots
    carry a dead nonzero code, which must emit nothing; ``dirty`` also sets
    code bits above each length, which the mask by length must drop."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 25, (r, s)).astype(np.int64)
    lens[rng.random((r, s)) >= density] = 0
    codes = rng.integers(0, 1 << 24, (r, s)).astype(np.int64) & ((1 << lens) - 1)
    dead = (lens == 0) & (rng.random((r, s)) < 0.33)
    codes[dead] = rng.integers(1, 1 << 25, dead.sum())
    if dirty:
        codes |= rng.integers(0, 1 << 27, (r, s)) & ~((1 << lens) - 1)
    return torch.as_tensor((codes | (lens << 27)).astype(np.uint32).view(np.int32), device=dev)


def _pack_equal(slots, cap):
    got = _launched("pack_slots", lambda: k_pack.pack_slots(slots, cap))
    want = bitpack.pack_slots(slots, cap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    return want


def _row_bits_max(slots):
    """The longest row's byte-aligned bits."""
    return bitpack.align_bytes(entropy.slot_len(slots).to(torch.int64).sum(1)).max()


TILE = k_pack.TILE


@pytest.mark.parametrize("s", [100, 3 * TILE - 3, 40 * TILE - 3])
@pytest.mark.parametrize("density", [0.02, 0.5])
def test_pack_slots_tiles(dev, s, density):
    """Rows of 1, 3 and 40 tiles (three rows, each at another alignment in
    the flattened grid), sparse as a real frame and dense, with dead and
    dirty codes; caps that hold every row, then ones that cut each row mid
    row, inside a word."""
    slots = _slots(dev, 3, s, s, density, dirty=True)
    _, bits, _ = _pack_equal(slots, int(_row_bits_max(slots)) // 32 + 2)
    assert bool((bits % 32 != 0).any())
    _pack_equal(slots, int(bits.min()) // 64 + 1)


def _sparse_rows(dev, r, s, sym, seed):
    """Rows with one symbol (code, len) per tile, at a random slot of it:
    many tiles share one word, and every tile's bits fit in one word."""
    rng = np.random.default_rng(seed)
    u = np.zeros((r, s), np.int64)
    for row in range(r):
        start = (row * s) & 3                # tile edges, row-relative
        for e in range(-start, s, TILE):
            k = e + int(rng.integers(0, TILE))
            if 0 <= k < s:
                u[row, k] = sym[0] | sym[1] << 27
    return torch.as_tensor(u.astype(np.uint32).view(np.int32), device=dev)


def _edge_rows(dev, r, s, seed):
    """Long symbols in the last and first slots of every tile and random ones
    elsewhere, so symbols straddle words across tile edges."""
    rng = np.random.default_rng(seed)
    lens = np.where(rng.random((r, s)) < 0.05, rng.integers(1, 25, (r, s)), 0)
    for row in range(r):
        start = (row * s) & 3
        for e in range(TILE - start, s, TILE):
            lens[row, e - 1] = 23
            lens[row, e] = 21
    codes = rng.integers(0, 1 << 24, (r, s)) & ((1 << lens) - 1)
    return torch.as_tensor((codes | lens << 27).astype(np.uint32).view(np.int32), device=dev)


@pytest.mark.parametrize("kind", ["one-bit", "five-bit", "edges", "zero-rows", "worst",
                                  "one-bit-waves"])
def test_pack_slots_look_back(dev, kind):
    """The chained scan across tiles: tiles of 1 or 5 bits that share words,
    chains of aggregates whose 32-bit window spans many tiles; symbols that
    straddle words at tile edges; all-zero tiles and rows between full ones;
    the worst case, every slot 24 bits; a row of 1-bit tiles several waves
    long, whose later tiles find their predecessors' inclusive carries
    published (each carry must hold 32 bits of earlier tiles).  Caps cut the
    longest row in its last word, the word before, and mid-row; a second
    call on other operands follows at once, so one call's look-back state
    cannot leak into the next."""
    s = 20 * TILE + 7
    if kind == "one-bit-waves":
        slots = _sparse_rows(dev, 1, 1600 * TILE + 5, (1, 1), 6)
    elif kind in ("one-bit", "five-bit"):
        slots = _sparse_rows(dev, 4, s, (1, 1) if kind == "one-bit" else (0b10110, 5), 1)
    elif kind == "edges":
        slots = _edge_rows(dev, 4, s, 2)
    elif kind == "zero-rows":
        slots = _slots(dev, 5, s, 3, 0.3)
        slots[1] = 0
        slots[3, TILE:5 * TILE] = 0
    else:
        slots = torch.full((2, 3 * TILE - 1), (5 | 24 << 27) - (1 << 32),
                           dtype=torch.int32, device=dev)
    _, bits, _ = _pack_equal(slots, int(_row_bits_max(slots)) // 32 + 3)
    top = int(bits.max())
    for cap in (top // 32, top // 32 - 1, top // 64 + 1, 1, 0):
        _pack_equal(slots, max(cap, 0))
    other = _slots(dev, 3, s // 2, 4, 0.1)
    got = [k_pack.pack_slots(t, 900) for t in (slots, other, slots)]
    torch.cuda.synchronize()
    for g, t in zip(got, (slots, other, slots)):
        for a, b in zip(g, bitpack.pack_slots(t, 900)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("r,s", [(6, 3 + 394 * 4), (6, 3 + 394 * 26), (3, 5000)])
@pytest.mark.parametrize("cap", [16, 4096])
def test_pack_and_merge_kernels_equal_plain(dev, r, s, cap):
    """Caps of 16 words force overflow: the kept words, the bit counts and
    the flag must still equal the plain version's."""
    slots = _slots(dev, r, s, s + cap)
    want = _pack_equal(slots, cap)
    assert bool(want[2]) == (cap == 16)
    words, bits = want[0], want[1]
    for frame_cap in (8, r * cap):
        mw, mb = _launched("merge_rows", lambda: k_pack.merge_rows(words, bits, frame_cap))
        pw, pb = bitpack.merge_rows(words, bits, frame_cap)
        assert torch.equal(mw, pw) and int(mb) == int(pb)


def _merge_rows_np(rng, r, c, over=()):
    """Rows for the merge: byte-aligned bit counts (rows 0 and r // 2 empty),
    zero past each count; rows in ``over`` overflowed their c words (more
    bits than the words hold, as pack_slots reports them)."""
    bits = rng.integers(0, c * 4 + 1, r).astype(np.int64) * 8
    bits[[0, r // 2]] = 0
    bits[list(over)] = 32 * c + 40
    words = rng.integers(0, 1 << 32, (r, c), dtype=np.uint64).astype(np.int64)
    for k in range(r):
        nw, rem = divmod(int(bits[k]), 32)
        if nw < c:
            words[k, nw + (rem > 0):] = 0
            if rem:
                words[k, nw] &= (0xFFFFFFFF << (32 - rem)) & 0xFFFFFFFF
    return words, bits


@pytest.mark.parametrize("case", ["fits", "cut", "clamp", "rows-over-cap", "tiny-cap"])
def test_pack_merge_append_kernel_equals_plain(dev, case):
    """merge_append (the merge kernel's append mode) against
    bitpack.merge_append at every seq_bits & 31: the bits before seq_bits
    stay; frames cut at frame_cap, with the overflow flag; the window's
    offset clamped to the buffer's end (at several distances past it); rows
    that overflowed their words; caps of 0 and 1 words.  merge_rows (the
    store mode) on the same rows."""
    rng = np.random.default_rng(len(case))
    r, c = (300, 3) if case == "tiny-cap" else (9, 40)
    words, bits = _merge_rows_np(rng, r, c, over=(2, 5) if case == "rows-over-cap" else ())
    total = int(bits.sum())
    caps = {"fits": (r * c,), "cut": (total // 32 - 5, total // 64), "clamp": (r * c,),
            "rows-over-cap": (r * c, total // 32 - 1), "tiny-cap": (0, 1)}[case]
    w_d, b_d = torch.as_tensor(words, device=dev), torch.as_tensor(bits, device=dev)
    for frame_cap in caps:
        got = _launched("merge_rows", lambda: k_pack.merge_rows(w_d, b_d, frame_cap))
        want = bitpack.merge_rows(w_d, b_d, frame_cap)
        assert torch.equal(got[0], want[0]) and int(got[1]) == int(want[1]) == total
        for residue in range(32):
            for past in ((3, 17) if case == "clamp" else (0,)):
                seq_bits = 32 * (4 + past + residue % 5) + residue
                n_words = frame_cap + 1 + (4 if case == "clamp" else 60)
                seq = torch.as_tensor(random_sequence(rng, n_words, seq_bits), device=dev)
                sb = torch.tensor(seq_bits, device=dev)
                got = _launched("merge_rows", lambda: k_pack.merge_append(
                    seq.clone(), sb, w_d, b_d, frame_cap))
                want = bitpack.merge_append(seq.clone(), sb, w_d, b_d, frame_cap)
                assert [g.dtype for g in got] == [w.dtype for w in want]
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (frame_cap, residue, past)
                assert bool(got[3]) == (total > 32 * frame_cap)
                assert int(sb) == seq_bits          # seq_bits is not updated in place


def test_pack_merge_append_sequence_of_frames(dev):
    """Frames of real packed rows appended back to back, each at the bit
    count the previous call left on the card: the same buffer and counts as
    the plain version's chain."""
    seq_k = torch.zeros(20000, dtype=torch.int64, device=dev)
    seq_p = seq_k.clone()
    sb_k = sb_p = torch.zeros((), dtype=torch.int64, device=dev)
    for k in range(6):
        slots = _slots(dev, 5, 3 + 394 * 4, 100 + k, density=0.05)
        w, b, _ = k_pack.pack_slots(slots, 512)
        seq_k, sb_k, fb_k, _ = _launched("merge_rows", lambda: k_pack.merge_append(
            seq_k, sb_k, w, b, 2048))
        seq_p, sb_p, fb_p, _ = bitpack.merge_append(seq_p, sb_p, w, b, 2048)
        assert int(fb_k) == int(fb_p) and int(sb_k) == int(sb_p)
    assert torch.equal(seq_k, seq_p)


def test_pack_merge_wrappers_check_inputs(dev):
    words = torch.zeros((4, 8), dtype=torch.int64, device=dev)
    bits = torch.zeros(4, dtype=torch.int64, device=dev)
    sb = torch.zeros((), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="sizing contract"):
        k_pack.merge_append(torch.zeros(32, dtype=torch.int64, device=dev), sb, words, bits, 32)
    with pytest.raises(TypeError, match="dtype"):
        k_pack.merge_append(torch.zeros(64, dtype=torch.int64, device=dev), sb.int(), words,
                            bits, 32)
    with pytest.raises(RuntimeError, match="mpeg2_merge_rows"):     # over 4096 rows
        k_pack.merge_rows(torch.zeros((5000, 1), dtype=torch.int64, device=dev),
                          torch.zeros(5000, dtype=torch.int64, device=dev), 8)


def test_pack_symbols_wrapper_equals_plain(dev):
    """pack_symbols launches the pack_slots kernel and no kernel of its own."""
    slots = _slots(dev, 6, 3 + 394 * 26, 3)
    codes, lens = slots & entropy.SLOT_CODE_MASK, entropy.slot_len(slots)
    before = dict(_build.LAUNCHES)
    got = k_pack.pack_symbols(codes, lens, 4096)
    torch.cuda.synchronize()
    for g, w in zip(got, bitpack.pack_symbols(codes, lens, 4096)):
        assert torch.equal(g, w)
    assert {k: _build.LAUNCHES[k] - before[k] for k in before if _build.LAUNCHES[k] != before[k]} \
        == {"pack_slots": 1}


def _me_planes(dev, w, h, kind, yr):
    """(cur_y, prev_y, prev_u, prev_v) 4:2:0 planes on ``dev``.  pan: real
    motion; flat: every SAD ties (the tie-break and the edge masks decide);
    noise: every SAD is above 4095 (all invalid -> mv (0, 0)); white:
    near-white blocks with dark specks, whose pixel sum plus mean deviation
    wraps the 16-bit intra accumulator; far-, far+: smooth content moving
    yr + 1 pixels up and left (down and right), past the search range, where
    the half-pel step beyond +-yr must stay masked; inward, half-left: noise
    whose exact full-pel (half-pel) match lies above (left of) the frame,
    where the edge masks forbid it; stripes: even rows constant along x
    moving half a pixel down, so the half-pel candidates tie left to right
    and the tournament keeps the lower index."""
    if kind in ("inward", "half-left", "stripes"):
        prev = np.random.default_rng(w * h).integers(0, 256, (h, w))
        if kind == "stripes":
            prev = np.repeat(prev[:, :1] & ~1, w, axis=1)
        p = np.pad(prev, 1)
        if kind == "inward":
            cur = np.zeros_like(prev)
            cur[2:] = prev[:-2]
        elif kind == "half-left":
            cur = (1 + prev + p[1:-1, :-2]) >> 1
        else:
            cur = (1 + prev + p[:-2, 1:-1]) >> 1
        planes = [cur, prev, prev[::2, ::2], prev[1::2, 1::2]]
        return tuple(torch.as_tensor(np.ascontiguousarray(p).astype(np.uint8), device=dev)
                     for p in planes)
    if kind.startswith("far"):
        s = (yr + 1) * (1 if kind == "far-" else -1)
        yy, xx = np.mgrid[-16:h + 16, -16:w + 16]
        base = 128 + 60 * np.sin(xx / 5.0) + 50 * np.cos(yy / 7.0)
        prev, cur = base[16:16 + h, 16:16 + w], base[16 - s:16 - s + h, 16 - s:16 - s + w]
        planes = [cur, prev, prev[::2, ::2], prev[1::2, 1::2]]
        return tuple(torch.as_tensor(np.ascontiguousarray(p).astype(np.uint8), device=dev)
                     for p in planes)
    if kind == "pan":
        f0, f1 = video(w + h, w, h, 2)
        y0, u0, v0 = colorspace.subsample_420(*(torch.as_tensor(p, device=dev) for p in f0))
        y1 = colorspace.subsample_420(*(torch.as_tensor(p, device=dev) for p in f1))[0]
        return y1, y0, u0, v0
    rng = np.random.default_rng(w * h)
    shapes = [(h, w), (h, w), (h // 2, w // 2), (h // 2, w // 2)]
    if kind == "flat":
        planes = [np.full(s, 100, np.uint8) for s in shapes]
    elif kind == "noise":
        planes = [rng.integers(0, 256, s, dtype=np.uint8) for s in shapes]
    else:
        planes = [np.where(rng.random(s) < 0.06, 0, 255).astype(np.uint8) for s in shapes]
    return tuple(torch.as_tensor(p, device=dev) for p in planes)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _strips_of(monkeypatch, sms):
    """With ``sms``, the motion kernels' strips are those of a card of that
    many SMs (ops/kernels/me.strip_width): 1 gives strips of 4 macroblocks
    at every shape of these tests, so that frames 416, 720 and 96 wide end in
    a strip cut short.  None keeps the card's own (2 at 720x576, 4 at
    1920x1152, 1 at the small shapes)."""
    if sms is not None:
        monkeypatch.setattr(k_me, "_sm_count", lambda index: sms)


@pytest.mark.parametrize("w,h,vl", [(64, 64, 1), (64, 64, 3), (416, 64, 1), (416, 64, 3),
                                    (2048, 32, 1), (2048, 32, 3), (720, 576, 2),
                                    (1920, 1152, 3)])
@pytest.mark.parametrize("kind", ["pan", "flat", "noise", "white", "far-", "far+", "inward",
                                  "half-left", "stripes"])
@pytest.mark.parametrize("sms", [None, 1])
def test_me_kernels_equal_plain(dev, monkeypatch, w, h, vl, kind, sms):
    """The fused, luma and chroma kernels against their plain versions, I
    and P frames, tiles and planes; the fused kernel equals the luma kernel
    followed by the chroma kernel.  The cells' shapes (720x576 at vl 2,
    1920x1152 at vl 3), and each shape with the card's strips and with
    strips of 4 (``sms`` 1)."""
    _strips_of(monkeypatch, sms)
    yr, ur = 2 * vl, vl
    cur, py, pu, pv = _me_planes(dev, w, h, kind, yr)
    halos = (motion.pad_halo(py, 8), motion.pad_halo(pu, 4), motion.pad_halo(pv, 4))
    for is_i in (False, True):
        for as_plane in (False, True):
            want = motion.estimate_and_predict_local(cur, *halos, is_i, yr, ur, 0, h // 16,
                                                     as_plane)
            fused = _launched("me_fused", lambda: k_me.motion_estimate_fused(
                cur, py, pu, pv, is_i, yr, ur, as_plane=as_plane))
            _equal(fused, want)
            luma = _launched("me_luma", lambda: k_me.motion_estimate(
                cur, py, is_i, yr, as_plane=as_plane))
            _equal(luma, want[:4])
            chroma = _launched("chroma_pred", lambda: k_me.chroma_pred(
                pu, pv, *luma[:3], ur, as_plane=as_plane))
            _equal(chroma, want[4:])
            _equal(fused, luma + chroma)
    # chroma on an inter map that is not the search's own
    mixed = torch.as_tensor(np.random.default_rng(vl).random(fused[0].shape) < 0.5,
                            device=dev)
    got = _launched("chroma_pred", lambda: k_me.chroma_pred(pu, pv, mixed, *fused[1:3], ur))
    _equal(got, motion.chroma_pred(*halos[1:], mixed, *fused[1:3], ur))


@pytest.mark.parametrize("nby,nbx", [(4, 5), (3, 27), (2, 120)])
@pytest.mark.parametrize("vl", [1, 3])
def test_me_chroma_kernel_edges_and_ranges(dev, nby, nbx, vl):
    """The chroma kernel against its plain version on maps with every (hx,
    hy) and vectors out to +-(2 * yr + 1) half-pels, the edge macroblocks
    pointing out of the plane: tiles and planes, whole planes and bands
    (whose halo rows hold data); odd nbx and nbx >= 26."""
    ur = vl
    yr = 2 * ur
    rng = np.random.default_rng(nbx + vl)
    maps = tuple(torch.as_tensor(m, device=dev)
                 for m in chroma_maps(nby, nbx, -(2 * yr + 1), 2 * yr + 1, nbx * vl))
    for halo in (False, True):
        pu, pv = (torch.as_tensor(rng.integers(0, 256, (nby * 8 + 8 * halo, nbx * 8),
                                               dtype=np.uint8), device=dev) for _ in range(2))
        hu, hv = (pu, pv) if halo else (motion.pad_halo(pu, 4), motion.pad_halo(pv, 4))
        want = motion.chroma_pred(hu, hv, *maps, ur)
        for as_plane in (False, True):
            got = _launched("chroma_pred", lambda: k_me.chroma_pred(
                pu, pv, *maps, ur, halo=halo, as_plane=as_plane))
            _equal(got, tuple(map(motion.to_planes, want)) if as_plane else want)
    # the kernel reads 4-byte words: planes must be 4-byte aligned
    odd = torch.zeros(nby * 64 * nbx + 1, dtype=torch.uint8, device=dev)[1:].view(nby * 8, -1)
    with pytest.raises(ValueError, match="aligned"):
        k_me.chroma_pred(odd, odd, *maps, ur)


@pytest.mark.parametrize("vl", [1, 3])
@pytest.mark.parametrize("sign", [-1, 1])
def test_me_kernels_range_end_1920_wide(dev, vl, sign):
    """1920 wide (nbx = 120), noise moving yr pixels sideways: the exact
    match lies at dx = +-yr, the first or last candidate of the window row's
    byte alignment."""
    yr, ur, w, h = 2 * vl, vl, 1920, 32
    base = np.random.default_rng(vl).integers(0, 256, (h, w + 2 * yr)).astype(np.uint8)
    prev, cur = base[:, yr:yr + w], base[:, yr + sign * yr:yr + sign * yr + w]
    py = torch.as_tensor(np.ascontiguousarray(prev), device=dev)
    pu, pv = py[::2, ::2].contiguous(), py[1::2, 1::2].contiguous()
    cy = torch.as_tensor(np.ascontiguousarray(cur), device=dev)
    halos = (motion.pad_halo(py, 8), motion.pad_halo(pu, 4), motion.pad_halo(pv, 4))
    want = motion.estimate_and_predict_local(cy, *halos, False, yr, ur, 0, h // 16, True)
    interior = want.mvx[:, 1:-1]
    assert (interior == sign * 2 * yr).all() and want.inter[:, 1:-1].all()
    _equal(_launched("me_fused", lambda: k_me.motion_estimate_fused(
        cy, py, pu, pv, False, yr, ur, as_plane=True)), want)
    luma = _launched("me_luma", lambda: k_me.motion_estimate(cy, py, False, yr, as_plane=True))
    _equal(luma, want[:4])
    _equal(k_me.chroma_pred(pu, pv, *luma[:3], ur, as_plane=True), want[4:])


@pytest.mark.parametrize("form", ["fused", "split"])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("sms", [None, 1, 3])
def test_me_kernels_middle_band_equal_plain(dev, monkeypatch, form, backward, sms):
    """The band form (halo rows, global MB rows): MB rows 2..5 of 8, whose
    seams must not be taken for frame edges.  The pan moves down and right,
    or, ``backward``, up and left, so the best candidates of the band's top
    or bottom row lie across a seam.  Strips of one macroblock (the card's),
    of 4 (``sms`` 1: a strip of 4 and one of 2 a row, each with one end on a
    frame edge) and of 2 (``sms`` 3: three a row, the middle one at neither
    edge)."""
    _strips_of(monkeypatch, sms)
    w, h, r0, r1 = 96, 128, 2, 6
    f0, f1 = video(7, w, h, 2)[::-1 if backward else 1]
    y0, u0, v0 = colorspace.subsample_420(*(torch.as_tensor(p, device=dev) for p in f0))
    y1 = colorspace.subsample_420(*(torch.as_tensor(p, device=dev) for p in f1))[0]
    band = (y1[16 * r0:16 * r1], y0[16 * r0 - 8:16 * r1 + 8],
            u0[8 * r0 - 4:8 * r1 + 4], v0[8 * r0 - 4:8 * r1 + 4])
    for as_plane in (False, True):
        want = motion.estimate_and_predict_local(*band, False, 6, 3, r0, h // 16, as_plane)
        if form == "fused":
            got = _launched("me_fused", lambda: k_me.estimate_and_predict_local(
                *band, False, 6, 3, r0, h // 16, as_plane))
        else:
            got = _launched("me_luma", lambda: k_me.motion_estimate(
                band[0], band[1], False, 6, r0, h // 16, halo=True, as_plane=as_plane))
            got += _launched("chroma_pred", lambda: k_me.chroma_pred(
                *band[2:], *got[:3], 3, halo=True, as_plane=as_plane))
        _equal(got, want)
        assert want.inter.any()


@pytest.mark.parametrize("form", ["fused", "luma"])
@pytest.mark.parametrize("as_plane", [False, True])
def test_me_strip_stores_nothing_past_the_frame(dev, form, as_plane):
    """A strip cut short by the frame's right edge (nbx = 5 in strips of 4)
    computes and stores nothing for its macroblocks past the edge: every
    output is a view into a buffer filled with a canary, every byte around
    the views keeps it, and the views equal the plain version."""
    w, h, yr = 80, 64, 6
    nby, nbx = h // 16, w // 16
    cur, py, pu, pv = _me_planes(dev, w, h, "pan", yr)
    canary, pad = 0xA5, 4096

    def view(shape, dtype):
        n = int(np.prod(shape))
        buf = torch.full((n * torch.tensor([], dtype=dtype).element_size() + 2 * pad,), canary,
                         dtype=torch.uint8, device=dev)
        return buf, buf[pad:-pad].view(dtype).view(shape)

    outs = [view((nby, nbx), torch.bool), view((nby, nbx), torch.int32),
            view((nby, nbx), torch.int32)]
    for bs in (16, 8, 8)[:3 if form == "fused" else 1]:
        outs.append(view((h * bs // 16, w * bs // 16) if as_plane else (nby, nbx, bs, bs),
                         torch.uint8))
    got = tuple(o for _, o in outs)
    position = torch.ones((), dtype=torch.int32, device=dev)
    if form == "fused":
        _build.launch("mpeg2_me_fused", None, dev, cur, py, pu, pv, position, *got[:3],
                      *got[3:], nby, nbx, yr, 0, nby, 0, int(as_plane), k_me.MAX_STRIP)
    else:
        _build.launch("mpeg2_me_luma", None, dev, cur, py, position, *got, nby, nbx, yr, 0,
                      nby, 0, int(as_plane), k_me.MAX_STRIP)
    torch.cuda.synchronize()
    for buf, _ in outs:
        assert (buf[:pad] == canary).all() and (buf[-pad:] == canary).all()
    want = motion.estimate_and_predict_local(
        cur, motion.pad_halo(py, 8), motion.pad_halo(pu, 4), motion.pad_halo(pv, 4), False, yr,
        yr // 2, 0, nby, as_plane)
    _equal(got, want[:len(got)])


def test_wrappers_check_inputs(dev):
    slots = _slots(dev, 2, 100, 0)
    with pytest.raises(TypeError, match="dtype"):
        k_pack.pack_slots(slots.to(torch.int64), 64)
    with pytest.raises(ValueError, match="aligned"):          # the 16-byte loads
        k_pack.pack_slots(slots.reshape(-1)[1:101].view(1, 100), 64)
    with pytest.raises(TypeError, match="dtype"):
        k_acsym.ac_slot_grid(torch.zeros((1, 384), dtype=torch.int32, device=dev),
                             torch.zeros((1, 397), dtype=torch.int64, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        k_pack.merge_rows(torch.zeros((64, 2), dtype=torch.int64, device=dev).t(),
                          torch.zeros(2, dtype=torch.int64, device=dev), 64)
    with pytest.raises(ValueError, match="several devices"):
        k_acsym.ac_slot_grid(torch.zeros((1, 384), dtype=torch.int32),
                             torch.zeros((1, 397), dtype=torch.int32, device=dev))
    y = torch.zeros((64, 64), dtype=torch.uint8, device=dev)
    c = torch.zeros((32, 32), dtype=torch.uint8, device=dev)
    with pytest.raises(TypeError, match="dtype"):
        k_me.motion_estimate(y, y.to(torch.int32), False, 6)
    with pytest.raises(ValueError, match="shape"):
        k_me.motion_estimate_fused(y, y, c, c, False, 6, 3, halo=True)
    # the vector loads need 8-byte aligned planes
    odd = torch.zeros(64 * 64 + 1, dtype=torch.uint8, device=dev)[1:].view(64, 64)
    with pytest.raises(ValueError, match="aligned"):
        k_me.motion_estimate_fused(odd, y, c, c, False, 6, 3)
    with pytest.raises(ValueError, match="aligned"):
        k_me.motion_estimate(y, odd, False, 6)
    inter = torch.zeros((4, 4), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        k_tf.transform_recon(y, c, c, odd, c, c, inter, 2)
    with pytest.raises(TypeError, match="dtype"):
        k_tf.transform_recon(y, c, c, y.to(torch.int32), c, c, inter, 2)


@pytest.mark.parametrize("w,chunk,caps", [
    (416, 1, {}), (416, 3, {}), (64, 3, dict(row_cap=64, frame_cap=256))])
def test_encoder_on_card_equals_cpu(dev, w, chunk, caps):
    """Whole streams on the card equal the plain versions' on the CPU, with
    every main-path kernel launched once per frame and the split motion
    kernels never; the tiny caps force the overflow retry at the bounds."""
    cfg = EncoderConfig(xl=5, yl=4)
    frames = video(w + chunk, w, 64, 5, "noise" if caps else "pan")
    _build.reset_launches()
    got = Encoder(cfg, device=dev, **caps).encode(frames, w, 64, 2, chunk_frames=chunk)
    assert all(_build.LAUNCHES[k] >= 5 for k in MAIN_PATH), _build.LAUNCHES
    assert _build.LAUNCHES["me_luma"] == _build.LAUNCHES["chroma_pred"] == 0
    want = Encoder(cfg, device="cpu", **caps).encode(frames, w, 64, 2, chunk_frames=chunk)
    assert got == want


@pytest.mark.parametrize("case", GOLDEN_MATRIX, ids=lambda c: "{}x{}-q{}-vl{}-{}f-{}-{}-p{}-c{}".format(
    *c[:6], c[7], c[6], c[9]))
def test_encoder_on_card_equals_golden(dev, case):
    """The card's streams against the golden model (NumPy, sharing only
    core/ with the encoder): vector levels 1 and 2, q_level 1, 3 and 4, the
    partial stop and GOP wrap, at 64 and 416 px wide, streaming and
    chunked; every main-path kernel launched at least once a frame."""
    w, h, q, vl, n, kind, pframes, stop, groups, chunk = case
    cfg = EncoderConfig(xl=5, yl=4, vector_level=vl, q_level=q)
    frames = video(w + n, w, h, n, kind)
    _build.reset_launches()
    got = Encoder(cfg, device=dev).encode(frames, w, h, pframes, stop_mode=stop,
                                          partial_groups=groups, chunk_frames=chunk)
    assert all(_build.LAUNCHES[k] >= n for k in MAIN_PATH), _build.LAUNCHES
    assert got == G.encode_sequence(cfg, SequenceConfig(w, h, pframes), frames,
                                    stop_mode=stop, partial_groups=groups)


@pytest.mark.parametrize("vl,q,chunk", [(1, 4, 1), (2, 1, 2), (3, 3, 2)])
def test_encoder_on_card_2048_wide_equals_cpu(dev, vl, q, chunk):
    """The widest frame (2048 px, nbx = 128) at each vector level: the
    card's stream equals the plain versions' on the CPU (the golden model is
    too slow there), an I and a P frame, streaming and chunked."""
    cfg = EncoderConfig(xl=7, yl=4, vector_level=vl, q_level=q)
    frames = video(2048 + vl, 2048, 64, 2, "noise" if q == 1 else "pan")
    _build.reset_launches()
    got = Encoder(cfg, device=dev).encode(frames, 2048, 64, 23, chunk_frames=chunk)
    assert all(_build.LAUNCHES[k] >= 2 for k in MAIN_PATH), _build.LAUNCHES
    want = Encoder(cfg, device="cpu").encode(frames, 2048, 64, 23, chunk_frames=chunk)
    assert got == want


# ---- push_chunk's page-locked staging (models/encoder.py::_Staging) ---------

RING = M.STAGING_SLOTS


def _core_stream(dev, cfg, frames, w, h, pframes, chunk):
    """The stream of ``frames`` from the eager encode_gop_scan_core on
    ``dev``, ``chunk`` frames a call at the bounds' caps, each chunk
    uploaded from np.stack: the reference for push_chunk's staging."""
    row_cap, frame_cap = M.bound_caps(w, h)
    kw = dict(yr=cfg.yr, ur=cfg.ur, q_level=cfg.q_level, row_cap=row_cap,
              frame_cap=frame_cap, seq_cap=frame_cap * chunk)
    bw = BitWriter()
    bw.put_chunks(sequence_header_chunks(w, h))
    parts = [bw.to_bytes_aligned()]
    prev = (torch.zeros((h, w), dtype=torch.uint8, device=dev),
            *(torch.zeros((h // 2, w // 2), dtype=torch.uint8, device=dev),) * 2)
    i_f = fno = 0
    for a in range(0, len(frames), chunk):
        stacks = [torch.as_tensor(np.stack([f[i] for f in frames[a:a + chunk]]), device=dev)
                  for i in range(3)]
        out = M.encode_gop_scan_core(*stacks, *prev, i_f, fno, pframes, **kw)
        assert not bool(out[7])
        prev, nbits, i_f, fno = out[:3], int(out[4]), int(out[5]), int(out[6])
        parts.append(M.words_to_bytes(out[3][:(nbits + 31) // 32].cpu().numpy(), nbits))
    bw = BitWriter()
    bw.put_chunks(SEQUENCE_END_CHUNKS)
    data = b"".join(parts) + bw.to_bytes_aligned()
    return data + b"\x00" * ((len(data) // 32 + 1) * 32 - len(data))


@pytest.mark.parametrize("held", [False, True])
def test_push_chunk_staged_1920x1152_equals_core(dev, held):
    """Two 40-frame chunks of 1920x1152 through push_chunk (the encoder's
    page-locked ring; caps at the bounds, as the command line sets them)
    give the eager encode_gop_scan_core's stream, every frame staged once.
    Held: the stream is kept busy (torch.cuda._sleep, about 0.1 s) before
    each chunk, so the ring's copies queue behind it and the host has to
    wait for its slots; the bytes do not change.  The second chunk's planes
    are read-only, as the JAX package hands them out."""
    w, h = 1920, 1152
    cfg = EncoderConfig(xl=7, yl=7, vector_level=3, q_level=2)
    frames = video(11, w, h, 80)
    for f in frames[40:]:
        for p in f:
            p.setflags(write=False)
    enc = Encoder(cfg, *M.bound_caps(w, h), device=dev)
    enc.start_sequence(SequenceConfig(w, h, 23))
    profiling.COUNTS.clear()
    for a in (0, 40):
        if held:
            torch.cuda._sleep(200_000_000)
        enc.push_chunk(frames[a:a + 40])
    got = enc.finish()
    assert profiling.COUNTS["staged_frames"] == 80
    assert profiling.COUNTS["host_syncs"] == 14
    if held:
        assert profiling.COUNTS["staging_waits"] > 0
    assert got == _core_stream(dev, cfg, frames, w, h, 23, 40)


def test_push_chunk_keeps_no_view_of_the_callers_frames(dev):
    """Each chunk's arrays overwritten as soon as push_chunk returns change
    nothing: chunks of RING + 3 frames (longer than the ring), the stream
    equal to the CPU encoder's on untouched copies."""
    cfg, n = EncoderConfig(xl=5, yl=4), RING + 3
    frames = video(13, 416, 64, 2 * n)
    want = Encoder(cfg, device="cpu").encode(frames, 416, 64, 2, chunk_frames=n)
    enc = Encoder(cfg, device=dev)
    enc.start_sequence(SequenceConfig(416, 64, 2))
    for a in range(0, len(frames), n):
        chunk = [tuple(p.copy() for p in f) for f in frames[a:a + n]]
        enc.push_chunk(chunk)
        for f in chunk:
            for p in f:
                p[...] = 255 - p
    assert enc.finish() == want


def test_push_chunk_overflow_retry_reads_the_staged_frames(dev):
    """Noise at tiny caps overflows each chunk of RING + 3 frames: the
    retry at the bounds encodes the frames already staged on the card (each
    frame staged once) and the stream equals the CPU encoder's at the same
    caps."""
    cfg, caps, n = EncoderConfig(xl=5, yl=4), dict(row_cap=64, frame_cap=256), RING + 3
    frames = video(17, 416, 64, 2 * n, "noise")
    profiling.COUNTS.clear()
    got = Encoder(cfg, device=dev, **caps).encode(frames, 416, 64, 2, chunk_frames=n)
    assert profiling.COUNTS["overflow_retries"] == 2
    assert profiling.COUNTS["staged_frames"] == 2 * n
    assert got == Encoder(cfg, device="cpu", **caps).encode(frames, 416, 64, 2,
                                                              chunk_frames=n)


def test_push_chunk_spans_on_card(dev, tmp_path):
    """Under a profiler on the card: ``.stack`` once a frame (its copy into
    a slot), ``.upload`` twice (the slot's wait, the copy's enqueue), the
    other children once a chunk; 7 blocking reads a chunk, as on the CPU."""
    cfg, n = EncoderConfig(xl=4, yl=4), RING + 2
    frames = video(19, 64, 64, 2 * n)
    enc = Encoder(cfg, device=dev)
    enc.encode(frames[:n], 64, 64, 2, chunk_frames=n)          # the capture, untraced
    profiling.reset()
    with profiling.trace_to(str(tmp_path / "trace.json")):
        got = enc.encode(frames, 64, 64, 2, chunk_frames=n)
    spans, counts = profiling.traced()
    assert spans["push_chunk.stack"][0] == 2 * n
    assert spans["push_chunk.upload"][0] == 4 * n
    for child in ("program", "sync", "download", "carry"):
        assert spans["push_chunk." + child][0] == 2, child
    assert counts["host_syncs"] == 14 and counts["staged_frames"] == 2 * n
    assert got == Encoder(cfg, device="cpu").encode(frames, 64, 64, 2, chunk_frames=n)


@pytest.mark.parametrize("w", [64, 416])
def test_batch_encoder_on_card_equals_cpu(dev, w):
    """Three streams through BatchEncoder (one frame, then chunks of 3 and
    1) on the card equal the same on the CPU, with every main-path kernel
    launched once per stream and frame and the split motion kernels never."""
    cfg, seq = EncoderConfig(xl=5, yl=4), SequenceConfig(w, 64, 2)
    videos = [video(w + b, w, 64, 5, "noise" if b % 2 else "pan") for b in range(3)]
    streams = {}
    for d in (dev, torch.device("cpu")):
        _build.reset_launches()
        be = BatchEncoder(cfg, seq, 3, device=d)
        be.push_frames([v[0] for v in videos])
        be.push_chunks([v[1:4] for v in videos])
        be.push_chunks([v[4:] for v in videos])
        streams[d.type] = be.finish()
        if d.type == "cuda":
            assert all(_build.LAUNCHES[k] >= 15 for k in MAIN_PATH), _build.LAUNCHES
            assert _build.LAUNCHES["me_luma"] == _build.LAUNCHES["chroma_pred"] == 0
    assert streams["cuda"] == streams["cpu"]


def test_batch_headend_8x576_equals_single_streams(dev):
    """Eight 720x576 channels (12-frame GOPs; two calls of 7 frames, the
    second starting on a P-frame and crossing a GOP) through
    encode_gops_batched equal each channel's own encode_gop_scan on the
    card: payload, recon and GOP state."""
    w, h, pframes, streams, n = 720, 576, 11, 8, 7
    row_cap, frame_cap = M.bound_caps(w, h)
    kw = dict(yr=4, ur=2, q_level=2, row_cap=row_cap, frame_cap=frame_cap,
              seq_cap=frame_cap * n)
    videos = [video(40 + b, w, h, 2 * n, "noise" if b == 3 else "pan") for b in range(streams)]
    planes = [torch.as_tensor(np.stack([np.stack([f[p] for f in v]) for v in videos]),
                              device=dev) for p in range(3)]
    z = torch.zeros((streams, h, w), dtype=torch.uint8, device=dev)
    zc = torch.zeros((streams, h // 2, w // 2), dtype=torch.uint8, device=dev)
    state = (z, zc, zc, [0] * streams, [0] * streams)
    single = [(z[b], zc[b], zc[b], 0, 0) for b in range(streams)]
    for first in (0, n):
        stacks = [p[:, first:first + n] for p in planes]
        ry, ru, rv, sw, sb, i_f, fno, ovf, _, _ = encode_gops_batched(*stacks, *state, pframes,
                                                                      **kw)
        assert not bool(ovf.any())
        bits = sb.tolist()
        for b in range(streams):
            out = M.encode_gop_scan(*(s[b] for s in stacks), *single[b], pframes, **kw)
            nb = int(out[4])
            assert nb == bits[b] and torch.equal(out[3][:(nb + 31) // 32],
                                                 sw[b, :(nb + 31) // 32]), (first, b)
            for mine, theirs in zip((ry[b], ru[b], rv[b]), out[:3]):
                assert torch.equal(mine, theirs)
            assert (int(out[5]), int(out[6])) == (i_f[b], fno[b]) == ((first + n) % 12, first + n)
            single[b] = (out[0].clone(), out[1].clone(), out[2].clone(), i_f[b], fno[b])
        state = (ry, ru, rv, i_f, fno)


def test_shard_local_steps_on_card_equal_encode_frame_core(dev):
    """Four shards' local_step on the card (halos cut from the whole recon,
    the motion kernel in its band form), then the frame tail: payload and
    recon equal encode_frame_core's on the card and on the CPU, IPP."""
    w, h, nsh = 416, 128, 4
    nby, rows = h // 16, h // 16 // nsh
    step = make_local_step(nby, yr=6, ur=3, q_level=2, row_cap=2048)
    kw = dict(yr=6, ur=3, q_level=2, row_cap=2048, frame_cap=65536)
    prev = {d: (torch.zeros((h, w), dtype=torch.uint8, device=d),
                torch.zeros((h // 2, w // 2), dtype=torch.uint8, device=d),
                torch.zeros((h // 2, w // 2), dtype=torch.uint8, device=d))
            for d in ("cpu", "cuda")}
    for fi, f in enumerate(video(7, w, h, 3)):
        planes = tuple(torch.as_tensor(p, device=dev) for p in f)
        before = _build.LAUNCHES["me_fused"]
        outs = [step(*(p[16 * rows * k:16 * rows * (k + 1)] for p in planes),
                     band_with_halo(prev["cuda"][0], 8, 16 * rows * k, 16 * rows * (k + 1)),
                     band_with_halo(prev["cuda"][1], 4, 8 * rows * k, 8 * rows * (k + 1)),
                     band_with_halo(prev["cuda"][2], 4, 8 * rows * k, 8 * rows * (k + 1)),
                     fi, fi, rows * k) for k in range(nsh)]
        assert _build.LAUNCHES["me_fused"] == before + nsh
        ry, ru, rv, words, bits = (torch.cat([o[i] for o in outs]) for i in range(5))
        fw, fb, ovf = frame_tail(words, bits, torch.stack([o[5] for o in outs]).any(),
                                 fi, fi, row_cap=2048, frame_cap=65536)
        torch.cuda.synchronize()
        assert not bool(ovf)
        nw = (int(fb) + 31) // 32
        for d in ("cuda", "cpu"):
            want = encode_frame_core(*(torch.as_tensor(p, device=d) for p in f), *prev[d],
                                     fi, fi, **kw)
            assert int(want[4]) == int(fb), d
            assert torch.equal(want[3][:nw].cpu(), fw[:nw].cpu()), d
            for a, b in zip(want[:3], (ry, ru, rv)):
                assert torch.equal(a.cpu(), b.cpu()), d
            prev[d] = want[:3]


def test_append_bitstrings_batched_on_card_equals_cpu(dev):
    """The batched append (plain torch) on card tensors equals the CPU at
    every seq_bits & 31, one stream clamped at the buffer's end."""
    rng = np.random.default_rng(3)
    n, c = 300, 40
    for r in range(32):
        seq_bits = np.array([32 * 5 + r, 32 * 200 + (5 * r) % 32, 32 * 290 + r])
        seq = np.stack([random_sequence(rng, n, int(s)) for s in seq_bits])
        fbits = np.array([37 * 32 - 8, 0, 1000])
        words = np.stack([random_sequence(rng, c, int(b)) for b in fbits])
        args = (seq, seq_bits, words, fbits)
        got = bitpack.append_bitstrings_batched(*(torch.as_tensor(a.copy(), device=dev)
                                                  for a in args))
        want = bitpack.append_bitstrings_batched(*(torch.from_numpy(a.copy()) for a in args))
        assert all(torch.equal(g.cpu(), w_) for g, w_ in zip(got, want)), r



# ---- the compiled programs: CUDA graphs of one frame's step -----------------

def _stacks(dev, w, h, n, seed, kind="pan"):
    frames = video(seed, w, h, n, kind)
    return [torch.as_tensor(np.stack([f[i] for f in frames]), device=dev) for i in range(3)]


@pytest.mark.parametrize("w", [64, 416, 1920])
def test_graph_me_pack_gop_scan_equals_core(dev, w):
    """encode_gop_scan replays its captured step and equals the eager
    encode_gop_scan_core in all ten outputs: two chunks (4 frames, then 3
    from the first chunk's recon and GOP state), I and P frames, the GOP
    wrapping (pframes_count 2 from position 1) and the timecode rolling over
    at frame 1440.  LAUNCHES counts each main-path kernel and the carry
    kernel exactly once a frame, the capture's warm-up not at all."""
    h, kw = 64, dict(yr=6, ur=3, q_level=2, row_cap=8192, frame_cap=65536, seq_cap=131072)
    graphs.clear()
    stacks = _stacks(dev, w, h, 7, w)
    zy = torch.zeros((h, w), dtype=torch.uint8, device=dev)
    zc = torch.zeros((h // 2, w // 2), dtype=torch.uint8, device=dev)
    state = {"core": ((zy, zc, zc), 1, 1437), "graph": ((zy, zc, zc), 1, 1437)}
    for a, b in ((0, 4), (4, 7)):
        chunk = [t[a:b] for t in stacks]
        prev, i0, f0 = state["core"]
        want = M.encode_gop_scan_core(*chunk, *prev, i0, f0, 2, **kw)
        prev, i0, f0 = state["graph"]
        _build.reset_launches()
        got = M.encode_gop_scan(*chunk, *prev, i0, f0, 2, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES == {**{k: b - a for k in MAIN_PATH}, "me_luma": 0,
                                   "chroma_pred": 0, "gop_carry": b - a}, _build.LAUNCHES
        for k in range(3):
            assert torch.equal(got[k], want[k]), k
        nbits = int(want[4])
        assert int(got[4]) == nbits and not bool(got[7]) and not bool(want[7])
        nw = (nbits + 31) // 32
        assert torch.equal(got[3][:nw], want[3][:nw])
        assert (int(got[5]), int(got[6])) == (want[5], want[6])
        assert got[8].tolist() == want[8].tolist() and got[9].tolist() == want[9]
        state["core"] = (want[:3], want[5], want[6])
        state["graph"] = (tuple(t.clone() for t in got[:3]), got[5].clone(), got[6].clone())
    assert [k[0] for k in graphs._programs] == ["gop"]


@pytest.mark.parametrize("w", [64, 416, 1920])
def test_graph_me_pack_frame_device_equals_core(dev, w):
    """encode_frame_device replays its captured step and equals the eager
    encode_frame_core, frame after frame (I P P I), each main-path kernel
    counted once a call."""
    h, kw = 64, dict(yr=6, ur=3, q_level=3, row_cap=2048, frame_cap=65536)
    stacks = _stacks(dev, w, h, 4, w + 1, "noise" if w == 416 else "pan")
    zy = torch.zeros((h, w), dtype=torch.uint8, device=dev)
    zc = torch.zeros((h // 2, w // 2), dtype=torch.uint8, device=dev)
    prev_c = prev_g = (zy, zc, zc)
    for k, i_f in enumerate((0, 1, 2, 0)):
        frame = [t[k] for t in stacks]
        want = encode_frame_core(*frame, *prev_c, i_f, 1438 + k, **kw)
        _build.reset_launches()
        got = M.encode_frame_device(*frame, *prev_g, torch.tensor(i_f, dtype=torch.int32,
                                                                  device=dev), 1438 + k, **kw)
        torch.cuda.synchronize()
        assert all(_build.LAUNCHES[n] == 1 for n in MAIN_PATH), _build.LAUNCHES
        nw = (int(want[4]) + 31) // 32
        assert int(got[4]) == int(want[4]) and not bool(got[5])
        assert torch.equal(got[3][:nw], want[3][:nw])
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b), k
        prev_c, prev_g = want[:3], tuple(t.clone() for t in got[:3])


def test_graph_me_pack_encoder_second_cache_key(dev):
    """Encoder on the card goes through the programs, each a captured graph:
    caps too small for noise send every push to the bounds' program (a
    second cache key), and a second sequence of another geometry through
    the same object replays programs of its own; the streams equal the
    CPU's."""
    graphs.clear()
    cfg = EncoderConfig(xl=5, yl=4)
    enc = Encoder(cfg, row_cap=64, frame_cap=256, device=dev)
    cpu = Encoder(cfg, row_cap=64, frame_cap=256, device="cpu")
    for w, chunk in ((64, 1), (64, 3), (416, 3)):
        frames = video(w + chunk, w, 64, 3, "noise")
        assert enc.encode(frames, w, 64, 1, chunk_frames=chunk) == \
            cpu.encode(frames, w, 64, 1, chunk_frames=chunk)
    keys = [k for k in graphs._programs if k[1].type == "cuda"]
    assert all(graphs._programs[k].step._graph is not None for k in keys)
    caps = {(k[0], k[3], k[7], k[8]) for k in keys}
    bounds = M.bound_caps(64, 64)
    assert {("frame", 64, 64, 256), ("frame", 64) + bounds, ("gop", 64, 64, 256),
            ("gop", 64) + bounds, ("gop", 416) + M.bound_caps(416, 64)} <= caps, caps


def test_graph_me_pack_batch_encoder_replays(dev):
    """BatchEncoder's streams replay the single-stream programs one after
    another: every main-path kernel counted exactly once per stream and
    frame, and each stream equal to its own Encoder.encode."""
    cfg, seq = EncoderConfig(xl=5, yl=4), SequenceConfig(416, 64, 2)
    videos = [video(30 + b, 416, 64, 5, "noise" if b % 2 else "pan") for b in range(3)]
    be = BatchEncoder(cfg, seq, 3, device=dev)
    _build.reset_launches()
    be.push_frames([v[0] for v in videos])
    be.push_chunks([v[1:5] for v in videos])
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {**{k: 15 for k in MAIN_PATH}, "me_luma": 0,
                               "chroma_pred": 0, "gop_carry": 12}, _build.LAUNCHES
    got = be.finish()
    for b, v in enumerate(videos):
        enc = Encoder(cfg, device=dev)
        enc.start_sequence(seq)
        enc.push_frame(*v[0])
        enc.push_chunk(v[1:5])
        assert got[b] == enc.finish(), b


def test_graph_pack_me_lookback_outlives_a_larger_capture(dev):
    """A graph keeps pack_slots' look-back buffer: a later warm-up and
    capture that need a larger one (2048x1440: 92 rows of 13 tiles, past the
    first buffer's 1024) leave the first buffer allocated, so memory then
    taken and filled on the capture stream is not the first graph's, and
    the 64x64 program still equals encode_frame_core, I and P."""
    graphs.clear()
    kw = dict(yr=6, ur=3, q_level=2, row_cap=4096, frame_cap=65536)

    def frame(w, h):
        f = [torch.as_tensor(p, device=dev) for p in video(w, w, h, 2, "pan")[1]]
        z = (torch.zeros((h, w), dtype=torch.uint8, device=dev),
             *(torch.zeros((h // 2, w // 2), dtype=torch.uint8, device=dev),) * 2)
        return f, z

    small, zs = frame(64, 64)
    M.encode_frame_device(*small, *zs, 0, 0, **kw)
    side = graphs._side_stream(small[0].device)
    key = (small[0].device, side.cuda_stream)
    first = k_pack._lookback[key]
    big, zb = frame(2048, 1440)
    M.encode_frame_device(*big, *zb, 0, 0, **kw)
    assert k_pack._lookback[key].numel() - 2 >= 92 * 13
    assert any(b is first for b in k_pack._retired)
    with torch.cuda.stream(side):
        junk = [torch.full((first.numel(),), -1, dtype=torch.int64, device=dev)
                for _ in range(8)]
    torch.cuda.synchronize()
    for i_f in (0, 1):
        want = encode_frame_core(*small, *zs, i_f, 5, **kw)
        got = M.encode_frame_device(*small, *zs, i_f, 5, **kw)
        torch.cuda.synchronize()
        nw = (int(want[4]) + 31) // 32
        assert int(got[4]) == int(want[4]) and not bool(got[5])
        assert torch.equal(got[3][:nw], want[3][:nw]), i_f
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b), i_f
    assert all(bool((j == -1).all()) for j in junk)
    graphs.clear()


@pytest.mark.parametrize("sync", ["item", "bool", "upload", "mask"])
def test_graph_capture_raises_on_sync(dev, sync):
    """A step that waits for the device makes its capture raise (no
    fallback to the eager step), and the caller's stream stays current."""
    x = torch.arange(8, device=dev)
    steps = {"item": lambda: x.sum().item(), "bool": lambda: bool(x.any()),
             "upload": lambda: torch.as_tensor(np.arange(8), device=dev) + x,
             "mask": lambda: x[x > 3]}
    stream = torch.cuda.current_stream(dev)
    with pytest.raises(RuntimeError):
        graphs.Step(steps[sync], dev)
    assert torch.cuda.current_stream(dev) == stream
    torch.cuda.synchronize()
    assert int(x.sum()) == 28


def test_graph_capture_frees_no_graph_while_capturing(dev):
    """A program dropped in a reference cycle is freed by the collector
    alone, and a graph freed while another step is captured resets there
    and invalidates the capture.  Here the old program becomes cyclic
    garbage inside the capture, with the collector set to run at every
    allocation and to reach the oldest generation (everything older frozen
    away): the capture still succeeds, as Step keeps the collector off
    while it captures, and the old program goes at the next collection."""
    x = torch.arange(8, device=dev)
    box = []

    def step():
        if torch.cuda.is_current_stream_capturing():
            box.clear()
            [[] for _ in range(20000)]     # survivors enough for a full collection
        return x + 1

    threshold = gc.get_threshold()
    gc.freeze()
    try:
        box.append(graphs.Step(lambda: x * 2, dev))
        box[0].cycle = box[0]
        gone = weakref.ref(box[0])
        gc.collect()
        gc.set_threshold(1, 1, 1)
        new = graphs.Step(step, dev)
    finally:
        gc.set_threshold(*threshold)
        gc.unfreeze()
    assert not box
    gc.collect()
    assert gone() is None
    assert torch.equal(new(), x + 1)


def test_graph_me_kernels_take_the_flag_from_device_memory(dev):
    """The motion kernels read the I/P flag from device memory: a 0-d bool
    or int tensor on the card gives what the bool gives, and one launch each."""
    cur, py, pu, pv = _me_planes(dev, 416, 64, "pan", 6)
    for is_i in (False, True):
        want = k_me.motion_estimate_fused(cur, py, pu, pv, is_i, 6, 3)
        for t in (torch.tensor(is_i, device=dev),
                  torch.tensor(5 if is_i else 0, dtype=torch.int32, device=dev)):
            _equal(_launched("me_fused", lambda: k_me.motion_estimate_fused(
                cur, py, pu, pv, t, 6, 3)), want)
            _equal(_launched("me_luma", lambda: k_me.motion_estimate(cur, py, t, 6)),
                   want[:4])


def test_graph_paths_never_run_the_plain_glue_or_subsample_on_the_card(dev, monkeypatch):
    """On the card the main path (encode_gop_scan, encode_frame_device and
    the eager encode_gop_scan_core), the shards (make_shards_encoder, and
    local_step with frame_tail) and BatchEncoder reach the glue and
    subsample kernels only: entropy.ac_inputs, entropy._header_rows and
    colorspace.subsample_420 raise here on a CUDA tensor, and every program
    is captured anew under that."""
    def card_guard(fn):
        def guarded(*args, **kwargs):
            if any(torch.is_tensor(a) and a.is_cuda for a in (*args, *kwargs.values())) \
                    or any(isinstance(a, torch.device) and a.type == "cuda" for a in args):
                raise AssertionError(f"{fn.__name__} ran on the card")
            return fn(*args, **kwargs)
        return guarded

    for mod, name in ((entropy, "ac_inputs"), (entropy, "_header_rows"),
                      (colorspace, "subsample_420")):
        monkeypatch.setattr(mod, name, card_guard(getattr(mod, name)))
    graphs.clear()
    w, h, kw = 416, 128, dict(yr=6, ur=3, q_level=2, row_cap=4096, frame_cap=65536)
    stacks = _stacks(dev, w, h, 3, 11)
    zy = torch.zeros((h, w), dtype=torch.uint8, device=dev)
    zc = torch.zeros((h // 2, w // 2), dtype=torch.uint8, device=dev)
    _build.reset_launches()
    M.encode_gop_scan(*stacks, zy, zc, zc, 0, 0, 2, **kw, seq_cap=65536)
    M.encode_gop_scan_core(*stacks, zy, zc, zc, 0, 0, 2, **kw, seq_cap=65536)
    M.encode_frame_device(*(t[0] for t in stacks), zy, zc, zc, 0, 0, **kw)
    shards = S.make_shards_encoder(dev, 4, h, w, **kw)
    shards(*(t[1] for t in stacks), zy, zc, zc, 1, 1)
    step = make_local_step(h // 16, yr=6, ur=3, q_level=2, row_cap=4096)
    rows = [step(*(t[2][32 * k:32 * (k + 1)] for t in stacks),
                 band_with_halo(zy, 8, 32 * k, 32 * (k + 1)),
                 band_with_halo(zc, 4, 16 * k, 16 * (k + 1)),
                 band_with_halo(zc, 4, 16 * k, 16 * (k + 1)), 2, 2, 2 * k) for k in range(4)]
    frame_tail(torch.cat([r[3] for r in rows]), torch.cat([r[4] for r in rows]),
               rows[0][5], 2, 2, row_cap=4096, frame_cap=65536)
    be = BatchEncoder(EncoderConfig(xl=5, yl=4), SequenceConfig(w, h, 2), 2, device=dev)
    be.push_chunks([[tuple(p[k].cpu().numpy() for p in stacks) for k in range(2)]] * 2)
    be.finish()
    torch.cuda.synchronize()
    assert _build.LAUNCHES["glue"] >= 10 and _build.LAUNCHES["subsample"] >= 10, \
        _build.LAUNCHES
    graphs.clear()


# ---- the sharded programs: local and tail graphs, collectives between -------

def _sharded_equal(got, want, tag):
    """Two frames' six outputs: recon, then payload bits and words."""
    nw = (int(want[4]) + 31) // 32
    assert not bool(got[5]) and not bool(want[5]), tag
    assert int(got[4]) == int(want[4]), tag
    assert torch.equal(got[3][:nw], want[3][:nw]), tag
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b), tag


@pytest.mark.parametrize("w,h", [(1920, 1152), (416, 64)])
def test_graph_me_pack_shard_programs_equal_core(dev, w, h):
    """The 4 one-process shard programs (make_shards_encoder: a local graph
    a shard, each at its own first_row, then the tail graph) equal
    encode_frame_core over 8 frames IPPP, each fed its recon back; under
    replay LAUNCHES counts the subsample, F, T and A 4 times a frame, the
    glue and P 5 (the shards' rows and the header rows) and M once."""
    kw = dict(yr=6, ur=3, q_level=2, row_cap=4096, frame_cap=262144)
    nf = 8
    enc = S.make_shards_encoder(dev, 4, h, w, **kw)
    stacks = _stacks(dev, w, h, nf, w + h)
    zy = torch.zeros((h, w), dtype=torch.uint8, device=dev)
    zc = torch.zeros((h // 2, w // 2), dtype=torch.uint8, device=dev)
    prev_c = prev_g = (zy, zc, zc)
    for k in range(nf):
        frame = [t[k] for t in stacks]
        want = encode_frame_core(*frame, *prev_c, k, k, **kw)
        _build.reset_launches()
        got = enc(*frame, *prev_g, torch.full((), k, dtype=torch.int32, device=dev), k)
        torch.cuda.synchronize()
        assert _build.LAUNCHES == {"subsample": 4, "me_fused": 4, "transform": 4,
                                   "glue": 5, "acsym": 4, "pack_slots": 5, "merge_rows": 1,
                                   "me_luma": 0, "chroma_pred": 0, "gop_carry": 0}, \
            _build.LAUNCHES
        _sharded_equal(got, want, k)
        prev_c, prev_g = want[:3], got[:3]
    assert all(graphs._programs[key].step._graph is not None for key in graphs._programs
               if key[0].startswith("shard") and key[1] == dev)


@contextlib.contextmanager
def _no_sync():
    """Raise on any operation that makes the host wait for the card (an
    .item(), a bool() or int() of a device tensor, a download, a pageable
    upload)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def _nccl_one_rank(tmp_path):
    """A one-rank NCCL process group of this process."""
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_graph_me_pack_one_rank_nccl_program_feeds_back(dev, tmp_path):
    """make_sharded_frame_encoder on a one-rank NCCL group: 16 frames of
    1920x1152 IPPP (GOP position wrapping at 5), each frame's recon passed
    straight back as the next prev (the halo copy and the replay that
    rewrites it are ordered on one stream), equal to encode_frame_device
    frame by frame; each frame counts the subsample, F, T, A and M once and
    the glue and P twice, and makes the host wait for the card nowhere."""
    w, h, nf = 1920, 1152, 16
    kw = dict(yr=6, ur=3, q_level=2, row_cap=4096, frame_cap=262144)
    stacks = _stacks(dev, w, h, nf, 77)
    zy = torch.zeros((h, w), dtype=torch.uint8, device=dev)
    zc = torch.zeros((h // 2, w // 2), dtype=torch.uint8, device=dev)
    with _nccl_one_rank(tmp_path):
        enc = S.make_sharded_frame_encoder(make_mesh(1, axis="slice", device="cuda"), h, w,
                                           **kw)
        prev_d = prev_s = (zy, zc, zc)
        for k in range(nf):
            frame = [t[k] for t in stacks]
            i_f = torch.full((), k % 6, dtype=torch.int32, device=dev)
            want = M.encode_frame_device(*frame, *prev_d, i_f, k, **kw)
            fno = torch.full((), k, dtype=torch.int32, device=dev)
            _build.reset_launches()
            with _no_sync():
                got = enc(*frame, *prev_s, i_f, fno)
            torch.cuda.synchronize()
            assert _build.LAUNCHES == {"subsample": 1, "me_fused": 1, "transform": 1,
                                       "glue": 2, "acsym": 1, "pack_slots": 2,
                                       "merge_rows": 1, "me_luma": 0, "chroma_pred": 0,
                                       "gop_carry": 0}, \
                _build.LAUNCHES
            _sharded_equal(got, want, k)
            prev_d, prev_s = tuple(t.clone() for t in want[:3]), got[:3]


def test_graph_me_pack_one_rank_nccl_batch_program(dev, tmp_path):
    """make_sharded_batch_encoder on a 1 x 1 NCCL mesh: 3 streams of 416x64
    in one block, (3,) int32 GOP state in different phases, 4 frames, each
    stream equal to encode_frame_device of its frames; the subsample, F, T,
    A and M 3 times a frame and the glue and P 6 times; the host waits for
    the card nowhere in a frame, the GOP state given as a tensor and as
    ints."""
    b, w, h, nf = 3, 416, 64, 4
    kw = dict(yr=6, ur=3, q_level=2, row_cap=4096, frame_cap=262144)
    stacks = [_stacks(dev, w, h, nf, 90 + s) for s in range(b)]
    zy = torch.zeros((h, w), dtype=torch.uint8, device=dev)
    zc = torch.zeros((h // 2, w // 2), dtype=torch.uint8, device=dev)
    with _nccl_one_rank(tmp_path):
        enc = S.make_sharded_batch_encoder(make_mesh2d(1, 1, device="cuda"), b, h, w, **kw)
        prev_b = (torch.zeros((b, h, w), dtype=torch.uint8, device=dev),
                  *(torch.zeros((b, h // 2, w // 2), dtype=torch.uint8, device=dev),) * 2)
        prev_s = [(zy, zc, zc)] * b
        for k in range(nf):
            i_f = [(k + s) % 3 for s in range(b)]
            planes = [torch.stack([st[i][k] for st in stacks]) for i in range(3)]
            i_t = torch.tensor(i_f, dtype=torch.int32, device=dev)
            _build.reset_launches()
            with _no_sync():
                got = enc(*planes, *prev_b, i_t, [k] * b)
            torch.cuda.synchronize()
            assert _build.LAUNCHES == {"subsample": 3, "me_fused": 3, "transform": 3,
                                       "glue": 6, "acsym": 3, "pack_slots": 6,
                                       "merge_rows": 3, "me_luma": 0, "chroma_pred": 0,
                                       "gop_carry": 0}, \
                _build.LAUNCHES
            for s in range(b):
                want = M.encode_frame_device(*(t[k] for t in stacks[s]), *prev_s[s], i_f[s],
                                             k, **kw)
                _sharded_equal(tuple(o[s] for o in got), want, (k, s))
                prev_s[s] = tuple(t.clone() for t in want[:3])
            prev_b = got[:3]


# ---- the gop program's carry kernel, its in-place recon and F's operand -----

def _carry_case(dev, i_frame, pframes, k, over):
    """Operands of the carry kernel: 74 rows (1920x1152) at exactly their
    cap of 16 words, one of them (row 40, past the first 32 lanes) 8 bits
    over where ``over`` is "row"; the merge's frame bits 3000, its overflow
    set where ``over`` is "frame"; the chunk's overflow already set where it
    is "sticky"; the sequence at 12345 bits; frame 1439; k of 64 frames."""
    row_bits = torch.full((74,), 32 * 16, dtype=torch.int64, device=dev)
    row_bits[40] += 8 if over == "row" else 0
    merge = (torch.tensor(3000, dtype=torch.int64, device=dev),
             torch.tensor(over == "frame", device=dev),
             torch.tensor(12345 + 3000, dtype=torch.int64, device=dev))

    def state():
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
        return ((torch.tensor(12345, dtype=torch.int64, device=dev),
                 torch.tensor(over == "sticky", device=dev), i32(i_frame), i32(pframes),
                 i32(1439), torch.tensor([k], dtype=torch.int64, device=dev)),
                (torch.full((64,), -1, dtype=torch.int64, device=dev),
                 torch.full((64,), -1, dtype=torch.int32, device=dev)))
    return row_bits, merge, state


@pytest.mark.parametrize("over", ["row", "frame", "sticky", "none"])
@pytest.mark.parametrize("k", [0, 63])
@pytest.mark.parametrize("i_frame,pframes", [(2, 2), (1, 2), (0, 2), (0, 0)])
def test_carry_kernel_equals_plain(dev, i_frame, pframes, k, over):
    """The carry kernel equals its plain version in every tensor it writes,
    one launch: the GOP wrap at i_frame = pframes and pframes 0, k at both
    ends of the per-frame outputs, the overflow from a row past lane 31,
    from the frame, carried from an earlier frame, or none (every row at
    exactly its cap is no overflow)."""
    row_bits, merge, state = _carry_case(dev, i_frame, pframes, k, over)
    got, want = state(), state()
    _launched("gop_carry", lambda: k_carry.gop_carry(row_bits, 16, *merge, *got))
    k_carry.plain_carry(row_bits, 16, *merge, *want)
    _equal(got[0] + got[1], want[0] + want[1])
    assert bool(got[0][1]) is (over != "none")


def test_carry_wrapper_checks_inputs(dev):
    """The carry's wrapper refuses operands of another dtype or shape and
    operands on two devices."""
    row_bits, merge, state = _carry_case(dev, 0, 2, 0, "none")
    (seq_bits, ovf, i_f, pf, fno, k), per_frame = state()
    with pytest.raises(TypeError, match="i_frame"):
        k_carry.gop_carry(row_bits, 16, *merge, (seq_bits, ovf, i_f.long(), pf, fno, k),
                          per_frame)
    with pytest.raises(ValueError, match="k"):
        k_carry.gop_carry(row_bits, 16, *merge, (seq_bits, ovf, i_f, pf, fno, k[0]), per_frame)
    with pytest.raises(ValueError, match="devices"):
        k_carry.gop_carry(row_bits.cpu(), 16, *merge, (seq_bits, ovf, i_f, pf, fno, k),
                          per_frame)


def _graph_ops(dev, fn, tmp_path):
    """The device operations (kernels, copies, fills) that one call of
    ``fn`` enqueues, the launches it counts and a replay to run it: the
    nodes of a CUDA graph of the call, one label each from
    ``cudaGraphDebugDotPrint`` (a kernel's label holds its name, a copy's
    MEMCPY, a fill's MEMSET), the call's tally and the graph's DOT text.
    The capture holds every operation the call enqueues and raises on one
    that waits for the device; the profiler's trace, late in a long
    process, now and then holds none of a short call's device events."""
    graph, tally = torch.cuda.CUDAGraph(keep_graph=True), {}      # the nodes outlive the capture
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with _build.tally_into(tally), torch.cuda.graph(graph, stream=stream):
        out = fn()
    torch.cuda.synchronize()
    path = tmp_path / "call.dot"
    graph.debug_dump(str(path))
    dot = path.read_text()
    labels = re.findall(r'"graph_\d+_node_\d+"\s*\[[^\]]*?label="(.*?)"\s*\]', dot, re.S)

    def replay():
        graph.replay()
        torch.cuda.synchronize()
        return out

    return replay, labels, tally, dot


@pytest.mark.parametrize("position", [0, 1, 7])
def test_graph_me_kernel_reads_the_gop_position_as_it_stands(dev, tmp_path, position):
    """motion_estimate_fused with ``position`` (a 0-d int32 GOP position,
    0 an I-frame) gives what ``is_iframe`` gives, in one launch and no other
    device operation, and a graph of the call reads the position as it
    stands at each replay; it refuses both operands, neither, or another
    dtype."""
    cur, py, pu, pv = _me_planes(dev, 416, 64, "pan", 6)
    want = k_me.motion_estimate_fused(cur, py, pu, pv, position == 0, 6, 3)
    other = k_me.motion_estimate_fused(cur, py, pu, pv, position != 0, 6, 3)
    t = torch.tensor(position, dtype=torch.int32, device=dev)
    replay, ops, tally, dot = _graph_ops(dev, lambda: k_me.motion_estimate_fused(
        cur, py, pu, pv, None, 6, 3, position=t), tmp_path)
    assert tally == {"me_fused": 1}, tally
    assert len(ops) == 1 and "me_fused_kernel" in ops[0], (ops, dot)
    _equal(replay(), want)
    t.fill_(1 if position == 0 else 0)
    _equal(replay(), other)
    for bad in (dict(is_iframe=True, position=t), dict(is_iframe=None)):
        with pytest.raises(ValueError, match="one of"):
            k_me.motion_estimate_fused(cur, py, pu, pv, yr=6, ur=3, **bad)
    with pytest.raises(TypeError, match="position"):
        k_me.motion_estimate_fused(cur, py, pu, pv, None, 6, 3, position=t.long())


def test_transform_kernel_recon_in_place(dev):
    """transform_recon(out=) writes the kernel's recon into the given
    planes and returns them, equal to the recon in new planes, one launch;
    it refuses an input as an output."""
    (y, u, v), mr = _frame_on(dev, 416, 64)
    args = (y, u, v, mr.pred_y, mr.pred_u, mr.pred_v, mr.inter, 2)
    want = k_tf.transform_recon(*args)
    out = (torch.full_like(y, 7), torch.full_like(u, 7), torch.full_like(v, 7))
    got = _launched("transform", lambda: k_tf.transform_recon(*args, out=out))
    assert all(g is o for g, o in zip(got[1:], out))
    _equal(got, want)
    with pytest.raises(ValueError, match="input"):
        k_tf.transform_recon(*args, out=(y, out[1], out[2]))


def _under_bits(words, bits):
    """The row words under each row's bits (its last partial word
    included), zero after them: all that pack_rows defines."""
    cols = torch.arange(words.shape[1], device=words.device)
    return torch.where(cols < (bits[:, None] + 31) // 32, words, 0)


def _freed_poisoned(dev, shape):
    """Free a block of ``shape`` int64 words, every bit set, into the
    caching allocator, where the next allocation of that shape on this
    stream lands; returns its address."""
    t = torch.full(shape, -1, dtype=torch.int64, device=dev)
    ptr = t.data_ptr()
    del t
    return ptr


@pytest.mark.parametrize("s", [3 + 394 * 26, 3 * TILE - 3, 2 * TILE + 1])
def test_pack_rows_equals_pack_slots(dev, s):
    """pack_rows packs the header rows and the slice rows, two operands, as
    pack_slots packs them stacked: the same words under each row's bits and
    the same bits, from one launch of the pack kernel, at a cap that
    overflows and one that does not.  The widths put the tiles of the
    operands' rows at other offsets than in the stacked grid."""
    slots = _slots(dev, 6, s, 7 + s)
    head, body = slots[:2].clone(), slots[2:].clone()
    for cap in (16, 4096):
        want = k_pack.pack_slots(slots, cap)
        words, bits = _launched("pack_slots", lambda: k_pack.pack_rows(head, body, cap))
        assert torch.equal(bits, want[1])
        assert torch.equal(_under_bits(words, bits), _under_bits(want[0], want[1]))
        assert bool(want[2]) is (cap == 16)


def _frame_grid(dev, w, h, seed):
    """A (nby, S) grid of slice rows at W x H, sparse as a real frame, whose
    rows 0, 1 and 2 end on a 32-bit boundary, one byte into a word and one
    bit into a word (padded to the byte): their last two slots set the
    rows' lengths mod 32."""
    nbx, nby = w // 16, h // 16
    s = entropy.HDR_SLOTS + entropy.SLOTS_PER_MB * nbx
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 25, (nby, s)).astype(np.int64)
    lens[rng.random((nby, s)) >= 0.03] = 0
    for row, rem in ((0, 0), (1, 8), (2, 1)):
        lens[row, -2:] = 0
        need = (rem - int(lens[row].sum())) % 32
        t = need if need >= 2 else need + 32
        lens[row, -2:] = (t // 2, t - t // 2)
    codes = rng.integers(0, 1 << 24, (nby, s)) & ((1 << lens) - 1)
    assert (lens[:3].sum(1) % 32).tolist() == [0, 8, 1]
    return torch.as_tensor((codes | lens << 27).astype(np.uint32).view(np.int32), device=dev)


@pytest.mark.parametrize("w,h", [(1920, 1152), (720, 576)])
@pytest.mark.parametrize("i_frame", [0, 1])
def test_pack_rows_poisoned_tails_merge_as_plain(dev, w, h, i_frame):
    """The gop program's rows at the bounds' row cap, in a buffer whose
    words were all ones, with every word past each row's last partial word
    set to 0xFFFFFFFF again afterwards: merge_append of them equals the
    plain merge_append of the plain rows, word for word, at every stage of
    the sequence's last word.  The header rows are the glue kernel's: a
    P-frame's GOP row is empty (i_frame 1); slice rows end on a 32-bit
    boundary, a byte into a word and a bit into one."""
    row_cap, frame_cap = M.bound_caps(w, h)
    body = _frame_grid(dev, w, h, w + i_frame)
    head = k_glue.header_rows(i_frame, 1441, body.shape[1], dev)
    r = head.shape[0] + body.shape[0]
    ptr = _freed_poisoned(dev, (r, row_cap))
    words, bits = _launched("pack_slots", lambda: k_pack.pack_rows(head, body, row_cap))
    assert words.data_ptr() == ptr
    pw, pb, _ = bitpack.pack_slots(torch.cat([head, body]), row_cap)
    assert torch.equal(bits, pb)
    assert (int(bits[0]) == 0) is bool(i_frame) and int(bits[1]) > 0
    assert [int(b) % 32 for b in bits[2:5]] == [0, 8, 8]
    assert torch.equal(_under_bits(words, bits), pw)
    cols = torch.arange(row_cap, device=dev)
    words = torch.where(cols < (bits[:, None] + 31) // 32, words, 0xFFFFFFFF)
    rng = np.random.default_rng(w)
    for seq_bits in (32 * 7, 32 * 7 + 13):
        seq = torch.as_tensor(random_sequence(rng, frame_cap + 64, seq_bits), device=dev)
        sb = torch.tensor(seq_bits, device=dev)
        got = _launched("merge_rows", lambda: k_pack.merge_append(seq.clone(), sb, words, bits,
                                                                 frame_cap))
        want = bitpack.merge_append(seq.clone(), sb, pw, pb, frame_cap)
        for g, x in zip(got, want):
            assert torch.equal(g, x), seq_bits


def test_pack_slots_rows_zero_to_cap(dev):
    """The public pack_slots keeps its rows whole: in a buffer whose words
    were all ones, every word from a row's bits up to the cap is zero, and
    the words and bits equal the plain version's."""
    slots = _slots(dev, 6, 3 + 394 * 26, 11, density=0.05)
    cap = 4096
    ptr = _freed_poisoned(dev, (6, cap))
    words, bits, _ = _launched("pack_slots", lambda: k_pack.pack_slots(slots, cap))
    assert words.data_ptr() == ptr
    for g, x in zip((words, bits), bitpack.pack_slots(slots, cap)):
        assert torch.equal(g, x)
    cols = torch.arange(cap, device=dev)
    assert not bool(((cols >= (bits[:, None] + 31) // 32) & (words != 0)).any())
    assert int(bits.max()) < 32 * cap // 2


def _gop_chunks(dev, w, h, pframes, i0, chunks, seed):
    """``chunks`` (a, b) of one clip through encode_gop_scan and through the
    eager encode_gop_scan_core, each call from the last one's recon, GOP
    position and frame number (the program fed its own outputs), at the
    bounds' caps; all ten outputs compared, and the launches of each call:
    each main-path kernel and the carry kernel once a frame.  Returns the
    frames' GOP positions."""
    row_cap, frame_cap = M.bound_caps(w, h)
    n = max(b - a for a, b in chunks)
    kw = dict(yr=6 if w > 720 else 4, ur=3 if w > 720 else 2, q_level=2, row_cap=row_cap,
              frame_cap=frame_cap, seq_cap=frame_cap * n)
    stacks = _stacks(dev, w, h, chunks[-1][1], seed)
    zy = torch.zeros((h, w), dtype=torch.uint8, device=dev)
    zc = torch.zeros((h // 2, w // 2), dtype=torch.uint8, device=dev)
    core, prog, positions = ((zy, zc, zc), i0, 1437), ((zy, zc, zc), i0, 1437), []
    for a, b in chunks:
        chunk = [t[a:b] for t in stacks]
        want = M.encode_gop_scan_core(*chunk, *core[0], core[1], core[2], pframes, **kw)
        _build.reset_launches()
        got = M.encode_gop_scan(*chunk, *prog[0], prog[1], prog[2], pframes, **kw)
        torch.cuda.synchronize()
        assert _build.LAUNCHES == {**{k: b - a for k in MAIN_PATH}, "me_luma": 0,
                                   "chroma_pred": 0, "gop_carry": b - a}, _build.LAUNCHES
        for k in range(3):
            assert torch.equal(got[k], want[k]), (a, k)
        nbits = int(want[4])
        assert int(got[4]) == nbits and not bool(got[7]) and not bool(want[7])
        nw = (nbits + 31) // 32
        assert torch.equal(got[3][:nw], want[3][:nw]), a
        assert (int(got[5]), int(got[6])) == (want[5], want[6])
        assert got[8].tolist() == want[8].tolist() and got[9].tolist() == want[9]
        core, prog = (want[:3], want[5], want[6]), (got[:3], got[5], got[6])
        positions += want[9]
    return positions


@pytest.mark.parametrize("w,h,pframes,i0", [(1920, 1152, 23, 21), (720, 576, 11, 9),
                                            (1920, 1152, 0, 0), (720, 576, 0, 0)])
def test_graph_carry_me_pack_chunks_equal_core(dev, w, h, pframes, i0):
    """Chunks of 5 and 4 frames at 1920x1152 (pframes 23) and 720x576
    (pframes 11), starting two frames before a GOP's end so that each
    crosses a GOP boundary, and I-frame-only chunks (pframes 0), through the
    gop program's graph equal the eager core: the recon written in place,
    the GOP position read by F as it stands and the carry kernel's GOP
    state, per-frame outputs and sequence bits; the second call takes the
    first call's outputs as its recon, GOP position and frame number."""
    graphs.clear()
    positions = _gop_chunks(dev, w, h, pframes, i0, ((0, 5), (5, 9)), w + pframes)
    assert positions == [(i0 + k) % (pframes + 1) for k in range(9)]
    assert positions[:5].count(0) == (5 if pframes == 0 else 1)
    graphs.clear()


@pytest.mark.parametrize("pframes,cut", [(1, 1), (0, 2)])
def test_graph_carry_me_pack_stream_equals_golden(dev, pframes, cut):
    """720x576 streams (vector level 2) through push_chunk, the gop
    program's graph, equal the golden model's: a frame, then 3 frames that
    cross a GOP boundary (I | P I P), and 2 I-frames in one chunk."""
    w, h, n = 720, 576, 4 if pframes else 2
    cfg = EncoderConfig(xl=6, yl=6, vector_level=2, q_level=2)
    frames = video(57, w, h, n)
    enc = Encoder(cfg, *M.bound_caps(w, h), device=dev)
    enc.start_sequence(SequenceConfig(w, h, pframes))
    _build.reset_launches()
    enc.push_chunk(frames[:cut])
    if cut < n:
        enc.push_chunk(frames[cut:])
    got = enc.finish()
    assert _build.LAUNCHES["gop_carry"] == n
    assert got == G.encode_sequence(cfg, SequenceConfig(w, h, pframes), frames)


@pytest.mark.parametrize("over", ["row", "frame"])
def test_graph_carry_overflow_retry_at_small_caps(dev, over):
    """A row over its cap, or a frame over its cap, sets the gop program's
    overflow flag as it sets the eager core's, and Encoder's retry at the
    bounds then gives the CPU encoder's stream."""
    w, h = 416, 64
    row_cap, frame_cap = M.bound_caps(w, h)
    caps = dict(row_cap=64, frame_cap=frame_cap) if over == "row" else \
        dict(row_cap=row_cap, frame_cap=256)
    kw = dict(yr=6, ur=3, q_level=2, seq_cap=frame_cap * 4, **caps)
    stacks = _stacks(dev, w, h, 4, 23, "noise")
    zy = torch.zeros((h, w), dtype=torch.uint8, device=dev)
    zc = torch.zeros((h // 2, w // 2), dtype=torch.uint8, device=dev)
    want = M.encode_gop_scan_core(*stacks, zy, zc, zc, 0, 0, 2, **kw)
    got = M.encode_gop_scan(*stacks, zy, zc, zc, 0, 0, 2, **kw)
    assert bool(got[7]) is bool(want[7]) is True
    assert got[8].tolist() == want[8].tolist() and int(got[4]) == int(want[4])
    cfg, frames = EncoderConfig(xl=5, yl=4), video(29, w, h, 8, "noise")
    profiling.COUNTS.clear()
    stream = Encoder(cfg, device=dev, **caps).encode(frames, w, h, 2, chunk_frames=4)
    assert profiling.COUNTS["overflow_retries"] == 2
    assert stream == Encoder(cfg, device="cpu", **caps).encode(frames, w, h, 2, chunk_frames=4)


def test_graph_carry_me_pack_replay_device_ops(dev, tmp_path):
    """A replay of the gop program's step is 8 device operations in the
    profiler's trace, those inside its ``replay.gop`` span on the device:
    the seven stage kernels (the subsample's stack entry, which reads the
    frame in place; the pack kernel, which reads the header rows and the
    slice rows where they were written) and the carry kernel; no cat, copy,
    fill or small elementwise kernel.  Four replays are traced (frames 2-5
    of the stack the program was handed, a slice of a longer one), and the
    fullest is held to that (the profiler now and then drops some of a
    short window's events), none with more.  A whole call of 4 frames
    copies device to device only the 3 recon planes it is handed, once."""
    graphs.clear()
    stacks = _stacks(dev, 416, 64, 6, 5)
    zy = torch.zeros((64, 416), dtype=torch.uint8, device=dev)
    zc = torch.zeros((32, 208), dtype=torch.uint8, device=dev)
    kw = dict(yr=6, ur=3, q_level=2, row_cap=4096, frame_cap=65536, seq_cap=262144)
    M.encode_gop_scan(*(s[:2] for s in stacks), zy, zc, zc, 0, 0, 2, **kw)
    (prog,) = [p for k, p in graphs._programs.items() if k[0] == "gop"]
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(4):
            prog.step()
        torch.cuda.synchronize()
    path = tmp_path / "replays.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    with torch.profiler.profile(activities=acts) as whole:
        M.encode_gop_scan(*(s[2:] for s in stacks), zy, zc, zc, 0, 0, 2, **kw)
        torch.cuda.synchronize()
    names = [e.name for e in whole.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("subsample_kernel_stack" in n for n in names), names
    assert sum("DtoD" in n for n in names) <= 3, names
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "gpu_user_annotation" and e.get("name") == "replay.gop"]
    ops = [(e["ts"], e["name"].replace("(anonymous namespace)::", "").split("(")[0])
           for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    per_replay = [sorted(n for t, n in ops if a <= t <= b) for a, b in spans]
    assert per_replay and all(len(r) <= 8 for r in per_replay), per_replay
    fullest = max(per_replay, key=len)
    assert len(fullest) == 8, per_replay
    for name in ("subsample_kernel_stack", "me_fused_kernel", "transform_kernel",
                 "glue_kernel", "acsym_kernel", "pack_slots_kernel", "merge_rows_kernel",
                 "gop_carry_kernel"):
        assert sum(name in op for op in fullest) == 1, (name, fullest)
    assert not any("CatArrayBatchedCopy" in op for r in per_replay for op in r), per_replay
    graphs.clear()


@pytest.mark.parametrize("layout", STACK_LAYOUTS)
def test_graph_subsample_stack_gop_scan_layouts(dev, layout):
    """encode_gop_scan on the card, its step reading each frame through the
    plane table, equals the eager encode_gop_scan_core (the subsample's
    direct entry on copies of the frames) in all ten outputs, over stacks in
    each layout its callers hand over: a contiguous slice at frame 2 of a
    longer stack, push_chunk's (F, 3, H, W) planes, three frame strides, and
    every other column, which it copies once.  frames_in_place and
    stack_copies count exactly that; each kernel launches once a frame."""
    w, h, f, pframes = 416, 64, 5, 2
    kw = dict(yr=6, ur=3, q_level=2, row_cap=4096, frame_cap=65536, seq_cap=262144)
    plain = _stacks(dev, w, h, f, 31 + len(layout))
    stacks = stack_layout(plain, layout)
    zy = torch.zeros((h, w), dtype=torch.uint8, device=dev)
    zc = torch.zeros((h // 2, w // 2), dtype=torch.uint8, device=dev)
    want = M.encode_gop_scan_core(*plain, zy, zc, zc, 1, 1437, pframes, **kw)
    graphs.clear()
    before = dict(profiling.COUNTS)
    _build.reset_launches()
    got = M.encode_gop_scan(*stacks, zy, zc, zc, 1, 1437, pframes, **kw)
    torch.cuda.synchronize()
    counted = {k: profiling.COUNTS.get(k, 0) - before.get(k, 0)
               for k in ("frames_in_place", "stack_copies")}
    assert counted == ({"frames_in_place": 0, "stack_copies": 3} if layout == "strided"
                       else {"frames_in_place": f, "stack_copies": 0})
    assert _build.LAUNCHES == {**{k: f for k in MAIN_PATH}, "me_luma": 0, "chroma_pred": 0,
                               "gop_carry": f}, _build.LAUNCHES
    for k in range(3):
        assert torch.equal(got[k], want[k]), k
    nw = (int(want[4]) + 31) // 32
    assert int(got[4]) == int(want[4]) and torch.equal(got[3][:nw], want[3][:nw])
    assert (int(got[5]), int(got[6])) == (want[5], want[6]) == (0, 1442)
    assert bool(got[7]) is bool(want[7]) is False
    assert got[8].tolist() == want[8].tolist() and got[9].tolist() == want[9]
    graphs.clear()


def test_graph_subsample_stack_batch_streams_back_to_back(dev):
    """Eight streams of different content through encode_gops_batched, one
    gop program whose plane table each stream's call writes again with no
    wait between the calls (in stream order after the last stream's
    replays): each stream's payload, recon, GOP state and frames' bits equal
    the eager encode_gop_scan_core of that stream alone."""
    w, h, n, streams, pframes = 416, 64, 4, 8, 2
    kw = dict(yr=6, ur=3, q_level=2, row_cap=4096, frame_cap=65536, seq_cap=262144)
    videos = [video(90 + b, w, h, n, "noise" if b % 3 == 1 else "pan") for b in range(streams)]
    planes = [torch.as_tensor(np.stack([np.stack([f[p] for f in v]) for v in videos]),
                              device=dev) for p in range(3)]
    zy = torch.zeros((streams, h, w), dtype=torch.uint8, device=dev)
    zc = torch.zeros((streams, h // 2, w // 2), dtype=torch.uint8, device=dev)
    i0, f0 = [b % 3 for b in range(streams)], [100 * b for b in range(streams)]
    graphs.clear()
    ry, ru, rv, sw, sb, i_f, fno, ovf, fbits, fifs = encode_gops_batched(
        *planes, zy, zc, zc, i0, f0, pframes, **kw)
    assert not bool(ovf.any())
    for b in range(streams):
        want = M.encode_gop_scan_core(*(p[b] for p in planes), zy[b], zc[b], zc[b], i0[b],
                                      f0[b], pframes, **kw)
        nb = int(want[4])
        assert int(sb[b]) == nb and torch.equal(sw[b, :(nb + 31) // 32],
                                               want[3][:(nb + 31) // 32]), b
        for mine, theirs in zip((ry[b], ru[b], rv[b]), want[:3]):
            assert torch.equal(mine, theirs), b
        assert (i_f[b], fno[b]) == (want[5], want[6]) and fifs[b] == want[9], b
        assert fbits[b].tolist() == want[8].tolist(), b
    graphs.clear()


def _channels(dev, w, h, streams, n, seed):
    """(B, n, H, W) stacks on the card of ``streams`` channels whose
    content differs (noise in every third, a panning texture elsewhere)."""
    videos = [video(seed + b, w, h, n, "noise" if b % 3 == 1 else "pan")
              for b in range(streams)]
    return [torch.as_tensor(np.stack([np.stack([f[p] for f in v]) for v in videos]),
                            device=dev) for p in range(3)]


def _batch_kw(w, h, n):
    row_cap, frame_cap = M.bound_caps(w, h)
    return dict(yr=4, ur=2, q_level=2, row_cap=row_cap, frame_cap=frame_cap,
                seq_cap=frame_cap * n)


def _each_channel_equals_core(got, stacks, prev, i0, f0, pframes, kw):
    """Channel b of encode_gops_batched's outputs ``got`` equals the eager
    encode_gop_scan_core of channel b alone from (prev[.][b], i0[b], f0[b]):
    payload, recon, GOP state, frames' bits and types.  Returns the cores'
    recons, (B, ...) each."""
    ry, ru, rv, sw, sb, i_f, fno, ovf, fbits, fifs = got
    assert not bool(ovf.any())
    recons = []
    for b in range(len(i0)):
        want = M.encode_gop_scan_core(*(s[b] for s in stacks), *(p[b] for p in prev), i0[b],
                                      f0[b], pframes, **kw)
        nw = (int(want[4]) + 31) // 32
        assert int(sb[b]) == int(want[4]) and torch.equal(sw[b, :nw], want[3][:nw]), b
        for mine, theirs in zip((ry[b], ru[b], rv[b]), want[:3]):
            assert torch.equal(mine, theirs), b
        assert (i_f[b], fno[b]) == (want[5], want[6]) and fifs[b] == want[9], b
        assert fbits[b].tolist() == want[8].tolist(), b
        recons.append(want[:3])
    return tuple(torch.stack([r[p] for r in recons]) for p in range(3))


@pytest.mark.parametrize("w, h", [(416, 64), (720, 576)])
@pytest.mark.parametrize("streams", [1, 3, 8])
def test_graph_batch_program_equals_single_streams(dev, w, h, streams):
    """The batch program (encode_gops_batched's default: one graph a
    frame-step, one branch a channel) equals B eager encode_gop_scan_core
    runs byte for byte, from GOP positions and frame numbers that differ
    between the channels; it is captured once, each main-path kernel and the
    carry kernel count once a channel and frame, and a call enqueues its 5
    frame-steps' replays and the call's 10 operations."""
    n, pframes = 5, 2
    kw = _batch_kw(w, h, n)
    stacks = _channels(dev, w, h, streams, n, 70 + streams)
    zy = torch.zeros((streams, h, w), dtype=torch.uint8, device=dev)
    zc = torch.zeros((streams, h // 2, w // 2), dtype=torch.uint8, device=dev)
    i0, f0 = [b % 3 for b in range(streams)], [1437 + b for b in range(streams)]
    graphs.clear()
    before = dict(profiling.COUNTS)
    _build.reset_launches()
    got = encode_gops_batched(*stacks, zy, zc, zc, i0, f0, pframes, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES == {**{k: streams * n for k in MAIN_PATH}, "me_luma": 0,
                               "chroma_pred": 0, "gop_carry": streams * n}, _build.LAUNCHES
    counted = {k: profiling.COUNTS.get(k, 0) - before.get(k, 0)
               for k in ("graph_captures", "host_launches", "batch_streams")}
    assert counted == {"graph_captures": 1, "host_launches": n + 10,
                       "batch_streams": streams}, counted
    assert [k[0] for k in graphs._programs] == ["gop_batch"]
    _each_channel_equals_core(got, stacks, (zy, zc, zc), i0, f0, pframes, kw)
    graphs.clear()


def test_graph_batch_program_carries_state_across_calls(dev):
    """Three successive calls of the batch program (chunks of 3, 4 and 2
    frames of 3 channels), the first from mid-GOP positions and frame
    numbers, each later one from the recon and GOP state the last call
    returned (the program's own tensors, passed back): each channel equals
    its own chain of eager encode_gop_scan_core calls, and the later calls
    copy no recon."""
    w, h, streams, pframes = 416, 64, 3, 2
    kw = _batch_kw(w, h, 4)
    stacks = _channels(dev, w, h, streams, 9, 50)
    zy = torch.zeros((streams, h, w), dtype=torch.uint8, device=dev)
    zc = torch.zeros((streams, h // 2, w // 2), dtype=torch.uint8, device=dev)
    graphs.clear()
    batch = core = ((zy, zc, zc), [2, 1, 0], [1439, 7, 0])
    first = 0
    for n in (3, 4, 2):
        chunk = [s[:, first:first + n] for s in stacks]
        before = profiling.COUNTS.get("host_launches", 0)
        got = encode_gops_batched(*chunk, *batch[0], batch[1], batch[2], pframes, **kw)
        launches = profiling.COUNTS["host_launches"] - before
        assert launches == n + (10 if first == 0 else 7), (first, launches)
        recons = _each_channel_equals_core(got, chunk, *core, pframes, kw)
        batch, core = (got[:3], got[5], got[6]), (recons, got[5], got[6])
        first += n
    assert batch[2] == [1448, 16, 9]
    graphs.clear()


@pytest.mark.parametrize("w, h", [(416, 64), (720, 576)])
def test_graph_pack_batch_program_repeats_exactly(dev, w, h):
    """The same call of 8 channels 20 times over gives the same outputs
    each time, equal to the first's: the concurrent branches share no
    look-back buffer and no temporary (a race would change bytes now and
    then)."""
    streams, n, pframes = 8, 6, 2
    kw = _batch_kw(w, h, n)
    stacks = _channels(dev, w, h, streams, n, 11)
    zy = torch.zeros((streams, h, w), dtype=torch.uint8, device=dev)
    zc = torch.zeros((streams, h // 2, w // 2), dtype=torch.uint8, device=dev)
    args = (*stacks, zy, zc, zc, [0] * streams, list(range(streams)), pframes)
    graphs.clear()
    first = [v.clone() if torch.is_tensor(v) else v
             for v in encode_gops_batched(*args, **kw)]
    for rep in range(20):
        got = encode_gops_batched(*args, **kw)
        for a, b in zip(got, first):
            assert (a == b) if isinstance(a, list) else torch.equal(a, b), rep
    graphs.clear()


def test_graph_pack_batch_program_lookback_a_branch(dev):
    """The batch program's branches run on streams of their own, apart
    from each other and from the side stream, and after the capture
    ops/kernels/pack._lookback holds one look-back buffer for each of
    them."""
    streams, w, h = 8, 416, 64
    kw = _batch_kw(w, h, 2)
    stacks = _channels(dev, w, h, streams, 2, 21)
    zy = torch.zeros((streams, h, w), dtype=torch.uint8, device=dev)
    zc = torch.zeros((streams, h // 2, w // 2), dtype=torch.uint8, device=dev)
    graphs.clear()
    out = encode_gops_batched(*stacks, zy, zc, zc, [0] * streams, [0] * streams, 2, **kw)
    (prog,) = graphs._programs.values()
    handles = [s.cuda_stream for s in prog.step._branches]
    assert len(set(handles)) == streams
    assert graphs._side_stream(out[3].device).cuda_stream not in handles
    buffers = [k_pack._lookback.get((out[3].device, s)) for s in handles]
    assert all(b is not None for b in buffers)
    assert len({b.data_ptr() for b in buffers}) == streams
    graphs.clear()


def test_graph_batch_program_given_a_program_loops(dev, tmp_path):
    """With a program given, encode_gops_batched keeps its loop over the
    channels: a batch.stream and a batch.collect span a channel, 10 copies
    of each channel's outputs, and the same outputs as the batch program,
    which records no batch.stream."""
    streams, n, w, h = 3, 3, 416, 64
    kw = _batch_kw(w, h, n)
    stacks = _channels(dev, w, h, streams, n, 31)
    zy = torch.zeros((streams, h, w), dtype=torch.uint8, device=dev)
    zc = torch.zeros((streams, h // 2, w // 2), dtype=torch.uint8, device=dev)
    args = (*stacks, zy, zc, zc, [1] * streams, [0] * streams, 2)
    graphs.clear()
    runs = {}
    for path, given in (("batch", {}), ("loop", dict(program=M.encode_gop_scan))):
        encode_gops_batched(*args, **kw, **given)           # the capture
        profiling.reset()
        try:
            with profiling.trace_to(str(tmp_path / f"{path}.json")):
                out = encode_gops_batched(*args, **kw, **given)
            spans, counts = profiling.traced()
        finally:
            profiling.reset()
        runs[path] = ([v.clone() if torch.is_tensor(v) else v for v in out], spans, counts)
    (batch, bspans, bcounts), (loop, lspans, lcounts) = runs["batch"], runs["loop"]
    assert lspans["batch.stream"][0] == lspans["batch.collect"][0] == streams
    assert lspans["replay.gop"][0] == streams * n and "replay.gop_batch" not in lspans
    assert lcounts["host_launches"] == streams * (n + 18 + 10)
    assert "batch.stream" not in bspans and bspans["batch.collect"][0] == 1
    assert bspans["gop.feed"][0] == bspans["replay.gop_batch"][0] == n
    assert bcounts["host_launches"] == n + 10
    for a, b in zip(batch, loop):
        assert (a == b) if isinstance(a, list) else torch.equal(a, b)
    graphs.clear()
