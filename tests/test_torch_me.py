"""The port's motion estimation in its three forms - the fused stage, the
luma/chroma split and the band form - against the JAX package: its XLA
formulation, and its Pallas kernels run by the Pallas interpreter.

On CPU tensors the port's kernel wrappers (ops/kernels/me.py) run the plain
versions of ops/motion.py, so these tests hold the wrappers' argument
handling (halo, band position, planes or tiles) and the plain arithmetic
that the CUDA kernels are held to on the card (tests/test_torch_cuda.py).
Every comparison is exact: this is an integer codec.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from fpga_mpeg2_encoder_tpu.ops import motion as jmotion
from fpga_mpeg2_encoder_tpu.ops.pallas import me as jk_me
from fpga_mpeg2_encoder_tpu_torch.ops import motion
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import _build
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import me as k_me
from fpga_mpeg2_encoder_tpu_torch.utils.testdata import chroma_maps

_jax_whole = jax.jit(jmotion.estimate_and_predict, static_argnums=(7, 8))


@pytest.fixture
def interpret_me():
    saved = jk_me._INTERPRET
    jk_me._INTERPRET = True
    yield
    jk_me._INTERPRET = saved


def _planes(w, h, seed, backward=False):
    """Reference and current 4:2:0 planes of a panning texture (real motion
    down and right, or up and left when ``backward``): (y0, u0, v0, y1)
    uint8 numpy arrays, chroma at half resolution."""
    rng = np.random.default_rng(seed)
    pad = 32
    yy, xx = np.mgrid[0:h + pad, 0:w + pad]
    tex = rng.integers(0, 48, (h + pad, w + pad))
    y = (((xx * 3 + yy * 2) // 4) % 200 + tex).astype(np.uint8)
    u = ((xx - yy) // 3 % 160 + 48).astype(np.uint8)
    v = ((xx + yy) // 5 % 120 + 64).astype(np.uint8)
    (a, b), (c, d) = ((2, 3), (0, 0)) if backward else ((0, 0), (2, 3))
    y0, u0, v0 = (p[a:a + h, b:b + w] for p in (y, u, v))
    return (y0.copy(), u0[::2, ::2].copy(), v0[::2, ::2].copy(),
            y[c:c + h, d:d + w].copy())


def _off_edge(kind, w, h, seed):
    """(cur, prev) luma of noise whose exact match lies where the reference
    must not take it: inward (moving 2 rows down, black entering at the top:
    the top MB row's full-pel match lies above the frame), half-left (moving
    half a pixel right, black entering at the left: the left MB column's
    half-pel match lies off the frame), stripes (even rows constant along x,
    moving half a pixel down: the half-pel candidates, diagonals included,
    tie left to right, and the tournament keeps the lower index)."""
    prev = np.random.default_rng(seed).integers(0, 256, (h, w))
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
    return cur.astype(np.uint8), prev.astype(np.uint8)


def _content(kind, w, h, seed, yr):
    """(y1, u1, v1, y0, u0, v0) 4:2:0 planes: flat (every SAD ties), noise
    (every SAD above 4095), white (near-white with dark specks: the pixel
    sum plus the mean deviation wraps the 16-bit intra accumulator), far-
    and far+ (smooth content moving yr + 1 pixels up and left, or down and
    right: past the search range, where the half-pel step beyond +-yr must
    stay masked), or one of _off_edge's."""
    rng = np.random.default_rng(seed)
    shapes = [(h, w), (h // 2, w // 2), (h // 2, w // 2)] * 2
    if kind in ("inward", "half-left", "stripes"):
        cur, prev = _off_edge(kind, w, h, seed)
        return [cur, cur[::2, ::2], cur[1::2, 1::2], prev, prev[::2, ::2], prev[1::2, 1::2]]
    if kind.startswith("far"):
        s = (yr + 1) * (1 if kind == "far-" else -1)
        yy, xx = np.mgrid[-16:h + 16, -16:w + 16]
        base = (128 + 60 * np.sin(xx / 5.0) + 50 * np.cos(yy / 7.0)).astype(np.uint8)
        prev, cur = base[16:16 + h, 16:16 + w], base[16 - s:16 - s + h, 16 - s:16 - s + w]
        return [cur, cur[::2, ::2], cur[1::2, 1::2], prev, prev[::2, ::2], prev[1::2, 1::2]]
    if kind == "flat":
        return [np.full(s, 100, np.uint8) for s in shapes]
    if kind == "noise":
        return [rng.integers(0, 256, s, dtype=np.uint8) for s in shapes]
    return [np.where(rng.random(s) < 0.06, 0, 255).astype(np.uint8) for s in shapes]


def _assert_equal(got, want):
    """Values equal the JAX outputs (whose predictions are int32); the
    port's predictions, the last three of six outputs, are uint8."""
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g.numpy(), np.asarray(w)), f"output {k}"
    if len(got) == 6:
        assert all(p.dtype == torch.uint8 for p in got[3:])


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("as_planes", [False, True])
@pytest.mark.parametrize("backward", [False, True])
def test_middle_band_matches_jax(as_planes, backward):
    """The band form: MB rows 2..5 of 8 at 96x128, halos cut from the
    frame; the band's seams are not frame edges.  The motion runs down or
    up, so the best candidates of the band's bottom or top row lie across
    a seam."""
    w, h, r0, r1 = 96, 128, 2, 6
    y0, u0, v0, y1 = _planes(w, h, 41, backward)
    band = (y1[16 * r0:16 * r1], y0[16 * r0 - 8:16 * r1 + 8],
            u0[8 * r0 - 4:8 * r1 + 4], v0[8 * r0 - 4:8 * r1 + 4])
    got = motion.estimate_and_predict_local(*_t(*band), False, 6, 3, r0, h // 16,
                                            as_planes)
    want = jmotion.estimate_and_predict_local(
        *(jnp.asarray(a) for a in band), jnp.asarray(False), 6, 3, jnp.int32(r0),
        jnp.int32(h // 16), as_planes)
    assert got.inter.any() and (got.mvy != 0).any()
    _assert_equal(got, want)
    _assert_equal(k_me.estimate_and_predict_local(*_t(*band), False, 6, 3, r0, h // 16,
                                                  as_planes), want)


@pytest.mark.parametrize("is_iframe", [False, True])
def test_luma_then_chroma_equals_whole_frame(is_iframe):
    y0, u0, v0, y1 = _planes(96, 64, 5)
    cur, py, pu, pv = _t(y1, y0, u0, v0)
    whole = motion.estimate_and_predict(cur, None, None, py, pu, pv, is_iframe, 6, 3)
    luma = motion.estimate_luma(cur, motion.pad_halo(py, 8), is_iframe, 6, 0, 4)
    chroma = motion.chroma_pred(motion.pad_halo(pu, 4), motion.pad_halo(pv, 4),
                                *luma[:3], 3)
    for g, w in zip(luma + chroma, whole):
        assert torch.equal(g, w)


@pytest.mark.parametrize("vl", [1, 2, 3])
@pytest.mark.parametrize("kind", ["flat", "noise", "white", "far-", "far+", "inward",
                                  "half-left", "stripes"])
def test_edge_content_matches_jax(vl, kind):
    """Contents that reach the exactness traps: ties everywhere (tie-break
    and edge masks), all candidates invalid (-> mv (0, 0) and the 0x1000
    substitute), the 16-bit intra accumulator's wrap, motion past the
    search range (the half-pel masks at mv_full == +-yr), exact matches off
    the top and left edges (the full-pel and half-pel edge masks), and
    half-pel ties (the tournament's pairs)."""
    yr, ur = 2 * vl, vl
    planes = _content(kind, 64, 64, vl, yr)
    for is_iframe in (False, True):
        got = motion.estimate_and_predict(*_t(*planes), is_iframe, yr, ur)
        want = _jax_whole(*(jnp.asarray(p) for p in planes), jnp.asarray(is_iframe),
                          yr, ur)
        _assert_equal(got, want)
    blk = planes[0].reshape(4, 16, 4, 16).transpose(0, 2, 1, 3).astype(np.int64)
    pixsum = blk.sum((2, 3))
    sad_mean = np.abs(blk - ((pixsum >> 8) & 0xFF)[:, :, None, None]).sum((2, 3))
    if kind == "white":
        assert (pixsum + sad_mean > 0xFFFF).all()
    got = motion.estimate_and_predict(*_t(*planes), False, yr, ur)
    if kind == "noise":
        assert not got.inter.any() and not got.mvx.any() and not got.mvy.any()
    if kind == "flat":         # ties: the largest dy wins, and the centre half-pel
        assert got.inter.all() and got.mvy.max() == 2 * yr
    if kind.startswith("far"):   # saturated at the range, the half step masked
        sign = -1 if kind == "far-" else 1
        assert (got.mvx == sign * 2 * yr).any() and (got.mvy == sign * 2 * yr).any()
    if kind == "inward":         # the match above the top edge is masked
        assert not got.inter[0].any() and (got.mvy[1:] == -4).all()
    if kind == "half-left":      # the half step off the left edge is masked
        assert not got.inter[:, 0].any() and (got.mvx[:, 1:] == -1).all()
    if kind == "stripes":        # (-1, -1) ties (-1, 0) and wins
        assert (got.mvx[1:, 1:] == -1).all() and (got.mvy[1:, 1:] == -1).all()


@pytest.mark.parametrize("halo", [False, True])
@pytest.mark.parametrize("form", ["fused", "split"])
def test_wrappers_match_jax_kernels_interpreted(interpret_me, form, halo):
    """The port's fused, luma and chroma wrappers on CPU tensors against the
    JAX package's fused kernel and its split pair in the Pallas interpreter.
    With ``halo`` the input is a band of MB rows 1..4 of a 96x96 frame and
    the predictions come back as planes; without, a whole 96x64 frame and
    tiles."""
    yr, ur = 6, 3
    if halo:
        y0, u0, v0, y1 = _planes(96, 96, 9)
        r0, r1, total = 1, 5, 6
        args = (y1[16 * r0:16 * r1], y0[16 * r0 - 8:16 * r1 + 8],
                u0[8 * r0 - 4:8 * r1 + 4], v0[8 * r0 - 4:8 * r1 + 4])
    else:
        y0, u0, v0, y1 = _planes(96, 64, 8)
        r0, total = 0, 4
        args = (y1, y0, u0, v0)
    kw = dict(first_mb_row=r0, total_mb_rows=total, halo=halo, as_plane=halo)
    jkw = dict(first_mb_row=jnp.int32(r0), total_mb_rows=jnp.int32(total), halo=halo,
               as_plane=halo)
    cur, py, pu, pv = _t(*args)
    jcur, jpy, jpu, jpv = (jnp.asarray(a) for a in args)
    before = dict(_build.LAUNCHES)
    if form == "fused":
        got = k_me.motion_estimate_fused(cur, py, pu, pv, False, yr, ur, **kw)
        want = jk_me.motion_estimate_fused_pallas(jcur, jpy, jpu, jpv, jnp.asarray(False),
                                                  yr, ur, **jkw)
    else:
        luma = k_me.motion_estimate(cur, py, False, yr, **kw)
        got = luma + k_me.chroma_pred(pu, pv, *luma[:3], ur, halo=halo, as_plane=halo)
        jluma = jk_me.motion_estimate_pallas(jcur, jpy, jnp.asarray(False), yr, **jkw)
        want = tuple(jluma) + tuple(jk_me.chroma_pred_pallas(
            jpu, jpv, *jluma[:3], ur, halo=halo, as_plane=halo))
    assert _build.LAUNCHES == before        # CPU tensors: the plain versions ran
    assert got[0].any()
    _assert_equal(got, want)


@pytest.mark.parametrize("as_plane", [False, True])
@pytest.mark.parametrize("halo", [False, True])
def test_predictions_are_uint8(halo, as_plane):
    """Every motion function, plain and wrapper, returns uint8 predictions
    whose values are the int32 computation's: the transform reads uint8."""
    y0, u0, v0, y1 = _planes(64, 64, 3)
    cur, py, pu, pv = _t(y1, y0, u0, v0)
    if halo:
        py, pu, pv = motion.pad_halo(py, 8), motion.pad_halo(pu, 4), motion.pad_halo(pv, 4)
    kw = dict(halo=halo, as_plane=as_plane)
    for is_i in (False, True):
        fused = k_me.motion_estimate_fused(cur, py, pu, pv, is_i, 6, 3, **kw)
        luma = k_me.motion_estimate(cur, py, is_i, 6, **kw)
        chroma = k_me.chroma_pred(pu, pv, *luma[:3], 3, **kw)
        hy, hu, hv = (py, pu, pv) if halo else (motion.pad_halo(py, 8),
                                                 motion.pad_halo(pu, 4),
                                                 motion.pad_halo(pv, 4))
        plain = motion.estimate_and_predict_local(cur, hy, hu, hv, is_i, 6, 3, 0, 4, as_plane)
        for preds in (fused[3:], (luma[3],) + chroma, plain[3:]):
            assert all(p.dtype == torch.uint8 for p in preds)
        for a, b in zip(fused, plain):
            assert torch.equal(a, b)
        assert is_i or plain.inter.any()


@pytest.mark.parametrize("halo,as_plane", [(False, False), (False, True), (True, False),
                                           (True, True)])
def test_chroma_pred_edges_match_jax_kernel_interpreted(interpret_me, halo, as_plane):
    """The chroma half (plain version, and the wrapper on CPU tensors)
    against the JAX package's chroma kernel in the Pallas interpreter, at
    4x5 macroblocks (odd nbx): random maps with every (hx, hy) and vectors
    from -2*yr to 2*yr + 1 half-pels, the edge macroblocks pointing out of
    the plane (zero columns and rows, or the band's halo rows).  The JAX
    kernel's window holds mv >> 2 in [-ur, ur] (the search gives |mv| <=
    2*yr); the card's tests take the range out to -(2*yr + 1)."""
    ur, yr, nby, nbx = 3, 6, 4, 5
    rng = np.random.default_rng(5)
    pu, pv = (rng.integers(0, 256, (nby * 8 + 8 * halo, nbx * 8), dtype=np.uint8)
              for _ in range(2))
    maps = chroma_maps(nby, nbx, -2 * yr, 2 * yr + 1, 7)
    want = jk_me.chroma_pred_pallas(*(jnp.asarray(a) for a in (pu, pv) + maps), ur,
                                    halo=halo, as_plane=as_plane)
    args = _t(pu, pv, *maps)
    got = k_me.chroma_pred(*args, ur, halo=halo, as_plane=as_plane)
    _assert_equal(got, want)
    hu, hv = args[:2] if halo else (motion.pad_halo(args[0], 4), motion.pad_halo(args[1], 4))
    plain = motion.chroma_pred(hu, hv, *args[2:], ur)
    _assert_equal(tuple(map(motion.to_planes, plain)) if as_plane else plain, want)
    assert all(g.dtype == torch.uint8 for g in got)


@pytest.mark.parametrize("nby,nbx,sms,want", [
    (72, 120, 132, 4),    # 1920x1152, the hd cells: 2160 blocks of 4 on an H100
    (36, 45, 132, 2),     # 720x576, the sd cells: 828 blocks of 2 (432 of 4 are too few)
    (18, 120, 132, 4),    # a quarter band of 1920x1152, a shard's
    (4, 4, 132, 1), (2, 128, 132, 1), (4, 26, 132, 1),    # the card tests' small frames
    (4, 4, 1, 4), (4, 6, 3, 2), (1, 1, 1, 1), (0, 5, 132, 1)])
def test_strip_width(nby, nbx, sms, want):
    """The motion kernels' strip (macroblocks a block) from the macroblock
    grid and the card's SM count: the widest of 4, 2 and 1 whose grid gives
    every SM four blocks, and 1 when none does."""
    got = k_me.strip_width(nby, nbx, sms)
    assert got == want
    assert got == 1 or nby * -(-nbx // got) >= 4 * sms
    assert got == k_me.MAX_STRIP or nby * -(-nbx // (2 * got)) < 4 * sms

