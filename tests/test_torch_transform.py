"""The port's transform (ops/dct.py, the plain version of the transform
kernel) against the JAX package: the fused Pallas kernel in interpret mode,
the XLA coefficient-major path, and the golden per-tile model.  All equality
is exact: this is an integer codec."""
import os
import re

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from fpga_mpeg2_encoder_tpu.core import tables as T
from fpga_mpeg2_encoder_tpu.golden import encoder as G
from fpga_mpeg2_encoder_tpu.models import encoder as M
from fpga_mpeg2_encoder_tpu.ops import dct as jdct
from fpga_mpeg2_encoder_tpu.ops import entropy as jentropy
from fpga_mpeg2_encoder_tpu.ops.pallas import transform as k_tf
from fpga_mpeg2_encoder_tpu_torch.core import tables as port_tables
from fpga_mpeg2_encoder_tpu_torch.ops import dct
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import _build
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import transform as port_kernel


@pytest.fixture
def interpret_transform():
    saved = k_tf._INTERPRET
    k_tf._INTERPRET = True
    yield
    k_tf._INTERPRET = saved


def _inputs(seed, w=96, h=64):
    rng = np.random.default_rng(seed)
    cur = [rng.integers(0, 256, s).astype(np.uint8)
           for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    pred = [rng.integers(0, 256, p.shape).astype(np.int32) for p in cur]
    inter = rng.random((h // 16, w // 16)) < 0.5
    return cur, pred, inter


def _port(cur, pred, inter, q_level):
    """The port takes the predictions as uint8 (the JAX package as int32)."""
    out = dct.transform_recon(*(torch.from_numpy(p.astype(np.uint8)) for p in cur + pred),
                              torch.from_numpy(inter), q_level)
    return [o.numpy() for o in out]


def _xla(cur, pred, inter, q_level):
    """The JAX package's coefficient-major path (models/encoder.py)."""
    h, w = cur[0].shape
    nby, nbx = h // 16, w // 16
    blk = [M._blockify(jnp.asarray(p, jnp.int32), 16 if i == 0 else 8)
           for i, p in enumerate(cur)]
    pblk = [M._blockify(jnp.asarray(p), 16 if i == 0 else 8)
            for i, p in enumerate(pred)]
    cur_t, pred_t = M._tiles(*blk), M._tiles(*pblk)
    inter_t = jnp.repeat(jnp.asarray(inter).reshape(-1), 6)
    q = jdct.quantize(jdct.fdct((cur_t - pred_t).reshape(-1, 64).T), inter_t, q_level)
    rres = jdct.idct(jdct.dequantize(q, inter_t, q_level))
    recon_t = jnp.clip(pred_t.reshape(-1, 64).T + rres, 0, 255).T.reshape(nby, nbx, 6, 64)
    return [np.asarray(q[jentropy._ZIG_INV_NP, :].T.reshape(nby, nbx, 6, 64)),
            np.asarray(M._unblockify(M._untile_y(recon_t[:, :, :4]))),
            np.asarray(M._unblockify(recon_t[:, :, 4].reshape(nby, nbx, 8, 8))),
            np.asarray(M._unblockify(recon_t[:, :, 5].reshape(nby, nbx, 8, 8)))]


@pytest.mark.parametrize("q_level", [2, 4])
def test_transform_matches_pallas_interpret_and_xla(interpret_transform, q_level):
    """96x64, intra and inter macroblocks, both dequantiser shift branches."""
    cur, pred, inter = _inputs(10 + q_level)
    assert inter.any() and (~inter).any()
    got = _port(cur, pred, inter, q_level)
    want_k = k_tf.transform_recon_pallas(
        *(jnp.asarray(p) for p in cur + pred), jnp.asarray(inter), q_level)
    want_x = _xla(cur, pred, inter, q_level)
    for g, k, x in zip(got, want_k, want_x):
        assert np.array_equal(g, np.asarray(k))
        assert np.array_equal(g, x)


@pytest.mark.parametrize("q_level", [1, 2, 3, 4])
def test_transform_stages_match_golden(q_level):
    """Each stage on random tiles against the golden per-tile model,
    including coefficients far outside the real range (wrap semantics)."""
    rng = np.random.default_rng(q_level)
    x = rng.integers(-255, 256, (64, 8, 8))
    f = rng.integers(-20000, 20000, (64, 8, 8))
    inter = rng.random(64) < 0.5
    iq = rng.integers(-2047, 2048, (64, 8, 8))
    got_f = dct.fdct(torch.from_numpy(x)).numpy()
    assert np.array_equal(got_f, np.stack([G.fdct(t) for t in x]))
    got_q = dct.quantize(torch.from_numpy(f), torch.from_numpy(inter), q_level).numpy()
    want_q = np.stack([G.quantize(t, bool(i), q_level) for t, i in zip(f, inter)])
    assert np.array_equal(got_q, want_q)
    got_d = dct.dequantize(torch.from_numpy(want_q.astype(np.int64)),
                           torch.from_numpy(inter), q_level).numpy()
    want_d = np.stack([G.dequantize(t, bool(i), q_level) for t, i in zip(want_q, inter)])
    assert np.array_equal(got_d, want_d)
    assert np.array_equal(dct.idct(torch.from_numpy(iq)).numpy(),
                          np.stack([G.idct(t) for t in iq]))


def test_idct_int32_wrap_matches_golden():
    """Extreme dequantised inputs overflow the reference's 32-bit IDCT
    registers; the int64 plain version must wrap exactly like them."""
    rng = np.random.default_rng(5)
    iq = rng.choice(np.array([-2047, 2047, -2048, 0, 1 << 20, -(1 << 20)]),
                    (256, 8, 8))
    assert np.array_equal(dct.idct(torch.from_numpy(iq)).numpy(),
                          np.stack([G.idct(t) for t in iq]))


def test_intra_division_exhaustive():
    """The intra quantiser divides every 16-bit dividend by INTRA_Q with
    integer division: the whole dividend range of
    test_jax_pipeline.py::test_reciprocal_division_exhaustive, through the
    port's quantize, against the golden quantiser's formula."""
    q_level = 0                                   # dividend = (a + off) & 0xFFFF
    a = np.arange(65536, dtype=np.int64)
    w = T.INTRA_Q.reshape(-1).astype(np.int64)
    off = (w * ((3 << q_level) + 2)) >> 3
    # choose |f| so that (|f| + off) & 0xFFFF sweeps every 16-bit value
    f = (a[:, None] - off[None, :]) & 0xFFFF
    got = dct.quantize(torch.from_numpy(f.reshape(-1, 8, 8)),
                       torch.zeros(f.shape[0], dtype=torch.bool), q_level).numpy()
    want = np.minimum(a[:, None] // w[None, :], 2047).reshape(-1, 8, 8)
    want[:, 0, 0] = np.minimum((f[:, 0] >> 4) + ((f[:, 0] >> 3) & 1), 2047)
    assert np.array_equal(got, want)


def test_wrapper_runs_plain_version_on_cpu():
    cur, pred, inter = _inputs(3)
    before = dict(_build.LAUNCHES)
    got = port_kernel.transform_recon(
        *(torch.from_numpy(p.astype(np.uint8)) for p in cur + pred),
        torch.from_numpy(inter), 2)
    assert _build.LAUNCHES == before
    for g, w in zip(got, _port(cur, pred, inter, 2)):
        assert np.array_equal(g.numpy(), w)


@pytest.mark.parametrize("q_level", [1, 3])
def test_pred_above_cur_matches_pallas_interpret(interpret_transform, q_level):
    """pred > cur everywhere: every residual is negative, which a uint8
    cur - pred would wrap."""
    rng = np.random.default_rng(20 + q_level)
    w, h = 64, 32
    cur = [rng.integers(0, 128, s).astype(np.uint8)
           for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    pred = [rng.integers(128, 256, p.shape).astype(np.int32) for p in cur]
    inter = rng.random((h // 16, w // 16)) < 0.5
    got = _port(cur, pred, inter, q_level)
    want_k = k_tf.transform_recon_pallas(
        *(jnp.asarray(p) for p in cur + pred), jnp.asarray(inter), q_level)
    want_x = _xla(cur, pred, inter, q_level)
    assert (got[0] < 0).any()
    for g, k, x in zip(got, want_k, want_x):
        assert np.array_equal(g, np.asarray(k))
        assert np.array_equal(g, x)


def _cu_table(name):
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "fpga_mpeg2_encoder_tpu_torch", "csrc", "transform.cu")
    m = re.search(name + r"\[64\]\s*=\s*\{([^}]*)\}", open(path).read())
    assert m, name
    return np.array([int(x.strip().rstrip("u")) for x in m.group(1).split(",") if x.strip()],
                    np.uint64)


@pytest.mark.parametrize("q_level", [0, 1, 2, 3, 4])
def test_intra_reciprocal_exhaustive(q_level):
    """The transform kernel's division-free intra quantiser: its magic
    reciprocals (transform.cu's literals, which must be core/tables.py's)
    against // for every numerator ((a + off) & 0xFFFF) >> q_level that a
    16-bit |f| gives, at each of the 64 positions.  q_level 0 is the whole
    16-bit numerator range."""
    magic, shift = (t.astype(np.uint64) for t in port_tables.intra_reciprocal())
    assert np.array_equal(_cu_table("c_intra_magic"), magic)
    assert np.array_equal(_cu_table("c_intra_shift"), shift)
    wq = T.INTRA_Q.reshape(-1).astype(np.uint64)
    off = (wq * np.uint64((3 << q_level) + 2)) >> np.uint64(3)
    a = np.arange(65536, dtype=np.uint64)[:, None]
    n = ((a + off[None, :]) & np.uint64(0xFFFF)) >> np.uint64(q_level)
    got = ((n * magic[None, :]) >> np.uint64(32)) >> shift[None, :]
    assert np.array_equal(got, n // wq[None, :])


@pytest.mark.parametrize("stage", ["fdct", "quantize", "idct"])
def test_stage_wrapper_runs_plain_version_on_cpu(stage):
    """transform_stage on CPU tensors: ops/dct.py's stage, as int32."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(-2047, 2048, (16, 8, 8)).astype(np.int32))
    inter = torch.from_numpy(rng.random(16) < 0.5)
    before = dict(_build.LAUNCHES)
    got = port_kernel.transform_stage(stage, x, inter, 2)
    assert _build.LAUNCHES == before
    if stage == "quantize":
        q = dct.quantize(x.to(torch.int64), inter, 2)
        want = (q, dct.dequantize(q, inter, 2))
    else:
        want = ((dct.fdct if stage == "fdct" else dct.idct)(x),)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g.to(torch.int64), w.to(torch.int64))
