"""Whole streams: the port's Encoder (plain versions on the CPU) must be
byte-identical to the JAX package's Encoder and to the golden model, across
sizes (one at least 416 px wide), quantiser and search levels, stop modes,
GOP wrap, chunked and streaming pushes, the overflow retry at the analytic
bounds, and a state hand-over from the JAX encoder."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from fpga_mpeg2_encoder_tpu import Encoder as JaxEncoder
from fpga_mpeg2_encoder_tpu.golden import encoder as G
from fpga_mpeg2_encoder_tpu_torch import Encoder, EncoderConfig, SequenceConfig
from fpga_mpeg2_encoder_tpu_torch.models import encoder as M
from fpga_mpeg2_encoder_tpu_torch.runtime.state import EncoderState


def _video(seed, w, h, n, kind="pan"):
    """Panning gradient + texture (real motion), or noise (escape-heavy)."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return [tuple(rng.integers(0, 256, (h, w), dtype=np.uint8) for _ in range(3))
                for _ in range(n)]
    pad = 48
    yy, xx = np.mgrid[0:h + pad, 0:w + pad]
    tex = rng.integers(0, 64, (h + pad, w + pad))
    base = [((xx * 3 + yy * 2) // 4 % 200 + tex) % 256,
            ((xx - yy) // 3 % 160 + 48 + tex // 2) % 256,
            ((xx + yy) // 5 % 120 + 64 + tex // 3) % 256]
    return [tuple(b[2 * i % pad:2 * i % pad + h, 3 * i % pad:3 * i % pad + w]
                  .astype(np.uint8) for b in base) for i in range(n)]


def _golden(cfg, frames, w, h, pframes, **kw):
    from fpga_mpeg2_encoder_tpu.config import EncoderConfig as JaxConfig
    from fpga_mpeg2_encoder_tpu.config import SequenceConfig as JaxSeq
    jcfg = JaxConfig(cfg.xl, cfg.yl, cfg.vector_level, cfg.q_level)
    return G.encode_sequence(jcfg, JaxSeq(w, h, pframes), frames, **kw)


def _jax_cfg(cfg):
    from fpga_mpeg2_encoder_tpu.config import EncoderConfig as JaxConfig
    return JaxConfig(cfg.xl, cfg.yl, cfg.vector_level, cfg.q_level)


@pytest.mark.parametrize("w,h,q,vl,n,kind,pframes,stop,groups,chunk", [
    (64, 64, 2, 3, 4, "pan", 23, "clean", 0, 1),
    (64, 64, 1, 1, 3, "noise", 23, "coincident", 0, 1),
    (64, 64, 4, 2, 3, "pan", 23, "partial", 1, 1),
    (64, 64, 2, 3, 7, "pan", 2, "clean", 0, 1),          # GOP wrap: I P P I P P I
    (416, 64, 2, 3, 3, "pan", 23, "clean", 0, 1),
    (416, 64, 3, 1, 3, "pan", 1, "partial", 37, 3),
    (288, 208, 2, 3, 3, "pan", 23, "clean", 0, 3),       # the reference fixture size
    (64, 64, 2, 1, 4, "noise", 23, "clean", 0, 4),       # end code on a 32-byte boundary
])
def test_stream_matches_golden(w, h, q, vl, n, kind, pframes, stop, groups, chunk):
    cfg = EncoderConfig(xl=5, yl=4, vector_level=vl, q_level=q)
    frames = _video(w + n, w, h, n, kind)
    kw = dict(stop_mode=stop, partial_groups=groups)
    got = Encoder(cfg, device="cpu").encode(frames, w, h, pframes,
                                            chunk_frames=chunk, **kw)
    assert got == _golden(cfg, frames, w, h, pframes, **kw)


@pytest.mark.parametrize("w,chunk", [(64, 1), (416, 3)])
def test_stream_matches_jax_encoder(w, chunk):
    cfg = EncoderConfig(xl=5, yl=4)
    frames = _video(7, w, 64, 3)
    got = Encoder(cfg, device="cpu").encode(frames, w, 64, 2, chunk_frames=chunk)
    want = JaxEncoder(_jax_cfg(cfg)).encode(frames, w, 64, 2, chunk_frames=chunk)
    assert got == want


def test_short_push_chunk_equals_push_frame():
    """push_chunk of fewer than 8 frames sizes its sequence buffer at one
    frame cap: the append guard margin must keep it byte-identical."""
    cfg = EncoderConfig(xl=4, yl=4)
    frames = _video(3, 64, 64, 5)
    enc = Encoder(cfg, device="cpu")
    enc.start_sequence(SequenceConfig(64, 64, 2))
    enc.push_chunk(frames)
    chunked = enc.finish()
    enc.start_sequence(SequenceConfig(64, 64, 2))
    for f in frames:
        enc.push_frame(*f)
    assert chunked == enc.finish() == _golden(cfg, frames, 64, 64, 2)


def _record_caps(monkeypatch):
    """Record the caps of each call of the single-frame and multi-frame
    pipelines."""
    calls = []
    for name in ("encode_frame_device", "encode_gop_scan"):
        real = getattr(M, name)

        def rec(*a, _real=real, **kw):
            calls.append((kw["row_cap"], kw["frame_cap"]))
            return _real(*a, **kw)
        monkeypatch.setattr(M, name, rec)
    return calls


@pytest.mark.parametrize("chunk", [1, 3])
def test_overflow_retry_is_byte_identical(monkeypatch, chunk):
    """Caps far too small for noise: each of three frames pushed alone, or
    their chunk of three, overflows and is encoded again at the analytic
    bounds, byte-identically."""
    calls = _record_caps(monkeypatch)
    cfg = EncoderConfig(xl=4, yl=4)
    frames = _video(4, 64, 64, 3, "noise")
    got = Encoder(cfg, row_cap=64, frame_cap=256, device="cpu").encode(
        frames, 64, 64, 1, chunk_frames=chunk)
    retries = [c for c in calls if c == M.bound_caps(64, 64)]
    pushes = 3 // chunk
    assert len(retries) == pushes and len(calls) == 2 * pushes
    assert got == _golden(cfg, frames, 64, 64, 1)


@pytest.mark.parametrize("chunk", [1, 3])
def test_overflow_past_the_bounds_raises(monkeypatch, chunk):
    """A frame that overflowed even the bounds' caps would lose bits: the
    encoder raises instead of writing a short stream."""
    monkeypatch.setattr(M, "bound_caps", lambda w, h: (64, 256))
    enc = Encoder(EncoderConfig(xl=4, yl=4), row_cap=64, frame_cap=256, device="cpu")
    with pytest.raises(RuntimeError, match="analytic worst-case buffer bound"):
        enc.encode(_video(4, 64, 64, 3, "noise"), 64, 64, 1, chunk_frames=chunk)


@pytest.mark.parametrize("n", [1, 3, 4, 40])
def test_bound_caps_are_entropy_bounds(n):
    """The retry's caps are entropy's hard bounds for the frame's macroblock
    grid (a row of 120 macroblocks, 72 rows at 1920x1152).  An n-frame
    chunk's caps: the given ones with a sequence cap of a quarter of its
    frame caps (at least one), then the bounds with one frame cap a frame."""
    from fpga_mpeg2_encoder_tpu_torch.ops import entropy
    row, frame = entropy.slice_words_bound(120), entropy.frame_words_bound(120, 72)
    assert M.bound_caps(1920, 1152) == (row, frame)
    first, bounds = M.chunk_caps(2048, 65536, 1920, 1152, n)
    assert first == dict(row_cap=2048, frame_cap=65536,
                         seq_cap=65536 * {1: 1, 3: 1, 4: 1, 40: 10}[n])
    assert bounds == dict(row_cap=row, frame_cap=frame, seq_cap=frame * n)


def test_state_handover_from_jax_encoder():
    """The JAX encoder's state after 3 frames (numpy recon planes), handed to
    the port, finishes the sequence to the same bytes."""
    cfg = EncoderConfig(xl=5, yl=4)
    frames = _video(7, 64, 64, 5)
    jenc = JaxEncoder(_jax_cfg(cfg))
    jenc.start_sequence(SequenceConfig(64, 64, 2))
    for f in frames[:3]:
        jenc.push_frame(*f)
    state = jenc.get_state()
    enc = Encoder(cfg, device="cpu")
    enc.set_state(state)
    for f in frames[3:]:
        enc.push_frame(*f)
    assert enc.finish() == _golden(cfg, frames, 64, 64, 2)


def test_state_save_load_resume(tmp_path):
    cfg = EncoderConfig(xl=4, yl=4)
    frames = _video(8, 64, 64, 4)
    enc = Encoder(cfg, device="cpu")
    enc.start_sequence(SequenceConfig(64, 64, 1))
    enc.push_chunk(frames[:2])
    enc.get_state().save(str(tmp_path / "ckpt.npz"))
    resumed = Encoder(cfg, device="cpu")
    resumed.set_state(EncoderState.load(str(tmp_path / "ckpt.npz")))
    for f in frames[2:]:
        resumed.push_frame(*f)
    assert resumed.finish() == _golden(cfg, frames, 64, 64, 1)


def test_frame_shape_errors():
    cfg = EncoderConfig(xl=4, yl=4)
    y = np.zeros((64, 64), np.uint8)
    enc = Encoder(cfg, device="cpu")
    enc.start_sequence(SequenceConfig(64, 64, 1))
    with pytest.raises(ValueError, match="u plane") as e:
        enc.push_chunk([(y, y[:32, :32], y)])
    assert "clamped" not in str(e.value)
    enc.finish()
    enc.start_sequence(SequenceConfig(320, 64, 1))        # clamped to 256 wide
    with pytest.raises(ValueError, match="clamped"):
        enc.push_frame(np.zeros((64, 320), np.uint8), y, y)
