"""Multi-stream batching in the port (parallel/dp.py) and the bit-string
helpers it brings (ops/bitpack.py concat_bitstrings, append_bitstrings_batched),
exact against the JAX package and the golden model.

Each stream of the port's BatchEncoder must equal golden.encode_sequence and
the port's single Encoder, in one process and over 2 and 4 gloo ranks of a
stream mesh (tests/torch_ranks.py); the cases include a 416 px wide stream
(nbx = 26) and chunks of fewer than 8 frames."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

import torch_ranks as R
from fpga_mpeg2_encoder_tpu.config import EncoderConfig as JaxConfig
from fpga_mpeg2_encoder_tpu.config import SequenceConfig as JaxSeq
from fpga_mpeg2_encoder_tpu.golden import encoder as G
from fpga_mpeg2_encoder_tpu.ops import bitpack as jbitpack
from fpga_mpeg2_encoder_tpu_torch import Encoder, EncoderConfig, SequenceConfig
from fpga_mpeg2_encoder_tpu_torch.models import encoder as M
from fpga_mpeg2_encoder_tpu_torch.ops import bitpack
from fpga_mpeg2_encoder_tpu_torch.parallel import dp
from fpga_mpeg2_encoder_tpu_torch.utils.testdata import random_sequence


def _bitstring(rng, nbits, c):
    """c words holding nbits random bits, left-justified, zero beyond."""
    w = np.zeros(c, np.int64)
    nw = (nbits + 31) // 32
    w[:nw] = rng.integers(0, 1 << 32, nw, dtype=np.uint64).astype(np.int64)
    if nbits % 32 and nw:
        w[nw - 1] &= (0xFFFFFFFF << (32 - nbits % 32)) & 0xFFFFFFFF
    return w


def _golden(cfg, seq, frames):
    return G.encode_sequence(JaxConfig(cfg.xl, cfg.yl, cfg.vector_level, cfg.q_level),
                             JaxSeq(seq.width, seq.height, seq.pframes_count), frames)


@pytest.mark.parametrize("r", range(32))
def test_concat_bitstrings_matches_jax(r):
    """Batched concatenation at every residue of the first string's length,
    with a full first string, an empty second one and a cut output."""
    rng = np.random.default_rng(r)
    bl_a = np.array([64 + r, r, 160 if r == 0 else 128 + r])
    bl_b = np.array([100, 0, 97])
    a = np.stack([_bitstring(rng, int(n), 5) for n in bl_a])
    b = np.stack([_bitstring(rng, int(n), 4) for n in bl_b])
    for out_words in (8, 5):
        got_w, got_b = bitpack.concat_bitstrings(torch.from_numpy(a), torch.from_numpy(bl_a),
                                                 torch.from_numpy(b), torch.from_numpy(bl_b),
                                                 out_words)
        want_w, want_b = jbitpack.concat_bitstrings(
            jnp.asarray(a.astype(np.uint32)), jnp.asarray(bl_a.astype(np.int32)),
            jnp.asarray(b.astype(np.uint32)), jnp.asarray(bl_b.astype(np.int32)), out_words)
        assert np.array_equal(got_w.numpy(), np.asarray(want_w).astype(np.int64)), out_words
        assert np.array_equal(got_b.numpy(), np.asarray(want_b))


@pytest.mark.parametrize("r", range(32))
def test_append_bitstrings_batched_matches_jax(r):
    """Per-stream appends at every seq_bits & 31, one of them an empty
    frame and one clamped at the buffer's end (an overflowing append)."""
    rng = np.random.default_rng(100 + r)
    n, c = 40, 6
    seq_bits = np.array([96 + r, 960 + (7 * r) % 32, 1600 + r])
    seq = np.stack([random_sequence(rng, n, int(s)) for s in seq_bits])
    fbits = np.array([150, 0, 192])
    frames = np.stack([_bitstring(rng, int(f), c) for f in fbits])
    got_s, got_b = bitpack.append_bitstrings_batched(
        torch.from_numpy(seq.copy()), torch.from_numpy(seq_bits), torch.from_numpy(frames),
        torch.from_numpy(fbits))
    want_s, want_b = jbitpack.append_bitstrings_batched(
        jnp.asarray(seq.astype(np.uint32)), jnp.asarray(seq_bits.astype(np.int32)),
        jnp.asarray(frames.astype(np.uint32)), jnp.asarray(fbits.astype(np.int32)))
    assert np.array_equal(got_s.numpy(), np.asarray(want_s).astype(np.int64))
    assert np.array_equal(got_b.numpy(), np.asarray(want_b))


def test_append_bitstrings_batched_sizing_contract():
    """The batched append raises on an accumulator without the C + 1 word
    margin, as append_bitstring does, and appends in place otherwise."""
    seq = torch.zeros((2, 8), dtype=torch.int64)
    b = torch.zeros((2, 5), dtype=torch.int64)
    bits = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="seq_cap \\+ C \\+ 1"):
        bitpack.append_bitstrings_batched(seq[:, :5].contiguous(), bits, b, bits)
    b[:, 0] = 0xF0000000
    out, nb = bitpack.append_bitstrings_batched(seq, torch.tensor([4, 36]), b,
                                                torch.tensor([4, 4]))
    assert out is seq and seq[0, 0] == 0x0F000000 and seq[1, 1] == 0x0F000000
    assert nb.tolist() == [8, 40]


def test_batch_push_frames_matches_golden():
    """8 streams of mixed content, one frame each per push (IPPIPP...)."""
    cfg, seq = EncoderConfig(xl=4, yl=4, vector_level=2, q_level=2), SequenceConfig(64, 64, 2)
    kinds = ["pan", "noise", "still", "pan"] * 2
    videos = [R.video(30 + b, 64, 64, 4, k) for b, k in enumerate(kinds)]
    be = dp.BatchEncoder(cfg, seq, 8, device="cpu")
    for t in range(4):
        be.push_frames([v[t] for v in videos])
    for b, got in enumerate(be.finish()):
        assert got == _golden(cfg, seq, videos[b]), b
        assert got == Encoder(cfg, device="cpu").encode(videos[b], 64, 64, 2), b


@pytest.mark.parametrize("w,chunks", [(416, (3, 2)), (64, (1, 4, 1))])
def test_batch_push_chunks_matches_golden(w, chunks):
    """Chunks of fewer than 8 frames (the sequence buffer then holds one
    frame cap), 416 px wide (nbx = 26), and a chunk of one frame."""
    n = sum(chunks)
    cfg, seq = EncoderConfig(xl=5, yl=4), SequenceConfig(w, 64, 2)
    videos = [R.video(40 + b, w, 64, n, k) for b, k in enumerate(("pan", "noise", "still"))]
    be = dp.BatchEncoder(cfg, seq, 3, device="cpu")
    t = 0
    for c in chunks:
        be.push_chunks([v[t:t + c] for v in videos])
        t += c
    for b, got in enumerate(be.finish()):
        assert got == _golden(cfg, seq, videos[b]), b
        assert got == Encoder(cfg, device="cpu").encode(videos[b], w, 64, 2, chunk_frames=2), b


@pytest.mark.parametrize("push", ["frames", "chunks"])
def test_batch_overflow_retry_at_the_bounds(push):
    """Caps far too small for noise: every frame overflows, and the retry
    at the analytic bounds gives the golden bytes."""
    cfg, seq = EncoderConfig(xl=4, yl=4), SequenceConfig(64, 64, 1)
    videos = [R.video(50 + b, 64, 64, 3, "noise") for b in range(2)]
    be = dp.BatchEncoder(cfg, seq, 2, row_cap=64, frame_cap=256, device="cpu")
    if push == "frames":
        for t in range(3):
            be.push_frames([v[t] for v in videos])
    else:
        be.push_chunks(videos)
    for b, got in enumerate(be.finish()):
        assert got == _golden(cfg, seq, videos[b]), b


def test_encode_gops_batched_per_frame_outputs():
    """Per-stream frame bits and GOP positions of the batched frame loop
    equal the single-stream loop's, for streams at different GOP phases."""
    h = w = 64
    videos = [R.video(60 + b, w, h, 4, k) for b, k in enumerate(("pan", "noise"))]
    stacks = [torch.from_numpy(np.stack([np.stack([f[i] for f in v]) for v in videos]))
              for i in range(3)]
    zy = torch.zeros((2, h, w), dtype=torch.uint8)
    zc = torch.zeros((2, h // 2, w // 2), dtype=torch.uint8)
    kw = dict(yr=6, ur=3, q_level=2, row_cap=1024, frame_cap=16384, seq_cap=131072)
    out = dp.encode_gops_batched(*stacks, zy, zc, zc, [0, 2], [0, 5], 2, **kw)
    assert not bool(out[7].any())
    for b, (i0, f0) in enumerate(((0, 0), (2, 5))):
        one = M.encode_gop_scan_core(*(s[b] for s in stacks), zy[b], zc[b], zc[b], i0, f0, 2,
                                     **kw)
        assert int(out[4][b]) == int(one[4])
        nw = (int(one[4]) + 31) // 32
        assert torch.equal(out[3][b, :nw], one[3][:nw])
        assert out[8][b].tolist() == one[8].tolist() and out[9][b] == one[9]
        assert (out[5][b], out[6][b]) == (one[5], one[6])
        assert all(torch.equal(out[i][b], one[i]) for i in range(3))


@pytest.mark.parametrize("world", [2, 4])
def test_batch_encoder_over_gloo_ranks(tmp_path, world):
    """Over a stream mesh of gloo ranks each rank encodes its share, and
    finish gives every rank all four streams, equal to the golden model's."""
    R.run_ranks(world, tmp_path, ["batch_encoder"])
    cfg, seq = EncoderConfig(xl=5, yl=4), SequenceConfig(416, 64, 2)
    want = [_golden(cfg, seq, R.video(20 + b, 416, 64, 4, "pan" if b % 2 else "noise"))
            for b in range(4)]
    for r in range(world):
        got = R.load(tmp_path, f"batch_encoder_r{r}")
        assert [got[f"s{b}"].tobytes() for b in range(4)] == want, r


def test_batch_encoder_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dp.BatchEncoder(EncoderConfig(xl=4, yl=4), SequenceConfig(64, 64, 2), 2)
    assert dp.BatchEncoder(EncoderConfig(xl=4, yl=4), SequenceConfig(64, 64, 2), 2,
                           device="cpu").device.type == "cpu"


def test_batch_encoder_rejects_malformed_input():
    be = dp.BatchEncoder(EncoderConfig(xl=4, yl=4), SequenceConfig(64, 64, 2), 2,
                         device="cpu")
    frame = R.video(1, 64, 64, 1)[0]
    with pytest.raises(ValueError, match="the batch has 2"):
        be.push_frames([frame])
    wide = R.video(1, 80, 64, 1)[0]
    with pytest.raises(ValueError, match="the sequence takes \\(64, 64\\) uint8"):
        be.push_frames([wide, wide])
    with pytest.raises(ValueError, match="the same number of frames"):
        be.push_chunks([[frame, frame], [frame]])
