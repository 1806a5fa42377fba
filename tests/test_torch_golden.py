"""The port's copy of the golden NumPy model (golden/encoder.py) against the
JAX package's: whole streams of the stream matrix of
tests/test_torch_encoder.py (sizes up to 416 px wide, q_level 1-4,
vector_level 1-3, the three stop modes, GOP wrap), exact, and the 24 fps
timecode counter across the minute (frame 1440), the hour (frame 86400) and
the hour's cap."""
import numpy as np
import pytest

from fpga_mpeg2_encoder_tpu.config import EncoderConfig as JaxConfig
from fpga_mpeg2_encoder_tpu.config import SequenceConfig as JaxSeq
from fpga_mpeg2_encoder_tpu.golden import encoder as JG
from fpga_mpeg2_encoder_tpu_torch import EncoderConfig, SequenceConfig
from fpga_mpeg2_encoder_tpu_torch.golden import encoder as G
from fpga_mpeg2_encoder_tpu_torch.utils.testdata import video


@pytest.mark.parametrize("w,h,q,vl,n,kind,pframes,stop,groups", [
    (64, 64, 2, 3, 4, "pan", 23, "clean", 0),
    (64, 64, 1, 1, 3, "noise", 23, "coincident", 0),
    (64, 64, 4, 2, 3, "pan", 23, "partial", 1),
    (64, 64, 2, 3, 7, "pan", 2, "clean", 0),          # GOP wrap: I P P I P P I
    (416, 64, 2, 3, 3, "pan", 23, "clean", 0),
    (416, 64, 3, 1, 3, "pan", 1, "partial", 37),
    (288, 208, 2, 3, 3, "pan", 23, "clean", 0),       # the reference fixture size
])
def test_encode_sequence_matches_jax_golden(w, h, q, vl, n, kind, pframes, stop, groups):
    frames = video(w + n, w, h, n, kind)
    kw = dict(stop_mode=stop, partial_groups=groups)
    got = G.encode_sequence(EncoderConfig(5, 4, vl, q), SequenceConfig(w, h, pframes),
                            frames, **kw)
    want = JG.encode_sequence(JaxConfig(5, 4, vl, q), JaxSeq(w, h, pframes), frames, **kw)
    assert got == want


def test_partial_stop_needs_a_group():
    with pytest.raises(ValueError, match="partial_groups"):
        G.encode_sequence(EncoderConfig(4, 4), SequenceConfig(64, 64, 2),
                          video(1, 64, 64, 1), stop_mode="partial", partial_groups=0)


def _formula(frame_no):
    """(hour, minute, second, insec) of frame ``frame_no`` at 24 fps."""
    return (frame_no // (24 * 3600), (frame_no // (24 * 60)) % 60,
            (frame_no // 24) % 60, frame_no % 24)


@pytest.mark.parametrize("start,n", [(1380, 120), (86400 - 60, 120)])
def test_timecode_ticks_across_rollovers(start, n):
    """From frame ``start`` (the counter set by the formula) across the
    minute at 1440 or the hour at 86400: each tick equals the JAX
    package's Timecode and the formula."""
    tc, jtc = G.Timecode(*_formula(start)), JG.Timecode(*_formula(start))
    seen = set()
    for k in range(start + 1, start + n + 1):
        tc.tick()
        jtc.tick()
        got = (tc.hour, tc.minute, tc.second, tc.insec)
        assert got == (jtc.hour, jtc.minute, jtc.second, jtc.insec) == _formula(k)
        seen.add(got[:2])
    assert len(seen) == 2            # the minute (and at 86400 the hour) rolled over


def test_timecode_from_zero_to_one_hour():
    tc = G.Timecode()
    for _ in range(86400):
        tc.tick()
    assert (tc.hour, tc.minute, tc.second, tc.insec) == (1, 0, 0, 0)


def test_timecode_hour_saturates_at_63():
    """The hour is a 6-bit field that counts up to 63 and stays there
    (RTL:2684-2698)."""
    tc, jtc = G.Timecode(62, 59, 59, 23), JG.Timecode(62, 59, 59, 23)
    for ticks in (1, 24 * 3600):             # into hour 63, then an hour more
        for _ in range(ticks):
            tc.tick()
            jtc.tick()
        assert (tc.hour, tc.minute, tc.second, tc.insec) == (63, 0, 0, 0)
        assert (jtc.hour, jtc.minute, jtc.second, jtc.insec) == (63, 0, 0, 0)


def test_block_functions_match_jax():
    """The per-block functions on seeded operands, against the JAX golden's:
    the ten-way minimum with ties (values 0-3), the forward DCT and both
    quantisers, the zig-zag scan and every AC symbol (run 0-63, level
    -2048..2047)."""
    rng = np.random.default_rng(3)
    for v in rng.integers(0, 4, (4000, 10)).tolist():
        assert G.find_min_in_10_values(v) == JG.find_min_in_10_values(v), v
    for q_level in (1, 2, 3, 4):
        tiles = rng.integers(-255, 256, (16, 8, 8))
        for tile in tiles:
            d = G.fdct(tile)
            assert np.array_equal(d, JG.fdct(tile))
            for inter in (False, True):
                assert np.array_equal(G.quantize(d, inter, q_level),
                                      JG.quantize(d, inter, q_level))
            assert np.array_equal(G.zigzag_scan(d), JG.zigzag_scan(d))
    for run in range(64):
        for v in list(range(-48, 0)) + list(range(1, 49)) + [-2048, -1000, 1000, 2047]:
            assert G.put_ac_symbol(v, run) == JG.put_ac_symbol(v, run)


def test_black_frame_and_frame_functions_match_jax():
    """black_frame_420, and encode_frame's recon, quantised coefficients,
    CBP and decisions on an I then a P frame, equal the JAX golden's."""
    assert all(np.array_equal(a, b) for a, b in
               zip(G.black_frame_420(96, 64), JG.black_frame_420(96, 64)))
    frames = [G.subsample_420(*f) for f in video(5, 96, 64, 2, "noise")]
    cfg, jcfg = EncoderConfig(5, 4, 2, 3), JaxConfig(5, 4, 2, 3)
    prev = jprev = None
    for i_frame, planes in enumerate(frames):
        fr = G.encode_frame(cfg, *planes, prev, i_frame)
        jfr = JG.encode_frame(jcfg, *planes, jprev, i_frame)
        for a in ("recon_y", "recon_u", "recon_v", "quant", "nzflags"):
            assert np.array_equal(getattr(fr, a), getattr(jfr, a)), a
        assert [[(d.inter, d.mvx, d.mvy) for d in row] for row in fr.decisions] == \
            [[(d.inter, d.mvx, d.mvy) for d in row] for row in jfr.decisions]
        prev, jprev = (fr.recon_y, fr.recon_u, fr.recon_v), (jfr.recon_y, jfr.recon_u,
                                                             jfr.recon_v)
