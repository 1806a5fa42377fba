"""Each stage's work count at 1920x1152 reproduces the bounds of the port's
kernel table (PERF.md, chip_smoke.py phase 3, an H100 of 132 SMs at a
maximum SM clock of 1980 MHz), on phase 3's inputs: the P-frame of
frames 0 and 1 of the headline content (seed 42), predicted from frame 0's
source planes, packed at a row cap of 4096 words and appended at a
sequence bit offset of 13."""
import pytest
import torch

import harness
import peaks
from reference import mpeg2

H100 = peaks.Peaks(sms=132, max_sm_clock_mhz=1980.0)
G = harness.Geometry(1920, 1152, 6)
ROWS = G.mby + 2
# (stage, frame type, bound in ms as PERF.md's table gives it, digits)
TABLE = [("subsample", False, 0.00165, 5), ("motion", False, 0.00595, 5),
         ("transform", False, 0.00694, 5), ("glue", False, 0.01212, 5),
         ("acsym", False, 0.00819, 5)]


def bound_ms(stage, frame):
    return 1e3 * H100.bound_s(*harness.load("stages", stage).work(G, frame))


@pytest.mark.parametrize("stage, is_i, want, digits", TABLE)
def test_bound_reproduces_the_kernel_table(stage, is_i, want, digits):
    assert round(bound_ms(stage, harness.Frame(is_i)), digits) == want


def test_pack_bound_at_the_tables_row_cap():
    # phase 3 counted every word of the 4096-word rows that pack_slots wrote
    assert round(bound_ms("pack", harness.Frame(False, row_words=ROWS * 4096)), 5) == 0.00454


@pytest.fixture(scope="module")
def phase3_row_bits():
    """The row bits of phase 3's P-frame, from the reference's stages."""
    frames = harness.load("content", "synthetic").make(1920, 1152, 2, 42)
    (y0, u0, v0), (y1, u1, v1) = [tuple(torch.as_tensor(p) for p in f) for f in frames]
    prev = (y0, mpeg2.subsample(u0), mpeg2.subsample(v0))
    cur = (y1, mpeg2.subsample(u1), mpeg2.subsample(v1))
    inter, mvx, mvy, *pred = mpeg2.motion(cur[0], *prev, False, 6)
    zig, _ = mpeg2.transform(cur, pred, inter, 2)
    _, lens = mpeg2.macroblock_symbols(zig, inter, mvx, mvy, True)
    gop, pic = mpeg2.header_symbols(1, 1)
    rows = [sum(gop[1]), sum(pic[1])]
    rows += [38 + int(lens[r].sum()) for r in range(G.mby)]
    return [(b + 7) & ~7 for b in rows]


def test_merge_bound_on_the_tables_frame(phase3_row_bits):
    rb = phase3_row_bits
    frame = harness.Frame(False, bits=sum(rb), row_words=sum((b + 31) // 32 for b in rb),
                          bit_offset=13)
    assert round(bound_ms("merge", frame), 6) == 0.000032


def test_motion_does_no_search_on_i_frames():
    bytes_p, ops_p = harness.load("stages", "motion").work(G, harness.Frame(False))
    bytes_i, ops_i = harness.load("stages", "motion").work(G, harness.Frame(True))
    assert ops_i == 0 and ops_p == G.mb * 256 * (13 ** 2 + 11) // 4
    # the early exit reads no plane: it writes the maps and the predictions
    writes = 9 * G.mb + G.width * G.height * 3 // 2
    assert bytes_i == writes and bytes_p == writes + G.width * G.height * 5 // 2


def test_int32_peak_of_an_h100():
    assert H100.int32_ops_per_s == pytest.approx(132 * 64 * 1980e6)
