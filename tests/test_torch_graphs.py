"""The port's compiled programs on the CPU against the JAX package's.

models/encoder.encode_gop_scan and encode_frame_device run their step
eagerly on the CPU (on a card they replay a captured CUDA graph of it, which
tests/test_torch_cuda.py holds against the eager path).  Here they are held
against JAX encode_gop_scan and encode_frame_device in every output, with
the GOP position and the frame number as device values: the header rows
from 0-d tensors, the motion stage's I/P flag as a tensor, a 416 px wide
chunk of fewer than 8 frames whose timecode rolls over (frame 1439 -> 1440)
and whose GOP wraps.  The gop program's carry (ops/kernels/carry.py, its
plain version here) against the operations the step ran before it and
against the GOP rules, and encode_gop_scan against the eager
encode_gop_scan_core, over stacks in each layout its callers hand over.
Also the launch ledger's arithmetic under replay,
a step of several branches on the CPU and the program cache.  All equality is exact.
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax.numpy as jnp

from fpga_mpeg2_encoder_tpu.models import encoder as JM
from fpga_mpeg2_encoder_tpu.ops import entropy as jentropy
from fpga_mpeg2_encoder_tpu_torch.models import encoder as M
from fpga_mpeg2_encoder_tpu_torch.ops import entropy, motion
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import _build
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import carry as k_carry
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import me as k_me
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import pack as k_pack
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import transform as k_tf
from fpga_mpeg2_encoder_tpu_torch.runtime import graphs
from fpga_mpeg2_encoder_tpu_torch.utils import profiling
from fpga_mpeg2_encoder_tpu_torch.utils.testdata import STACK_LAYOUTS, stack_layout, video

W, H, NF = 416, 64, 5           # nbx = 26; a chunk of fewer than 8 frames
KW = dict(yr=6, ur=3, q_level=2, row_cap=1024, frame_cap=16384)
SEQ_CAP = 65536


def _i32(v):
    return torch.tensor(v, dtype=torch.int32)


@pytest.fixture(scope="module")
def clip():
    """NF frames of panning content as numpy (F, H, W) stacks."""
    frames = video(11, W, H, NF, "pan")
    return [np.stack([f[i] for f in frames]) for i in range(3)]


@pytest.mark.parametrize("frame_no", [0, 23, 24, 1439, 1440, 86399, 86400, 24 * 3600 * 64])
@pytest.mark.parametrize("i_frame", [0, 1, 23])
def test_header_rows_from_tensors_equal_jax(i_frame, frame_no):
    """The GOP and picture header rows formed on the device from 0-d int32
    tensors equal JAX _header_rows, and the same call with ints: the
    timecode's carries at 24 frames, 60 seconds and 60 minutes, and the hour
    clamped at 63 (frame 24 * 3600 * 64)."""
    s = 20
    got = entropy._header_rows(_i32(i_frame), _i32(frame_no), s, "cpu")
    assert torch.equal(got, entropy._header_rows(i_frame, frame_no, s, "cpu"))
    codes, lens = jentropy._header_rows(jnp.int32(i_frame), jnp.int32(frame_no), s)
    assert np.array_equal(entropy.slot_len(got).numpy(), np.asarray(lens))
    live = np.asarray(lens) > 0
    got_codes = (entropy.slot_u32(got) & entropy.SLOT_CODE_MASK).numpy()
    assert np.array_equal(got_codes[live], np.asarray(codes).astype(np.int64)[live])


@pytest.mark.parametrize("flag", ["bool", "int"])
@pytest.mark.parametrize("is_i", [False, True])
def test_motion_with_tensor_flag_equals_bool(flag, is_i):
    """The plain motion stage and its wrapper on CPU tensors with the I/P
    flag as a 0-d bool or int tensor equal the same calls with a bool."""
    f0, f1 = video(5, 64, 64, 2, "pan")
    cur, prev = torch.from_numpy(f1[0]), torch.from_numpy(f0[0])
    pc = torch.from_numpy(f0[1][::2, ::2].copy())
    t = torch.tensor(is_i) if flag == "bool" else _i32(7 if is_i else 0)
    want = motion.estimate_and_predict_planes(cur, pc, pc, prev, pc, pc, is_i, 6, 3)
    for got in (motion.estimate_and_predict_planes(cur, pc, pc, prev, pc, pc, t, 6, 3),
                k_me.estimate_and_predict_planes(cur, pc, pc, prev, pc, pc, t, 6, 3)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    luma = motion.estimate_luma(cur, motion.pad_halo(prev, 8), t, 6, 0, 4)
    assert all(torch.equal(a, b) for a, b in zip(
        luma, motion.estimate_luma(cur, motion.pad_halo(prev, 8), is_i, 6, 0, 4)))


@pytest.mark.parametrize("position", [0, 3])
def test_motion_position_and_recon_out_on_cpu(position):
    """On CPU tensors, the gop program's two operands of its stages:
    motion_estimate_fused with the GOP position equals the call with the
    I/P flag it stands for, and refuses both or neither; transform_recon
    with ``out`` fills and returns the given planes, equal to new ones, and
    refuses an input as an output."""
    f0, f1 = video(5, 64, 64, 2, "pan")
    cur, prev = torch.from_numpy(f1[0]), torch.from_numpy(f0[0])
    pc = torch.from_numpy(f0[1][::2, ::2].copy())
    got = k_me.motion_estimate_fused(cur, prev, pc, pc, None, 6, 3, as_plane=True,
                                     position=_i32(position))
    want = k_me.motion_estimate_fused(cur, prev, pc, pc, position == 0, 6, 3, as_plane=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for bad in (dict(is_iframe=True, position=_i32(0)), dict(is_iframe=None)):
        with pytest.raises(ValueError, match="one of"):
            k_me.motion_estimate_fused(cur, prev, pc, pc, yr=6, ur=3, **bad)
    inter, _, _, py, pu, pv = got
    args = (cur, pc, pc, py, pu, pv, inter, 2)
    out = (torch.full_like(cur, 7), torch.full_like(pc, 7), torch.full_like(pc, 7))
    new, into = k_tf.transform_recon(*args), k_tf.transform_recon(*args, out=out)
    assert all(a is b for a, b in zip(into[1:], out))
    assert all(torch.equal(a, b) for a, b in zip(new, into))
    with pytest.raises(ValueError, match="input"):
        k_tf.transform_recon(*args, out=(out[0], pc, out[2]))


@pytest.mark.parametrize("i_frame0,frame_no0,pframes", [(2, 1438, 2), (0, 0, 23)])
def test_encode_gop_scan_equals_jax(clip, i_frame0, frame_no0, pframes):
    """The port's encode_gop_scan on the CPU equals JAX encode_gop_scan in
    all ten outputs: 416 px wide, 5 frames, starting at GOP position 2 and
    frame 1438 with pframes_count 2 (the timecode rolls over at frame 1440
    inside the chunk and the GOP wraps: positions 2 0 1 2 0), and from the
    sequence start.  One JAX compile serves both cases."""
    zy = np.zeros((H, W), np.uint8)
    zc = np.zeros((H // 2, W // 2), np.uint8)
    want = JM.encode_gop_scan(*(jnp.asarray(s) for s in clip), jnp.asarray(zy),
                              jnp.asarray(zc), jnp.asarray(zc), jnp.int32(i_frame0),
                              jnp.int32(frame_no0), jnp.int32(pframes), **KW,
                              seq_cap=SEQ_CAP)
    got = M.encode_gop_scan(*(torch.from_numpy(s) for s in clip), torch.from_numpy(zy),
                            torch.from_numpy(zc), torch.from_numpy(zc), _i32(i_frame0),
                            _i32(frame_no0), _i32(pframes), **KW, seq_cap=SEQ_CAP)
    for k in range(3):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    nbits = int(want[4])
    assert int(got[4]) == nbits > 0
    nw = (nbits + 31) // 32
    assert np.array_equal(got[3][:nw].numpy(), np.asarray(want[3])[:nw].astype(np.int64))
    assert int(got[5]) == int(want[5]) and int(got[6]) == int(want[6]) == frame_no0 + NF
    assert bool(got[7]) is bool(want[7]) is False
    assert got[8].tolist() == np.asarray(want[8]).tolist()
    assert got[9].dtype == torch.int32 and got[9].tolist() == np.asarray(want[9]).tolist()
    if pframes == 2:
        assert got[9].tolist() == [2, 0, 1, 2, 0]


def test_encode_frame_device_equals_jax(clip):
    """The port's encode_frame_device on the CPU equals JAX
    encode_frame_device, an I-frame then a P-frame from its recon, with the
    GOP state given as 0-d tensors and as ints."""
    zy = np.zeros((H, W), np.uint8)
    zc = np.zeros((H // 2, W // 2), np.uint8)
    jprev = (jnp.asarray(zy), jnp.asarray(zc), jnp.asarray(zc))
    prev = (torch.from_numpy(zy), torch.from_numpy(zc), torch.from_numpy(zc))
    for k, (i_f, fno) in enumerate(((0, 1439), (1, 1440))):
        want = JM.encode_frame_device(*(jnp.asarray(s[k]) for s in clip), *jprev,
                                      jnp.int32(i_f), jnp.int32(fno), **KW)
        planes = [torch.from_numpy(s[k]) for s in clip]
        got = M.encode_frame_device(*planes, *prev, _i32(i_f), _i32(fno), **KW)
        again = M.encode_frame_device(*planes, *prev, i_f, fno, **KW)
        for a, b in zip(got, again):
            assert torch.equal(a, b)
        for c in range(3):
            assert np.array_equal(got[c].numpy(), np.asarray(want[c])), (k, c)
        nbits = int(want[4])
        nw = (nbits + 31) // 32
        assert int(got[4]) == nbits > 0 and not bool(got[5]) and not bool(want[5])
        assert np.array_equal(got[3][:nw].numpy(), np.asarray(want[3])[:nw].astype(np.int64))
        jprev, prev = want[:3], tuple(t.clone() for t in got[:3])


def test_launch_ledger_counts_replays():
    """Launches counted while a graph is captured go to the capture's tally,
    not to LAUNCHES; each replay adds the tally, so n replays of a step that
    launches each kernel once count n launches of each."""
    _build.reset_launches()
    tally = {}
    with _build.tally_into(tally):
        for name in ("subsample", "me_fused", "transform", "glue", "acsym", "pack_slots",
                     "merge_rows", "gop_carry"):
            _build.count(name)
        _build.count("pack_slots")
        with pytest.raises(RuntimeError, match="nest"):
            with _build.tally_into({}):
                pass
    assert sum(_build.LAUNCHES.values()) == 0
    assert tally == {"subsample": 1, "me_fused": 1, "transform": 1, "glue": 1, "acsym": 1,
                     "pack_slots": 2, "merge_rows": 1, "gop_carry": 1}
    for _ in range(3):
        _build.add_launches(tally)
    _build.add_launches(tally, times=4)
    assert _build.LAUNCHES == {"subsample": 7, "me_fused": 7, "transform": 7, "glue": 7,
                               "acsym": 7, "pack_slots": 14, "merge_rows": 7, "me_luma": 0,
                               "chroma_pred": 0, "gop_carry": 7}
    _build.count("me_luma")
    assert _build.LAUNCHES["me_luma"] == 1
    _build.reset_launches()


def test_program_cache_and_inputs():
    """Programs are cached per key (the same program, whose outputs each
    call rewrites), the least recently used is dropped past MAX_PROGRAMS,
    and a program refuses operands of another shape or device."""
    graphs.clear()
    made = []
    for k in range(graphs.MAX_PROGRAMS + 2):
        graphs.cached(("t", k), lambda k=k: made.append(k) or k)
    assert graphs.cached(("t", graphs.MAX_PROGRAMS + 1), lambda: None) == graphs.MAX_PROGRAMS + 1
    assert ("t", 0) not in graphs._programs and len(graphs._programs) == graphs.MAX_PROGRAMS
    graphs.clear()
    f = [torch.zeros((2, 64, 64), dtype=torch.uint8) for _ in range(3)]
    zc = torch.zeros((32, 32), dtype=torch.uint8)
    kw = dict(yr=6, ur=3, q_level=2, row_cap=256, frame_cap=1024, seq_cap=4096)
    a = M.encode_gop_scan(*f, f[0][0], zc, zc, 0, 0, 2, **kw)
    b = M.encode_gop_scan(*f, f[0][0], zc, zc, 1, 5, 2, **kw)
    assert a[3] is b[3] and len(graphs._programs) == 1
    assert b[9].tolist() == [1, 2] and int(b[6]) == 7
    with pytest.raises(ValueError, match="prev_u"):
        M.encode_gop_scan(*f, f[0][0], zc[:16], zc, 0, 0, 2, **kw)
    with pytest.raises(ValueError, match="y444"):
        M.encode_frame_device(f[0][0].to(torch.int32), f[1][0], f[2][0], f[0][0], zc, zc,
                              0, 0, **{k: v for k, v in kw.items() if k != "seq_cap"})
    graphs.clear()


def test_step_branches_run_in_turn_on_the_cpu():
    """A step of several functions (on a card the branches of one graph,
    each on a stream of its own) runs them one after another at each call
    on the CPU, and its outputs are the list of what each returned; a step
    of one function returns what it returns."""
    order = []
    step = graphs.Step([lambda b=b: order.append(b) or 10 * b for b in range(3)], "cpu",
                       "t")
    assert step.launches_a_call == 0 and step.outputs is None
    assert step() == [0, 10, 20] and step() == [0, 10, 20] and order == [0, 1, 2] * 2
    assert step.outputs == [0, 10, 20]
    assert graphs.Step(lambda: 7, "cpu")() == 7


def test_gop_scalar_fills_on_the_device():
    """The one converter of GOP state: an int or bool becomes a 0-d int32
    filled on the device, a 0-d tensor there is used as it is, ``out`` takes
    the value in place, and anything else is refused."""
    assert entropy.gop_scalar(True, "cpu").dtype == torch.int32
    assert int(entropy.gop_scalar(1440, "cpu")) == 1440
    t = torch.tensor(True)
    assert entropy.gop_scalar(t, "cpu") is t
    out = torch.zeros((), dtype=torch.int32)
    assert entropy.gop_scalar(23, "cpu", out=out) is out and int(out) == 23
    assert entropy.gop_scalar(torch.tensor(7, dtype=torch.int64), "cpu", out=out) is out
    assert int(out) == 7
    for bad in (torch.zeros(1, dtype=torch.int32), torch.zeros((), device="meta")):
        with pytest.raises(ValueError, match="0-d"):
            entropy.gop_scalar(bad, "cpu")
    assert int(k_me._gop_position(True, "cpu")) == 0
    assert int(k_me._gop_position(torch.tensor(0, dtype=torch.int32), "cpu")) == 1


def test_pack_lookback_buffers_are_never_freed(monkeypatch):
    """A call with more tiles than the stream's look-back buffer holds gets a
    larger one, at least twice the old capacity, and the old buffer is kept
    (a graph captured with it replays with its address); a smaller call
    reuses the current buffer."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 7})())
    monkeypatch.setattr(k_pack, "_lookback", {})
    monkeypatch.setattr(k_pack, "_retired", [])
    dev = torch.device("cpu")
    a, cap_a = k_pack._lookback_buffer(dev, 10)
    b, cap_b = k_pack._lookback_buffer(dev, 1196)      # 2048x1440: 92 rows of 13 tiles
    assert (cap_a, cap_b) == (1024, 2048) and k_pack._retired == [a]
    assert k_pack._retired[0] is a and not a.any() and not b.any()
    assert k_pack._lookback_buffer(dev, 100)[0] is b
    c, cap_c = k_pack._lookback_buffer(dev, 5000)
    assert cap_c == 5000 and [x is y for x, y in zip(k_pack._retired, (a, b))] == [True, True]


def _carry_before(row_bits, row_cap, fbits, frame_ovf, new_bits, state, per_frame):
    """The operations of the gop program's step that the carry kernel
    replaced, as the step ran them: P's overflow flag, the GOP advance, the
    overflow ORs, the two scatters, the copies of the carry and k's add."""
    seq_bits, overflow, i_frame, pframes, frame_no, k = state
    pack_ovf = (row_bits > 32 * row_cap).any()
    i_next = torch.where(i_frame >= pframes, 0, i_frame + 1)
    ovf, fno = overflow | pack_ovf | frame_ovf, frame_no + 1
    per_frame[0].scatter_(0, k, fbits.view(1))
    per_frame[1].scatter_(0, k, i_frame.view(1))
    for dst, src in zip((seq_bits, overflow, i_frame, frame_no), (new_bits, ovf, i_next, fno)):
        dst.copy_(src)
    k.add_(1)


@pytest.mark.parametrize("over", ["row", "frame", "none"])
@pytest.mark.parametrize("k", [0, 63])
@pytest.mark.parametrize("i_frame,pframes", [(2, 2), (1, 2), (0, 2), (0, 0)])
def test_carry_plain_equals_the_steps_ops(i_frame, pframes, k, over):
    """The carry's plain version equals the operations it replaced, and the
    GOP rules: the wrap at i_frame = pframes (and every frame an I-frame at
    pframes 0), the per-frame outputs written at k = 0 and at the last
    index, the overflow from one of P's rows (row 40, past the first 32),
    from M's frame bits, or from neither."""
    row_cap, frames_cap = 16, 64
    row_bits = torch.full((74,), 32 * row_cap, dtype=torch.int64)
    row_bits[40] += 8 if over == "row" else 0
    merge = (torch.tensor(3000, dtype=torch.int64), torch.tensor(over == "frame"),
             torch.tensor(12345 + 3000, dtype=torch.int64))

    def state():
        return ((torch.tensor(12345, dtype=torch.int64), torch.tensor(False), _i32(i_frame),
                 _i32(pframes), _i32(1439), torch.tensor([k], dtype=torch.int64)),
                (torch.full((frames_cap,), -1, dtype=torch.int64),
                 torch.full((frames_cap,), -1, dtype=torch.int32)))

    got, want = state(), state()
    k_carry.gop_carry(row_bits, row_cap, *merge, *got)
    _carry_before(row_bits, row_cap, *merge, *want)
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    seq_bits, overflow, i_next, _, fno, k_next = got[0]
    assert int(seq_bits) == 15345 and bool(overflow) is (over != "none")
    assert int(i_next) == (0 if i_frame >= pframes else i_frame + 1)
    assert (int(fno), int(k_next)) == (1440, k + 1)
    assert int(got[1][0][k]) == 3000 and int(got[1][1][k]) == i_frame
    assert int((got[1][0] != -1).sum()) == int((got[1][1] != -1).sum()) == 1


@pytest.mark.parametrize("case", ["wrap", "intra", "row_over", "frame_over"])
def test_encode_gop_scan_equals_core(case):
    """encode_gop_scan on the CPU (its step with the carry's plain version,
    the recon written into the program's planes) equals the eager
    encode_gop_scan_core in all ten outputs over two calls, the second fed
    the first's recon, GOP position and frame number: across a GOP boundary
    (pframes 2 from position 1), every frame an I-frame (pframes 0), and
    with a row or the frame over its cap (the overflow flag set)."""
    w, h = 64, 64
    kw = dict(yr=6, ur=3, q_level=2, row_cap=1024, frame_cap=16384, seq_cap=65536)
    kw.update({"row_over": dict(row_cap=8), "frame_over": dict(frame_cap=64)}.get(case, {}))
    pframes = 0 if case == "intra" else 2
    frames = video(77, w, h, 7, "noise" if case.endswith("over") else "pan")
    stacks = [torch.from_numpy(np.stack([f[i] for f in frames])) for i in range(3)]
    zy, zc = torch.zeros((h, w), dtype=torch.uint8), torch.zeros((h // 2, w // 2),
                                                                 dtype=torch.uint8)
    core = prog = ((zy, zc, zc), 1 if pframes else 0, 1438)
    graphs.clear()
    for a, b in ((0, 4), (4, 7)):
        chunk = [t[a:b] for t in stacks]
        want = M.encode_gop_scan_core(*chunk, *core[0], core[1], core[2], pframes, **kw)
        got = M.encode_gop_scan(*chunk, *prog[0], prog[1], prog[2], _i32(pframes), **kw)
        for k in range(3):
            assert torch.equal(got[k], want[k]), (a, k)
        assert torch.equal(got[3], want[3]) and int(got[4]) == int(want[4])
        assert (int(got[5]), int(got[6])) == (want[5], want[6]) == (
            (core[1] + b - a) % (pframes + 1), core[2] + b - a)
        assert bool(got[7]) is bool(want[7]) is case.endswith("over")
        assert got[8].tolist() == want[8].tolist() and got[9].tolist() == want[9]
        core, prog = (want[:3], want[5], want[6]), (got[:3], got[5], got[6])
    graphs.clear()


@pytest.mark.parametrize("layout", STACK_LAYOUTS)
def test_encode_gop_scan_reads_each_stack_layout(layout):
    """encode_gop_scan equals encode_gop_scan_core in all ten outputs
    whatever the layout of the stacks it is handed (a slice at frame 2, the
    planes of push_chunk's (F, 3, H, W) stack, three frame strides, every
    other column); frames_in_place counts the chunk's frames where each
    plane is read in place, stack_copies each plane copied first (only the
    column-strided ones), and the program keeps the stacks it read."""
    w, h, f = 64, 64, 3
    kw = dict(yr=6, ur=3, q_level=2, row_cap=1024, frame_cap=16384, seq_cap=65536)
    frames = video(78, w, h, f)
    plain = [torch.from_numpy(np.stack([fr[i] for fr in frames])) for i in range(3)]
    stacks = stack_layout(plain, layout)
    zy, zc = torch.zeros((h, w), dtype=torch.uint8), torch.zeros((h // 2, w // 2),
                                                                 dtype=torch.uint8)
    want = M.encode_gop_scan_core(*plain, zy, zc, zc, 1, 7, 2, **kw)
    graphs.clear()
    before = dict(profiling.COUNTS)
    got = M.encode_gop_scan(*stacks, zy, zc, zc, 1, 7, 2, **kw)
    counted = {k: profiling.COUNTS.get(k, 0) - before.get(k, 0)
               for k in ("frames_in_place", "stack_copies")}
    assert counted == ({"frames_in_place": 0, "stack_copies": 3} if layout == "strided"
                       else {"frames_in_place": f, "stack_copies": 0})
    (prog,) = graphs._programs.values()
    assert all((s is t) is (layout != "strided") for s, t in zip(prog.stacks, stacks))
    for k in range(4):
        assert torch.equal(got[k], want[k]), k
    assert int(got[4]) == int(want[4]) and (int(got[5]), int(got[6])) == (want[5], want[6])
    assert bool(got[7]) is bool(want[7]) is False
    assert got[8].tolist() == want[8].tolist() and got[9].tolist() == want[9]
    with pytest.raises(ValueError, match="frames_v"):
        M.encode_gop_scan(*stacks[:2], stacks[2][:, :, :32], zy, zc, zc, 1, 7, 2, **kw)
    graphs.clear()
