"""The long-sequence soak of tests/test_soak.py on the port's CPU path: 300
frames through the chunked path with a saved and reloaded checkpoint
halfway, equal to the JAX package's golden model, and the timecode's minute
rollover at frame 1440 (24 fps, RTL:2684-2698) through push_frame and
through one push_chunk that straddles it.  The port forms the GOP timecode
from host ints (ops/entropy.py), so both paths are parsed by the port's
copy of the ISO validator against the 24 fps formula."""
import pytest
import torch

torch.set_num_threads(1)

from fpga_mpeg2_encoder_tpu.config import EncoderConfig as JaxConfig
from fpga_mpeg2_encoder_tpu.config import SequenceConfig as JaxSeq
from fpga_mpeg2_encoder_tpu.golden import encoder as JG
from fpga_mpeg2_encoder_tpu_torch import Encoder, EncoderConfig, SequenceConfig
from fpga_mpeg2_encoder_tpu_torch.core.bitstream import BitWriter, sequence_header_chunks
from fpga_mpeg2_encoder_tpu_torch.golden.validator import validate_sequence
from fpga_mpeg2_encoder_tpu_torch.runtime.state import EncoderState
from fpga_mpeg2_encoder_tpu_torch.utils.testdata import video

W = H = 64
CFG = EncoderConfig(xl=4, yl=4, vector_level=1, q_level=3)


def _frames(n, seed=1234):
    """n frames cycling through 12 of panning content, as tests/test_soak.py."""
    base = video(seed, W, H, 12)
    return [base[i % 12] for i in range(n)]


def _expected_timecode(frame_no: int):
    return (0, frame_no // (24 * 3600), (frame_no // (24 * 60)) % 60,
            (frame_no // 24) % 60, frame_no % 24)


def test_soak_300_frames_chunked_with_checkpoint(tmp_path):
    nf, pf, chunk = 300, 11, 50
    frames = _frames(nf)
    a = Encoder(CFG, device="cpu").encode(frames, W, H, pframes_count=pf,
                                          chunk_frames=chunk)

    enc = Encoder(CFG, device="cpu")
    enc.start_sequence(SequenceConfig(W, H, pf))
    for i in range(0, nf // 2, chunk):
        enc.push_chunk(frames[i:i + chunk])
    path = str(tmp_path / "ckpt.npz")
    enc.get_state().save(path)
    enc2 = Encoder(CFG, device="cpu")
    enc2.set_state(EncoderState.load(path))
    for i in range(nf // 2, nf, chunk):
        enc2.push_chunk(frames[i:i + chunk])
    assert enc2.finish() == a, "checkpoint/resume diverged over 300 frames"

    want = JG.encode_sequence(JaxConfig(4, 4, 1, 3), JaxSeq(W, H, pf), frames)
    assert a == want

    val = validate_sequence(a, expected_frames=nf)
    n_gops = (nf + pf) // (pf + 1)
    assert len(val.gop_timecodes) == n_gops
    for k, tc in enumerate(val.gop_timecodes):
        assert tc == _expected_timecode(k * (pf + 1)), f"GOP {k}"
    assert val.gop_timecodes[-1][3] >= 12


@pytest.mark.parametrize("path", ["push_frame", "push_chunk"])
def test_timecode_minute_rollover(path):
    """Resume at frame 1380 and encode 120 frames across frame 1440: the GOP
    headers roll seconds 57..59 into minute 1, through push_frame and
    through one push_chunk of all 120 frames."""
    pf, n = 5, 120
    frames = _frames(n)
    enc = Encoder(CFG, device="cpu")
    enc.set_state(EncoderState(width=W, height=H, pframes_count=pf, i_frame=0,
                               frame_no=1380, recon_y=None, recon_u=None, recon_v=None,
                               payload=b""))
    if path == "push_frame":
        for f in frames:
            enc.push_frame(*f)
    else:
        enc.push_chunk(frames)
    bw = BitWriter()                 # the resumed payload has no sequence header
    bw.put_chunks(sequence_header_chunks(W, H))
    data = bw.to_bytes_aligned() + enc.finish()
    data += b"\x00" * (-len(data) % 32)
    val = validate_sequence(data, expected_frames=n)
    gop_frames = [1380 + k * (pf + 1) for k in range(len(val.gop_timecodes))]
    assert len(gop_frames) == n // (pf + 1) and gop_frames[-1] >= 1440
    for tc, fn in zip(val.gop_timecodes, gop_frames):
        assert tc == _expected_timecode(fn), f"frame_no {fn}"
    assert {tc[2] for tc in val.gop_timecodes} == {0, 1}
