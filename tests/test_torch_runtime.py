"""The port's Encoder runtime against the JAX package's runtime tests
(tests/test_runtime_tools.py): the sequence statistics, their per-frame
equality between the chunked and the streaming path, and the clear error
for a frame that does not fit the latched sequence geometry, on both push
paths.  On the CPU (the plain versions)."""
import pytest
import torch

torch.set_num_threads(1)

from fpga_mpeg2_encoder_tpu import Encoder as JaxEncoder
from fpga_mpeg2_encoder_tpu.config import EncoderConfig as JaxConfig
from fpga_mpeg2_encoder_tpu.config import SequenceConfig as JaxSeq
from fpga_mpeg2_encoder_tpu_torch import Encoder, EncoderConfig, SequenceConfig


def test_stats_summary(video_factory):
    enc = Encoder(EncoderConfig(xl=4, yl=4), device="cpu")
    enc.start_sequence(SequenceConfig(64, 64, 2))
    for f in video_factory(64, 64, 3):
        enc.push_frame(*f)
    s = enc.stats.summary()
    assert s["frames"] == 3 and s["bytes"] > 0 and s["avg_bits_per_frame"] > 0
    enc.finish()


def test_stats_equal_between_chunked_and_streaming(video_factory):
    """Chunked per-frame stats come from the frame loop itself (each frame's
    bits and GOP position): they equal the streaming path's, and the JAX
    encoder's."""
    frames = video_factory(64, 64, 5)
    stats = []
    for chunks in (None, (3, 2)):
        enc = Encoder(EncoderConfig(xl=4, yl=4), device="cpu")
        enc.start_sequence(SequenceConfig(64, 64, 2))
        if chunks is None:
            for f in frames:
                enc.push_frame(*f)
        else:
            enc.push_chunk(frames[:chunks[0]])
            enc.push_chunk(frames[chunks[0]:])
        stats.append((enc.finish(), [(f.index, f.i_frame, f.bits) for f in enc.stats.frames]))
    jenc = JaxEncoder(JaxConfig(xl=4, yl=4))
    jenc.start_sequence(JaxSeq(64, 64, 2))
    for f in frames:
        jenc.push_frame(*f)
    want = (jenc.finish(), [(f.index, f.i_frame, f.bits) for f in jenc.stats.frames])
    assert stats[0] == stats[1] == want
    assert [i for _, i, _ in want[1]] == [0, 1, 2, 0, 1]


def test_oversized_frame_raises_clear_error(video_factory):
    """A frame larger than the EncoderConfig's max geometry fails with a
    clear ValueError on both push paths (the requested 512x272 sequence is
    clamped to the config's 256x256, RTL/mpeg2encoder.v:985-991), as the
    JAX package's does."""
    cfg = EncoderConfig(xl=4, yl=4)            # max 256x256
    frames = video_factory(512, 272, 2)
    enc = Encoder(cfg, device="cpu")
    enc.start_sequence(SequenceConfig(512, 272, 2))
    with pytest.raises(ValueError, match="max geometry"):
        enc.push_chunk(frames)
    enc2 = Encoder(cfg, device="cpu")
    enc2.start_sequence(SequenceConfig(512, 272, 2))
    with pytest.raises(ValueError, match="max geometry"):
        enc2.push_frame(*frames[0])
    jenc = JaxEncoder(JaxConfig(xl=4, yl=4))
    jenc.start_sequence(JaxSeq(512, 272, 2))
    with pytest.raises(ValueError, match="max geometry"):
        jenc.push_frame(*frames[0])


@pytest.mark.parametrize("bad", ["y", "u"])
def test_wrong_frame_within_max_geometry_raises(video_factory, bad):
    """A plane of the wrong size within the max geometry: the latched
    geometry in the message, no max-geometry hint; the port checks every
    plane, the chroma ones too."""
    f = video_factory(64, 64, 1)[0]
    small = video_factory(48, 48, 1)[0]
    frame = tuple(small[i] if name == bad else f[i] for i, name in enumerate("yuv"))
    for push in ("push_frame", "push_chunk"):
        enc = Encoder(EncoderConfig(xl=4, yl=4), device="cpu")
        enc.start_sequence(SequenceConfig(64, 64, 2))
        with pytest.raises(ValueError, match="latched sequence geometry") as err:
            if push == "push_frame":
                enc.push_frame(*frame)
            else:
                enc.push_chunk([f, frame])
        assert "max geometry" not in str(err.value)
        assert str(err.value).startswith(f"{bad} plane")
