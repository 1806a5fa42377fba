"""push_chunk's staging (models/encoder.py::_Staging) on the CPU, where its
slots and payload buffer are ordinary memory: the ring of frame slots puts
every frame of a chunk at its index of the device stack, whatever the
chunk's length against the ring's; it takes any host plane the old
``np.stack`` took; the payload buffer grows only when a payload outgrows it.
A CPU encoder stages nothing, and its stream is the golden model's.  The
card's side (page-locked slots, the waits) is in tests/test_torch_cuda.py."""
import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from fpga_mpeg2_encoder_tpu_torch import Encoder, EncoderConfig, SequenceConfig
from fpga_mpeg2_encoder_tpu_torch.golden import encoder as G
from fpga_mpeg2_encoder_tpu_torch.models import encoder as M
from fpga_mpeg2_encoder_tpu_torch.utils import profiling
from fpga_mpeg2_encoder_tpu_torch.utils.testdata import video

W, H = 48, 32
S = M.STAGING_SLOTS
CPU = torch.device("cpu")


def _np_stack(frames):
    return [torch.from_numpy(np.stack([np.asarray(f[i], np.uint8) for f in frames]))
            for i in range(3)]


@pytest.mark.parametrize("lengths", [(1,), (S,), (S + 1, 2), (2 * S + 3, S - 1, 2 * S + 3)])
def test_staging_ring_puts_each_frame_at_its_index(lengths):
    """Chunks shorter and longer than the ring, one after another through
    one staging: each comes back as np.stack would lay it out, the stack
    grown to the longest chunk and no longer."""
    staging = M._Staging(CPU, H, W)
    profiling.COUNTS.clear()
    for i, n in enumerate(lengths):
        frames = video(i, W, H, n, "noise")
        got = staging.upload(frames, 0)
        for g, want in zip(got, _np_stack(frames)):
            assert g.shape == (n, H, W) and torch.equal(g, want)
    assert len(staging.stack) == max(lengths)
    assert profiling.COUNTS["staged_frames"] == sum(lengths)
    assert "staging_waits" not in profiling.COUNTS


def test_staging_takes_any_host_plane():
    """Read-only arrays (as the JAX package hands out), negative strides,
    views into wider arrays, another integer dtype and CPU tensors: staged
    as np.stack of their uint8 values, with no warning."""
    rng = np.random.default_rng(5)
    wide = rng.integers(0, 256, (H, 2 * W), dtype=np.uint8)
    frozen = rng.integers(0, 256, (H, W), dtype=np.uint8)
    frozen.setflags(write=False)
    flipped = rng.integers(0, 256, (H, W), dtype=np.uint8)[::-1, ::-1]
    ints = rng.integers(0, 256, (H, W)).astype(np.int32)
    tensor = torch.from_numpy(rng.integers(0, 256, (H, W), dtype=np.uint8))
    frames = [(frozen, flipped, wide[:, 1::2]), (ints, tensor, frozen)] * (S // 2 + 1)
    staging = M._Staging(CPU, H, W)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = staging.upload(frames, 0)
    for g, want in zip(got, _np_stack([tuple(np.asarray(p) for p in f) for f in frames])):
        assert torch.equal(g, want)


def test_staging_download_grows_only_when_outgrown():
    """The payload through the buffer equals the plain download and the
    words' big-endian bytes; the buffer is replaced only by a payload
    longer than it, at the next power of two of its words."""
    rng = np.random.default_rng(6)
    words = torch.from_numpy(rng.integers(0, 1 << 32, 1000, dtype=np.int64))
    staging = M._Staging(CPU, H, W)
    sizes = []
    for nbits in (32 * 100 + 5, 32 * 40, 32 * 128, 32 * 1000, 32 * 600 - 3, 1):
        got = staging.download(words, nbits)
        assert got == M.payload_bytes(words, nbits)
        n = (nbits + 31) // 32
        assert got == words[:n].numpy().astype(">u4").tobytes()[: (nbits + 7) // 8]
        sizes.append((len(staging.words), staging.words.data_ptr()))
    assert [s[0] for s in sizes] == [128, 128, 128, 1024, 1024, 1024]
    assert sizes[0][1] == sizes[2][1] and sizes[3][1] == sizes[5][1]


def test_cpu_encoder_stages_nothing():
    """A CPU encoder has no transfer to stage: push_chunk keeps np.stack and
    the plain download, counts no staged frame, keeps no staging, and its
    stream (chunks of 4 over two GOPs) is the golden model's."""
    cfg, seq = EncoderConfig(xl=4, yl=4), SequenceConfig(64, 64, 2)
    frames = video(7, 64, 64, 6)
    profiling.COUNTS.clear()
    enc = Encoder(cfg, device="cpu")
    got = enc.encode(frames, 64, 64, 2, chunk_frames=4)
    assert enc._staging is None
    assert "staged_frames" not in profiling.COUNTS and "staging_waits" not in profiling.COUNTS
    assert got == G.encode_sequence(cfg, seq, frames)


def test_push_chunk_rejects_an_empty_chunk():
    enc = Encoder(EncoderConfig(xl=4, yl=4), device="cpu")
    enc.start_sequence(SequenceConfig(64, 64, 2))
    with pytest.raises(ValueError, match="at least one frame"):
        enc.push_chunk([])
