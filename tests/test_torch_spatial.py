"""Slice-row sharding in the port (parallel/spatial.py, parallel/halo.py)
against the single-device encoder and the JAX package, exact.

The sharded paths run over 2 and 4 gloo ranks on the CPU (tests/torch_ranks.py
spawns them once per rank count); the per-shard step also runs in one
process with the halos cut from the whole previous recon.  The 128x128 frames
put one or two macroblock rows on a shard, so the edge shards are frame
edges and every shard boundary crosses a motion-search halo."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import torch_ranks as R
from fpga_mpeg2_encoder_tpu.models import encoder as JM
from fpga_mpeg2_encoder_tpu.ops import entropy as jentropy
from fpga_mpeg2_encoder_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fpga_mpeg2_encoder_tpu.parallel.spatial import (
    make_sharded_frame_encoder as jax_sharded_frame_encoder,
    sharded_frame_shardings,
)
from fpga_mpeg2_encoder_tpu_torch.core.bitstream import (
    BitWriter,
    SEQUENCE_END_CHUNKS,
    sequence_header_chunks,
)
from fpga_mpeg2_encoder_tpu_torch.golden.decoder import decode_sequence
from fpga_mpeg2_encoder_tpu_torch.golden.validator import validate_sequence
from fpga_mpeg2_encoder_tpu_torch.models.encoder import encode_frame_core, words_to_bytes
from fpga_mpeg2_encoder_tpu_torch.ops import entropy, motion
from fpga_mpeg2_encoder_tpu_torch.parallel.spatial import (
    band_with_halo,
    frame_tail,
    make_local_step,
)

CAPS = dict(row_cap=JM.DEFAULT_ROW_CAP, frame_cap=JM.DEFAULT_FRAME_CAP)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world -> the directory of the sharded cases' results on ``world``
    gloo ranks, each rank count spawned once."""
    done = {}

    def get(world):
        if world not in done:
            out = tmp_path_factory.mktemp(f"spatial{world}")
            R.run_ranks(world, out, ["row_sad", "frames", "batch2d"])
            done[world] = out
        return done[world]
    return get


def _single_frames(w, h, kind, n=4):
    """The port's encode_frame_core on the CPU: (recon, words, bits) a frame."""
    prev = (torch.zeros((h, w), dtype=torch.uint8),
            torch.zeros((h // 2, w // 2), dtype=torch.uint8),
            torch.zeros((h // 2, w // 2), dtype=torch.uint8))
    out = []
    for fi, f in enumerate(R.video(w + h, w, h, n, kind)):
        ry, ru, rv, fw, fb, ovf = encode_frame_core(
            *(torch.from_numpy(p) for p in f), *prev, fi, fi, **R.KW, **CAPS)
        assert not bool(ovf)
        nw = (int(fb) + 31) // 32
        out.append(((ry.numpy(), ru.numpy(), rv.numpy()), fw[:nw].numpy(), int(fb)))
        prev = (ry, ru, rv)
    return out


def _jax_sharded_frames(w, h, kind, nsh, n=4):
    """The JAX package's sharded frame encoder on an nsh-device slice mesh:
    (words, bits) a frame."""
    mesh = jax_make_mesh(nsh, axis="slice")
    enc = jax_sharded_frame_encoder(mesh, h, w, **R.KW, demote=False)
    plane, _ = sharded_frame_shardings(mesh)
    prev = tuple(jax.device_put(np.zeros(s, np.uint8), plane)
                 for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
    res = []
    for fi, f in enumerate(R.video(w + h, w, h, n, kind)):
        *prev, fw, fb, ovf = enc(*(jax.device_put(p, plane) for p in f), *prev,
                                 jnp.int32(fi), jnp.int32(fi))
        assert not bool(ovf)
        nw = (int(fb) + 31) // 32
        res.append((np.asarray(fw)[:nw].astype(np.int64), int(fb)))
    return res


@pytest.mark.parametrize("first_row,include_headers", [(0, True), (0, False), (5, False),
                                                       (17, True)])
def test_symbolize_frame_first_row_matches_jax(first_row, include_headers):
    """Slice headers numbered from first_row, with and without the two header
    rows, against the JAX package's XLA symbolize_frame (masked by length)."""
    rng = np.random.default_rng(first_row)
    nby, nbx = 3, 26
    zig = np.zeros((nby, nbx, 6, 64), np.int32)
    mask = rng.random(zig.shape) < 0.15
    zig[mask] = rng.integers(-60, 61, mask.sum())
    inter = rng.random((nby, nbx)) < 0.6
    mvx = rng.integers(-12, 13, (nby, nbx)).astype(np.int32)
    mvy = rng.integers(-12, 13, (nby, nbx)).astype(np.int32)
    got = entropy.symbolize_frame(torch.from_numpy(zig), torch.from_numpy(inter),
                                  torch.from_numpy(mvx), torch.from_numpy(mvy), 2, 7, 2,
                                  first_row=first_row, include_headers=include_headers)
    jentropy._ACSYM_IMPL, saved = "xla", jentropy._ACSYM_IMPL
    try:
        want = np.asarray(jax.jit(lambda *a: jentropy.symbolize_frame(
            *a, 2, first_row=first_row, include_headers=include_headers).slots)(
            jnp.asarray(zig), jnp.asarray(inter), jnp.asarray(mvx), jnp.asarray(mvy),
            jnp.int32(2), jnp.int32(7)))
    finally:
        jentropy._ACSYM_IMPL = saved
    got = got.numpy().view(np.uint32).astype(np.int64)
    want = want.astype(np.int64)
    assert got.shape == want.shape == (nby + 2 * include_headers, 3 + 394 * nbx)
    assert np.array_equal(np.where(got >> 27 > 0, got, 0), np.where(want >> 27 > 0, want, 0))
    row0 = 2 if include_headers else 0
    assert (got[row0:, 1] & 0xFF).tolist() == list(range(first_row + 1, first_row + 1 + nby))


@pytest.mark.parametrize("nsh", [2, 4, 8])
def test_local_steps_in_one_process_equal_encode_frame_core(nsh):
    """Each shard's local_step on halos cut from the whole previous recon
    (what the exchange gives), then the frame tail: the payload and the
    recon equal encode_frame_core's on every frame, edge shards included."""
    w, h = 128, 128
    nby = h // 16
    rows_l = nby // nsh
    step = make_local_step(nby, **R.KW, row_cap=CAPS["row_cap"])
    want = _single_frames(w, h, "pan")
    prev = (torch.zeros((h, w), dtype=torch.uint8),
            torch.zeros((h // 2, w // 2), dtype=torch.uint8),
            torch.zeros((h // 2, w // 2), dtype=torch.uint8))
    for fi, f in enumerate(R.video(w + h, w, h, 4, "pan")):
        outs = []
        for k in range(nsh):
            a, b = 16 * rows_l * k, 16 * rows_l * (k + 1)
            outs.append(step(*(torch.from_numpy(p[a:b].copy()) for p in f),
                             band_with_halo(prev[0], motion.LUMA_HALO, a, b),
                             band_with_halo(prev[1], motion.CHROMA_HALO, a // 2, b // 2),
                             band_with_halo(prev[2], motion.CHROMA_HALO, a // 2, b // 2),
                             fi, fi, rows_l * k))
        ry, ru, rv, words, bits = (torch.cat([o[i] for o in outs]) for i in range(5))
        ovf = torch.stack([o[5] for o in outs]).any()
        fw, fb, fovf = frame_tail(words, bits, ovf, fi, fi, **CAPS)
        (wy, wu, wv), wwords, wbits = want[fi]
        assert not bool(fovf) and int(fb) == wbits
        assert np.array_equal(fw[:len(wwords)].numpy(), wwords), fi
        assert np.array_equal(ry.numpy(), wy) and np.array_equal(ru.numpy(), wu) \
            and np.array_equal(rv.numpy(), wv), fi
        prev = (ry, ru, rv)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_row_sad(ranks, world):
    """Every rank returns the whole SAD volume, equal to the single-device
    volume (edge halos are zeros, as the whole frame's zero padding)."""
    out = ranks(world)
    cur, prev = R.sad_inputs(16 * 8, 64, 5)
    h, w = cur.shape
    prevp = np.pad(prev.astype(np.int32), 6)
    c = cur.astype(np.int32)
    want = np.stack([np.abs(c - prevp[6 + dy:6 + dy + h, 6 + dx:6 + dx + w])
                     .reshape(h // 16, 16, w // 16, 16).sum(axis=(1, 3))
                     for dy in range(-6, 7) for dx in range(-6, 7)])
    for r in range(world):
        assert np.array_equal(R.load(out, f"row_sad_r{r}")["vol"], want), r


@pytest.mark.parametrize("world", [2, 4])
def test_exchange_halo_gives_the_band_with_its_halo(ranks, world):
    """Each rank's rows padded by exchange_halo equal band_with_halo of the
    whole plane: the neighbours' rows inside the frame, zeros beyond it."""
    out = ranks(world)
    prev = torch.from_numpy(R.sad_inputs(16 * 8, 64, 5)[1])
    for r in range(world):
        got = R.load(out, f"row_sad_r{r}")
        a, b = got["rows"]
        want = band_with_halo(prev, 8, 16 * a, 16 * b)
        assert np.array_equal(got["halo"], want.numpy()), r


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("w,h,kind", R.FRAME_SHAPES)
def test_sharded_frame_encoder(ranks, world, w, h, kind):
    """Over gloo ranks: each frame's payload (on every rank) equals the port's
    encode_frame_core, and the recon rows of every rank equal the
    single-device recon."""
    out = ranks(world)
    res = [R.load(out, f"frames_{w}x{h}_r{r}") for r in range(world)]
    for fi, ((wy, wu, wv), wwords, wbits) in enumerate(_single_frames(w, h, kind)):
        for r, got in enumerate(res):
            a, b = got["rows"]
            assert not got[f"ovf{fi}"] and int(got[f"bits{fi}"]) == wbits, (fi, r)
            assert np.array_equal(got[f"words{fi}"], wwords), (fi, r)
            assert np.array_equal(got[f"y{fi}"], wy[16 * a:16 * b]), (fi, r)
            assert np.array_equal(got[f"u{fi}"], wu[8 * a:8 * b]), (fi, r)
            assert np.array_equal(got[f"v{fi}"], wv[8 * a:8 * b]), (fi, r)


@pytest.mark.parametrize("world,w,h,kind", [(2, 96, 256, "noise"), (4, 128, 128, "pan")])
def test_sharded_frame_encoder_matches_jax_sharded(ranks, world, w, h, kind):
    """The payload over gloo ranks equals the JAX package's sharded encoder
    on as many devices (its jit takes ~16 s a shape, so one shape a rank
    count; the other two pairs are held to encode_frame_core above, which
    tests/test_spatial.py holds the JAX sharded encoder to)."""
    out = ranks(world)
    got = R.load(out, f"frames_{w}x{h}_r{world - 1}")
    for fi, (words, bits) in enumerate(_jax_sharded_frames(w, h, kind, world)):
        assert int(got[f"bits{fi}"]) == bits
        assert np.array_equal(got[f"words{fi}"], words), fi


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_sequence_decodes(ranks, world):
    """A sequence assembled from the sharded payloads decodes (the port's
    copy of the decoder) to the sharded recon and passes the validator."""
    out = ranks(world)
    w, h = 128, 128
    res = [R.load(out, f"frames_{w}x{h}_r{r}") for r in range(world)]
    bw = BitWriter()
    bw.put_chunks(sequence_header_chunks(w, h))
    parts = [bw.to_bytes_aligned()]
    for fi in range(4):
        parts.append(words_to_bytes(res[0][f"words{fi}"], int(res[0][f"bits{fi}"])))
    end = BitWriter()
    end.put_chunks(SEQUENCE_END_CHUNKS)
    data = b"".join(parts) + end.to_bytes_aligned()
    data += b"\x00" * ((len(data) // 32 + 1) * 32 - len(data))
    dec = decode_sequence(data)
    assert len(dec.pictures) == 4
    for fi, pic in enumerate(dec.pictures):
        assert np.array_equal(pic.y, np.concatenate([r[f"y{fi}"] for r in res])), fi
        assert np.array_equal(pic.u, np.concatenate([r[f"u{fi}"] for r in res])), fi
    validate_sequence(data, expected_frames=4)


@pytest.mark.parametrize("world", [2, 4])
def test_stream_by_slice_2d(ranks, world):
    """The 2 x (world / 2) stream x slice encoder: every stream's payload
    and recon equal encode_frame_core's, with the streams' GOP phases
    differing so that their header rows differ in one batch."""
    out = ranks(world)
    b, h, w = 4, 64, 96
    vids = R.batch_videos(w, h, 3)
    res = [R.load(out, f"batch2d_r{r}") for r in range(world)]
    prev = [(torch.zeros((h, w), dtype=torch.uint8),
             torch.zeros((h // 2, w // 2), dtype=torch.uint8),
             torch.zeros((h // 2, w // 2), dtype=torch.uint8)) for _ in range(b)]
    for fi in range(3):
        for s in range(b):
            i_f = R.batch_i_frames(fi)[s]
            ry, ru, rv, fw, fb, ovf = encode_frame_core(
                *(torch.from_numpy(p) for p in vids[s][fi]), *prev[s], i_f, fi,
                **R.KW, **CAPS)
            prev[s] = (ry, ru, rv)
            nw = (int(fb) + 31) // 32
            for got in res:
                s0, s1 = got["streams"]
                a, c = got["rows"]
                if not s0 <= s < s1:
                    continue
                j = s - s0
                assert not got[f"ovf{fi}"][j] and int(got[f"bits{fi}"][j]) == int(fb)
                assert np.array_equal(got[f"words{fi}"][j, :nw], fw[:nw].numpy()), (fi, s)
                assert np.array_equal(got[f"y{fi}"][j], ry[16 * a:16 * c].numpy()), (fi, s)
                assert np.array_equal(got[f"u{fi}"][j], ru[8 * a:8 * c].numpy()), (fi, s)
                assert np.array_equal(got[f"v{fi}"][j], rv[8 * a:8 * c].numpy()), (fi, s)
