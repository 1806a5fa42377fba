"""Slice-row sharding in the port (parallel/spatial.py, parallel/halo.py)
against the single-device encoder and the JAX package, exact.

The sharded programs run over 2 and 4 gloo ranks on the CPU
(tests/torch_ranks.py spawns them once per rank count), their recon fed back
frame after frame and the GOP state given as host ints and as int32
tensors; the per-shard step and the local and tail programs also run in one
process with the halos cut from the whole previous recon, and the programs
on a one-rank group of this process against the eager factory.  The 128x128
frames put one or two macroblock rows on a shard, so the edge shards are
frame edges and every shard boundary crosses a motion-search halo; the
416x64 frames put one row on each of 4 shards at nbx = 26."""
import contextlib

import numpy as np
import pytest
import torch
import torch.distributed as dist

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

import torch_ranks as R
from fpga_mpeg2_encoder_tpu.models import encoder as JM
from fpga_mpeg2_encoder_tpu.ops import entropy as jentropy
from fpga_mpeg2_encoder_tpu.parallel.mesh import make_mesh as jax_make_mesh
from fpga_mpeg2_encoder_tpu.parallel.mesh import make_mesh2d as jax_make_mesh2d
from fpga_mpeg2_encoder_tpu.parallel.spatial import (
    make_sharded_batch_encoder as jax_sharded_batch_encoder,
    make_sharded_frame_encoder as jax_sharded_frame_encoder,
    sharded_batch_shardings,
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
from fpga_mpeg2_encoder_tpu_torch.parallel import spatial as S
from fpga_mpeg2_encoder_tpu_torch.parallel.mesh import make_mesh, make_mesh2d
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
    (words, bits, recon planes) a frame."""
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
        res.append((np.asarray(fw)[:nw].astype(np.int64), int(fb),
                    tuple(np.asarray(p) for p in prev)))
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


@pytest.mark.parametrize("world,w,h,kind", [(2, 96, 256, "noise"), (4, 128, 128, "pan"),
                                            (4, 416, 64, "pan")])
def test_sharded_frame_encoder_matches_jax_sharded(ranks, world, w, h, kind):
    """The payload and every rank's recon rows over gloo ranks equal the
    JAX package's sharded encoder on as many devices, frame by frame with
    each recon fed back (its jit takes ~16 s a shape, so three of the six
    pairs; the others are held to encode_frame_core above, which
    tests/test_spatial.py holds the JAX sharded encoder to)."""
    out = ranks(world)
    res = [R.load(out, f"frames_{w}x{h}_r{r}") for r in range(world)]
    for fi, (words, bits, recon) in enumerate(_jax_sharded_frames(w, h, kind, world)):
        for r, got in enumerate(res):
            a, b = got["rows"]
            assert int(got[f"bits{fi}"]) == bits, (fi, r)
            assert np.array_equal(got[f"words{fi}"], words), (fi, r)
            for c, plane, rows in zip("yuv", recon, (16, 8, 8)):
                assert np.array_equal(got[f"{c}{fi}"], plane[rows * a:rows * b]), (fi, r, c)


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


def _jax_sharded_batch(world, n=3):
    """The JAX package's stream x slice encoder on a 2 x (world/2) CPU mesh
    over the 2-D case's streams, each fed its recon back: (words (B,
    frame_cap), bits (B,)) a frame."""
    b, h, w = 4, 64, 96
    mesh = jax_make_mesh2d(2, world // 2)
    enc = jax_sharded_batch_encoder(mesh, b, h, w, **R.KW, demote=False)
    plane, scalar = sharded_batch_shardings(mesh)
    vids = R.batch_videos(w, h, n)
    prev = tuple(jax.device_put(np.zeros(s, np.uint8), plane)
                 for s in ((b, h, w), (b, h // 2, w // 2), (b, h // 2, w // 2)))
    res = []
    for fi in range(n):
        planes = [jax.device_put(np.stack([vids[s][fi][i] for s in range(b)]), plane)
                  for i in range(3)]
        *prev, fw, fb, ovf = enc(*planes, *prev,
                                 jax.device_put(np.asarray(R.batch_i_frames(fi), np.int32),
                                                scalar),
                                 jax.device_put(np.full(b, fi, np.int32), scalar))
        assert not np.asarray(ovf).any()
        res.append((np.asarray(fw).astype(np.int64), np.asarray(fb).astype(np.int64),
                    tuple(np.asarray(p) for p in prev)))
    return res


@pytest.mark.parametrize("world", [2, 4])
def test_stream_by_slice_2d_matches_jax(ranks, world):
    """The 2 x (world/2) stream x slice program over gloo ranks, its GOP
    state as (B_l,) int32 tensors, equals the JAX package's
    make_sharded_batch_encoder on as many devices, stream by stream and
    frame by frame: payload and recon rows."""
    out = ranks(world)
    res = [R.load(out, f"batch2d_r{r}") for r in range(world)]
    for fi, (words, bits, recon) in enumerate(_jax_sharded_batch(world)):
        for got in res:
            s0, s1 = got["streams"]
            a, b = got["rows"]
            for j, s in enumerate(range(s0, s1)):
                nw = (int(bits[s]) + 31) // 32
                assert not got[f"ovf{fi}"][j] and int(got[f"bits{fi}"][j]) == int(bits[s])
                assert np.array_equal(got[f"words{fi}"][j, :nw], words[s, :nw]), (fi, s)
                for c, plane, rows in zip("yuv", recon, (16, 8, 8)):
                    assert np.array_equal(got[f"{c}{fi}"][j], plane[s, rows * a:rows * b]), \
                        (fi, s, c)


@pytest.mark.parametrize("world", [2, 4])
def test_stream_by_slice_2d_collectives_once_a_frame(ranks, world):
    """Each frame of the batch program makes, for all of a rank's streams,
    one halo exchange a plane (one batch of sends and receives each where
    the rank has a neighbour: on the 2 x 2 mesh), one all_gather of the
    words and one of the bits into the tail program's inputs and one
    all_reduce of the flags, and no list all_gather."""
    out = ranks(world)
    nf, p2p = 3, 3 if world > 2 else 0
    want = dict(zip(R.BATCH_COLLECTIVES, (3 * nf, p2p * nf, 2 * nf, 0, nf)))
    for r in range(world):
        calls = R.load(out, f"batch2d_r{r}")["calls"].tolist()
        assert dict(zip(R.BATCH_COLLECTIVES, calls)) == want, r


def _zeros(h, w, lead=()):
    return (torch.zeros(lead + (h, w), dtype=torch.uint8),
            torch.zeros(lead + (h // 2, w // 2), dtype=torch.uint8),
            torch.zeros(lead + (h // 2, w // 2), dtype=torch.uint8))


@pytest.mark.parametrize("w,h,kind", R.FRAME_SHAPES)
def test_shard_programs_in_one_process_equal_encode_frame_core(w, h, kind):
    """The local program at each first_row of 4 shards, then the tail
    program (make_shards_encoder; on the CPU the programs run their steps
    eagerly): payload and recon equal encode_frame_core's, IPPP, the recon
    fed back, the GOP state as ints and as 0-d int32 tensors."""
    enc = S.make_shards_encoder("cpu", 4, h, w, **R.KW, **CAPS)
    prev = _zeros(h, w)
    for fi, ((wy, wu, wv), wwords, wbits) in enumerate(_single_frames(w, h, kind)):
        f = R.video(w + h, w, h, 4, kind)[fi]
        ry, ru, rv, fw, fb, ovf = enc(*(torch.from_numpy(p) for p in f), *prev,
                                      *R.frame_scalar(fi))
        assert not bool(ovf) and int(fb) == wbits, fi
        assert np.array_equal(fw[:len(wwords)].numpy(), wwords), fi
        assert np.array_equal(ry.numpy(), wy) and np.array_equal(ru.numpy(), wu) \
            and np.array_equal(rv.numpy(), wv), fi
        prev = (ry, ru, rv)


@contextlib.contextmanager
def _one_rank_group(tmp_path):
    """A one-rank gloo process group of this process."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1,
                            rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _payload(out, j=None):
    fw, fb, ovf = (o if j is None else o[j] for o in out[3:])
    assert not bool(ovf)
    return int(fb), fw[:(int(fb) + 31) // 32].clone()


def test_one_rank_programs_equal_the_eager_factory(tmp_path):
    """On a one-rank gloo group of this process: the frame program equals
    make_sharded_frame_encoder_core (the eager factory) at 416x64, 4 frames
    IPPP, each fed its own recon back; the stream x slice program on a 1 x 1
    mesh, 3 streams in one block with (3,) int32 GOP state, equals the eager
    factory stream by stream."""
    w, h, nf = 416, 64, 4
    with _one_rank_group(tmp_path):
        mesh = make_mesh(1, axis="slice", device="cpu")
        prog = S.make_sharded_frame_encoder(mesh, h, w, **R.KW)
        core = S.make_sharded_frame_encoder_core(mesh, h, w, **R.KW)
        pp = pc = _zeros(h, w)
        for fi, f in enumerate(R.video(7, w, h, nf, "pan")):
            planes = tuple(torch.from_numpy(p) for p in f)
            got = prog(*planes, *pp, *R.frame_scalar(fi))
            want = core(*planes, *pc, fi, fi)
            (gb, gw), (wb, ww) = _payload(got), _payload(want)
            assert gb == wb and torch.equal(gw, ww), fi
            assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3])), fi
            pp, pc = got[:3], want[:3]

        b = 3
        batch = S.make_sharded_batch_encoder(make_mesh2d(1, 1, device="cpu"), b, h, w, **R.KW)
        vids = [R.video(40 + s, w, h, 3, "still" if s == 1 else "pan") for s in range(b)]
        pb, ps = _zeros(h, w, (b,)), [_zeros(h, w) for _ in range(b)]
        for fi in range(3):
            i_f = [(fi + s) % 2 for s in range(b)]
            planes = [torch.from_numpy(np.stack([v[fi][i] for v in vids])) for i in range(3)]
            got = batch(*planes, *pb, torch.tensor(i_f, dtype=torch.int32), [fi] * b)
            for s in range(b):
                want = core(*(p[s] for p in planes), *ps[s], i_f[s], fi)
                (gb, gw), (wb, ww) = _payload(got, s), _payload(want)
                assert gb == wb and torch.equal(gw, ww), (fi, s)
                assert all(torch.equal(a[s], c) for a, c in zip(got[:3], want[:3])), (fi, s)
                ps[s] = want[:3]
            pb = got[:3]


def test_programs_reject_wrong_shapes(tmp_path):
    """A program called with a frame or a previous recon of the wrong
    shape, or with GOP state for another number of streams, raises
    ValueError (the frame and batch programs on a one-rank gloo group of
    this process, and the in-process shards)."""
    w, h = 64, 64
    planes, prev = _zeros(h, w)[:1] * 3, _zeros(h, w)
    wide = _zeros(h, w + 16)[:1] * 3
    shards = S.make_shards_encoder("cpu", 4, h, w, **R.KW)
    with pytest.raises(ValueError, match="y444"):
        shards(*wide, *prev, 0, 0)
    with _one_rank_group(tmp_path):
        mesh = make_mesh(1, axis="slice", device="cpu")
        enc = S.make_sharded_frame_encoder(mesh, h, w, **R.KW)
        with pytest.raises(ValueError, match="y444"):
            enc(*wide, *prev, 0, 0)
        with pytest.raises(ValueError, match="halo"):
            enc(*planes, *_zeros(h - 16, w), 0, 0)
        with pytest.raises(ValueError, match="GOP state"):
            enc(*planes, *prev, torch.zeros(1, dtype=torch.int32), 0)
        batch = S.make_sharded_batch_encoder(make_mesh2d(1, 1, device="cpu"), 2, h, w,
                                             **R.KW)
        two, prev2 = _zeros(h, w, (2,))[:1] * 3, _zeros(h, w, (2,))
        with pytest.raises(ValueError, match="streams"):
            batch(*_zeros(h, w, (3,))[:1] * 3, *prev2, [0] * 3, [0] * 3)
        with pytest.raises(ValueError, match="i_frame"):
            batch(*two, *prev2, [0] * 3, [0] * 2)
        with pytest.raises(ValueError, match="frame_no"):
            batch(*two, *prev2, [0] * 2, torch.zeros(3, dtype=torch.int32))
        assert not bool(batch(*two, *prev2, [0, 1], [0, 0])[5].any())
