"""Seeded operands for the checks of the merge and chroma kernels against
their plain versions (tests/test_torch_*.py and chip_smoke.py), in numpy;
and the layouts of frame stacks that encode_gop_scan's callers hand over,
in torch."""
import numpy as np

# the layouts of stack_layout; the subsample kernel reads all but "strided"
# in place
STACK_LAYOUTS = ("slice", "push_chunk", "mixed", "strided")


def random_sequence(rng, n_words, seq_bits):
    """A sequence buffer of n_words int64 words (each holding 32 bits) with
    random bits before bit seq_bits, as far as the buffer reaches, and zeros
    from it on."""
    seq = rng.integers(0, 1 << 32, n_words, dtype=np.uint64).astype(np.int64)
    w, rem = divmod(seq_bits, 32)
    seq[w + (rem > 0):] = 0
    if rem and w < n_words:
        seq[w] &= (0xFFFFFFFF << (32 - rem)) & 0xFFFFFFFF
    return seq


def chroma_maps(nby, nbx, lo, hi, seed):
    """(inter, mvx, mvy) maps: vectors in [lo, hi] half-pels, those of each
    plane edge's macroblocks pointing out of the plane at the range's ends
    (both half flags), and every (hx, hy) among the inter macroblocks."""
    rng = np.random.default_rng(seed)
    mvx = rng.integers(lo, hi + 1, (nby, nbx))
    mvy = rng.integers(lo, hi + 1, (nby, nbx))
    mvx[:, 0], mvx[:, -1] = rng.choice([lo, lo + 2], nby), rng.choice([hi, hi - 2], nby)
    mvy[0], mvy[-1] = rng.choice([lo, lo + 2], nbx), rng.choice([hi, hi - 2], nbx)
    inter = rng.random((nby, nbx)) < 0.85
    halves = {(int(x), int(y)) for x, y in zip((mvx[inter] >> 1) & 1, (mvy[inter] >> 1) & 1)}
    if halves != {(0, 0), (0, 1), (1, 0), (1, 1)}:
        raise ValueError(f"seed {seed} gives the (hx, hy) {sorted(halves)} only")
    return inter, mvx.astype(np.int32), mvy.astype(np.int32)


def video(seed, w, h, n, kind="pan"):
    """n YUV 4:4:4 uint8 frames (h, w): a panning gradient with texture
    (real motion), or noise (escape-heavy)."""
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


# Whole streams on the card against the golden model's encode_sequence
# (chip_smoke.py phase 10 and tests/test_torch_cuda.py): (width, height,
# q_level, vector_level, frames, content, pframes_count, stop_mode,
# partial_groups, chunk_frames).  Vector levels 1 and 2, q_level 1, 3 and 4,
# the partial stop, GOP wrap, at 64 and 416 px wide (nbx 26, where the
# reference's acsym kernel once broke), streaming and chunked.
GOLDEN_MATRIX = (
    (64, 64, 1, 1, 3, "noise", 23, "coincident", 0, 1),
    (64, 64, 4, 2, 3, "pan", 23, "partial", 1, 1),
    (64, 64, 3, 2, 7, "pan", 2, "clean", 0, 3),          # GOP wrap: I P P I P P I
    (416, 64, 3, 1, 3, "pan", 1, "partial", 37, 3),
    (416, 64, 4, 2, 4, "noise", 1, "clean", 0, 1),       # GOP wrap: I P I P
    (416, 64, 1, 1, 3, "pan", 23, "clean", 0, 3),
)


def stack_layout(stacks, layout):
    """The (F, H, W) uint8 tensors ``stacks`` (Y, U, V), equal in value, in
    the layout ``layout`` of STACK_LAYOUTS: "slice", each a contiguous slice
    from frame 2 of a longer stack whose first two frames differ; "push_chunk",
    the planes of one (F, 3, H, W) stack, as Encoder.push_chunk stages them
    (a frame stride of 3·H·W); "mixed", Y a slice, U a plane of an
    (F, 3, H, W) stack and V of an (F, 2, H, W) one, three frame strides;
    "strided", every other column of stacks twice as wide."""
    import torch

    y, u, v = stacks
    f, h, w = y.shape
    if layout == "slice":
        return tuple(torch.cat([255 - s[:1].expand(2, h, w), s])[2:] for s in stacks)
    if layout == "push_chunk":
        return torch.stack(stacks, 1).unbind(1)
    if layout == "mixed":
        return (stack_layout(stacks, "slice")[0], torch.stack([y, u, v], 1)[:, 1],
                torch.stack([v, u], 1)[:, 0])
    if layout == "strided":
        wide = [torch.zeros((f, h, 2 * w), dtype=s.dtype, device=s.device) for s in stacks]
        for dst, s in zip(wide, stacks):
            dst[..., ::2] = s
        return tuple(t[..., ::2] for t in wide)
    raise ValueError(f"unknown stack layout {layout!r}")
