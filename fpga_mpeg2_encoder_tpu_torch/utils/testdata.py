"""Seeded operands for the checks of the merge and chroma kernels against
their plain versions (tests/test_torch_*.py and chip_smoke.py).  numpy only."""
import numpy as np


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
