"""The port's bit packing (ops/bitpack.py, the plain versions of the pack and
merge kernels) against the JAX package's XLA merge trees and its Pallas pack
and merge kernels in interpret mode, on rows that do not overflow.  The
port's slots are int32 holding the uint32 pattern (negative from length 16
up); the JAX package's are uint32."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from fpga_mpeg2_encoder_tpu.ops import bitpack as jbitpack
from fpga_mpeg2_encoder_tpu.ops.pallas import pack as k_pack
from fpga_mpeg2_encoder_tpu_torch.ops import bitpack
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import _build
from fpga_mpeg2_encoder_tpu_torch.ops.kernels import pack as port_kernel
from fpga_mpeg2_encoder_tpu_torch.utils.testdata import random_sequence


@pytest.fixture
def interpret_pack():
    saved = (k_pack._INTERPRET, jbitpack._PACK_IMPL)
    k_pack._INTERPRET = True
    yield
    k_pack._INTERPRET, jbitpack._PACK_IMPL = saved


def _slots(r, s, seed):
    """Mixed-length symbols as int32 slots; a third of the zero-length slots
    carry a dead nonzero code, which must emit nothing."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, 25, (r, s)).astype(np.int64)
    lens[rng.random((r, s)) < 0.5] = 0
    codes = rng.integers(0, 1 << 24, (r, s)).astype(np.int64) & ((1 << lens) - 1)
    dead = (lens == 0) & (rng.random((r, s)) < 0.33)
    codes[dead] = rng.integers(1, 1 << 25, dead.sum())
    slots = (codes | (lens << 27)).astype(np.uint32).view(np.int32)
    assert (slots < 0).any()                     # lengths >= 16
    return slots


def _rows(r, c, seed):
    rng = np.random.default_rng(seed)
    bits = (rng.integers(0, c * 24 // 8, (r,)) * 8).astype(np.int64)
    words = np.zeros((r, c), np.int64)
    for k in range(r):
        nw = (int(bits[k]) + 31) // 32
        w = rng.integers(0, 1 << 32, nw, dtype=np.uint64).astype(np.int64)
        rem = int(bits[k]) % 32
        if nw and rem:
            w[-1] &= (0xFFFFFFFF << (32 - rem)) & 0xFFFFFFFF
        words[k, :nw] = w
    return words, bits


@pytest.mark.parametrize("r,s,cap,impls", [(5, 300, 320, ("xla", "pallas")),
                                            (3, 1181, 1024, ("xla",))])
def test_pack_slots_matches_jax(interpret_pack, r, s, cap, impls):
    slots = _slots(r, s, s)
    words, bits, ovf = bitpack.pack_slots(torch.from_numpy(slots), cap)
    assert not bool(ovf)
    jslots = jnp.asarray(slots.view(np.uint32))
    for impl in impls:
        jbitpack._PACK_IMPL = impl
        if impl == "xla":
            ww, wb, wovf = jax.jit(jbitpack.pack_slots, static_argnums=(1, 2))(
                jslots, cap, 0)
        else:
            ww, wb, wovf = k_pack.pack_slots_pallas(jslots, cap)
        assert not bool(wovf)
        assert np.array_equal(bits.numpy(), np.asarray(wb)), impl
        assert np.array_equal(words.numpy(), np.asarray(ww).astype(np.int64)), impl


def test_pack_symbols_matches_jax(interpret_pack):
    """pack_symbols, the plain version and the port's wrapper on CPU tensors,
    against the JAX package's XLA pack_symbols and its Pallas pack_symbols
    (interpreted), on rows that do not overflow."""
    slots = _slots(4, 300, 11).view(np.uint32).astype(np.int64)
    lens = slots >> 27
    codes = slots & ((1 << 27) - 1) & ((1 << lens) - 1)
    jcodes, jlens = jnp.asarray(codes.astype(np.uint32)), jnp.asarray(lens.astype(np.int32))
    jbitpack._PACK_IMPL = "xla"
    wants = [jbitpack.pack_symbols(jcodes, jlens, 320),
             k_pack.pack_symbols_pallas(jcodes, jlens, 320)]
    before = dict(_build.LAUNCHES)
    for words, bits, ovf in (bitpack.pack_symbols(*map(torch.from_numpy, (codes, lens)), 320),
                             port_kernel.pack_symbols(*map(torch.from_numpy, (codes, lens)),
                                                      320)):
        assert not bool(ovf)
        for ww, wb, wovf in wants:
            assert not bool(wovf)
            assert np.array_equal(bits.numpy(), np.asarray(wb))
            assert np.array_equal(words.numpy(), np.asarray(ww).astype(np.int64))
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("r,c,cap,pallas", [(5, 256, 512, True),
                                             (33, 128, 8192, False)])
def test_merge_rows_matches_jax(interpret_pack, r, c, cap, pallas):
    words, bits = _rows(r, c, 100 + r)
    got_w, got_b = bitpack.merge_rows(torch.from_numpy(words), torch.from_numpy(bits), cap)
    jw, jb = jnp.asarray(words.astype(np.uint32)), jnp.asarray(bits.astype(np.int32))
    wants = [k_pack.merge_rows_pallas(jw, jb, cap)] if pallas else []
    jbitpack._PACK_IMPL = "xla"
    wants.append(jax.jit(jbitpack.merge_rows, static_argnums=2)(jw, jb, cap))
    for want_w, want_b in wants:
        assert int(got_b) == int(want_b)
        assert np.array_equal(got_w.numpy(), np.asarray(want_w).astype(np.int64))


def test_symbol_slots_are_int32_uint32_patterns():
    """symbol_slots narrows code | len << 27 to int32 (wrapping), and
    pack_slots reads it back as uint32: the same words as from the int64
    values of the same pattern."""
    slots = _slots(3, 200, 5)
    u = slots.view(np.uint32).astype(np.int64)
    lens, codes = u >> 27, u & ((1 << 27) - 1) & ((1 << (u >> 27)) - 1)
    got = bitpack.symbol_slots(torch.from_numpy(codes), torch.from_numpy(lens))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32), (codes | lens << 27).astype(np.uint32))
    w32, b32, _ = bitpack.pack_slots(torch.from_numpy(slots), 256)
    w64, b64, _ = bitpack.pack_slots(torch.from_numpy(u), 256)
    assert torch.equal(w32, w64) and torch.equal(b32, b64)


def test_pack_overflow_is_exact_and_truncates():
    """A row overflows iff its bits exceed 32 * cap; the words kept are the
    first cap words of the uncapped row."""
    slots = torch.from_numpy(_slots(4, 300, 7))
    full_w, full_b, full_ovf = bitpack.pack_slots(slots, 400)
    assert not bool(full_ovf)
    cap = int(full_b.min()) // 32 + 1
    w, b, ovf = bitpack.pack_slots(slots, cap)
    assert torch.equal(b, full_b)
    assert bool(ovf) == bool((full_b > 32 * cap).any()) and bool(ovf)
    assert torch.equal(w, full_w[:, :cap])
    mw, mb = bitpack.merge_rows(full_w, full_b, 16)
    fw, fb = bitpack.merge_rows(full_w, full_b, 400)
    assert int(mb) == int(fb) > 32 * 16 and torch.equal(mw, fw[:16])


def test_wrappers_run_plain_versions_on_cpu_and_refuse_other_devices():
    slots = torch.from_numpy(_slots(3, 200, 3))
    before = dict(_build.LAUNCHES)
    w, b, o = port_kernel.pack_slots(slots, 256)
    mw, mb = port_kernel.merge_rows(w, b, 1024)
    assert _build.LAUNCHES == before
    pw, pb, _ = bitpack.pack_slots(slots, 256)
    assert torch.equal(w, pw) and torch.equal(b, pb)
    assert torch.equal(mw, bitpack.merge_rows(pw, pb, 1024)[0])
    with pytest.raises(ValueError, match="device"):
        port_kernel.pack_slots(slots.to("meta"), 256)
    with pytest.raises(ValueError, match="several devices"):
        port_kernel.merge_rows(w, b.to("meta"), 1024)


@pytest.mark.parametrize("cap", [4, 256])
def test_pack_rows_on_cpu_packs_the_stacked_rows(cap):
    """pack_rows (the gop program's entry: header rows and slice rows apart)
    runs the plain version on the stacked rows on CPU tensors, without a
    launch; a cap of 4 words makes rows overflow."""
    slots = torch.from_numpy(_slots(5, 301, 4))
    before = dict(_build.LAUNCHES)
    w, b = port_kernel.pack_rows(slots[:2], slots[2:], cap)
    assert _build.LAUNCHES == before
    pw, pb, po = bitpack.pack_slots(slots, cap)
    assert torch.equal(w, pw) and torch.equal(b, pb) and bool(po) is (cap == 4)
    with pytest.raises(ValueError, match="several devices"):
        port_kernel.pack_rows(slots[:2], slots[2:].to("meta"), cap)


def test_pack_wrapper_tile_matches_kernel_source():
    """The wrapper sizes the look-back buffer by TILE slots a tile: it must
    be the kernel's PACK_THREADS * SPT."""
    import os
    import re
    src = open(os.path.join(_build.CSRC, "pack.cu")).read()
    threads, spt = (int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
                    for n in ("PACK_THREADS", "SPT"))
    assert threads * spt == port_kernel.TILE


def test_append_bitstring_sizing_contract_and_offsets():
    with pytest.raises(ValueError, match="sizing contract"):
        bitpack.append_bitstring(torch.zeros(64, dtype=torch.int64),
                                 torch.tensor(0), torch.zeros(64, dtype=torch.int64),
                                 torch.tensor(32))
    words, bits = _rows(6, 16, 9)
    seq = torch.zeros(6 * 16 + 17, dtype=torch.int64)
    sb = torch.tensor(0)
    for k in range(6):
        seq, sb = bitpack.append_bitstring(seq, sb, torch.from_numpy(words[k]),
                                           torch.tensor(int(bits[k])))
    want, wb = bitpack.merge_rows(torch.from_numpy(words), torch.from_numpy(bits), 6 * 16)
    assert int(sb) == int(wb)
    assert torch.equal(seq[:6 * 16], want)


_jmerge = jax.jit(jbitpack.merge_rows, static_argnums=2)
_jappend = jax.jit(jbitpack.append_bitstring)


@pytest.mark.parametrize("residue", [0, 1, 7, 8, 31])
@pytest.mark.parametrize("case", ["zero-rows", "cut", "clamp"])
def test_merge_append_matches_jax(case, residue):
    """bitpack.merge_append (the merge kernel's plain version, and the
    wrapper on CPU tensors) against the JAX package's merge_rows followed by
    append_bitstring, both jitted: rows of 0 bits among the rows; a frame cut
    at frame_cap (its overflow flag set); the window's offset clamped to the
    buffer's end.  The bits before seq_bits stay, at every residue."""
    words, bits = _rows(6, 16, 7)
    bits[[1, 4]] = 0
    words[[1, 4]] = 0
    total = int(bits.sum())
    frame_cap = total // 32 - 3 if case == "cut" else 6 * 16
    seq_bits = 32 * (9 if case == "clamp" else 3) + residue
    n_words = frame_cap + 1 + (2 if case == "clamp" else 40)
    seq = random_sequence(np.random.default_rng(residue), n_words, seq_bits)
    jw, jb = _jmerge(jnp.asarray(words.astype(np.uint32)), jnp.asarray(bits.astype(np.int32)),
                     frame_cap)
    want_seq, want_bits = _jappend(jnp.asarray(seq.astype(np.uint32)), jnp.int32(seq_bits),
                                   jw, jb)
    for fn in (bitpack.merge_append, port_kernel.merge_append):
        got = fn(torch.from_numpy(seq.copy()), torch.tensor(seq_bits), torch.from_numpy(words),
                 torch.from_numpy(bits), frame_cap)
        assert np.array_equal(got[0].numpy(), np.asarray(want_seq).astype(np.int64))
        assert int(got[1]) == int(want_bits) == seq_bits + total
        assert int(got[2]) == int(jb) == total
        assert bool(got[3]) == (case == "cut")
    assert bool(np.asarray(want_seq)[:seq_bits // 32].any())


def test_merge_append_wrapper_on_cpu_and_sizing_contract():
    """On CPU tensors merge_append runs its plain version (no launch); a
    buffer that cannot take the frame_cap + 1 word window is refused, on
    either path."""
    words, bits = _rows(4, 8, 3)
    before = dict(_build.LAUNCHES)
    seq = torch.zeros(4 * 8 + 1, dtype=torch.int64)
    got = port_kernel.merge_append(seq, torch.tensor(5), torch.from_numpy(words),
                                   torch.from_numpy(bits), 4 * 8)
    assert _build.LAUNCHES == before and got[0] is seq
    with pytest.raises(ValueError, match="sizing contract"):
        port_kernel.merge_append(torch.zeros(4 * 8, dtype=torch.int64), torch.tensor(0),
                                 torch.from_numpy(words), torch.from_numpy(bits), 4 * 8)
    with pytest.raises(ValueError, match="several devices"):
        port_kernel.merge_append(seq, torch.tensor(0), torch.from_numpy(words),
                                 torch.from_numpy(bits).to("meta"), 4 * 8)
