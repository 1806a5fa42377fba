"""Bit packing kernels (csrc/pack.cu).

pack_slots replaces ops/pallas/pack.py::pack_slots_pallas and merge_rows
replaces ops/pallas/pack.py::merge_rows_pallas of the JAX package;
pack_symbols replaces pack_symbols_pallas, which on the TPU as here forms the
slots and calls the pack kernel, and launches nothing of its own.
pack_slots and merge_rows move little data (at 1920x1152: 3.5 M slots into
pack_slots, 14 MB as the 32-bit values they are, 28 MB as the int64 they are
carried in) and are bound by the dependence of every bit offset on all
earlier lengths.  One prefix sum gives each symbol (or row
word) its offset, and it is OR-ed straight into one or two output words with
atomics, in place of the TPU's bit-reversed merge tree.  pack_slots runs one
block per row, so a frame of 74 slot rows fills 74 of the H100's 132 SMs.
On CPU tensors the plain versions in ops/bitpack.py run instead.

Unlike the JAX package there is no statistical level budget: a row overflows
exactly when its bits exceed 32 * cap_words.  Outputs that do not overflow
are identical to the JAX package's; overflow flags are never compared across
backends.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import bitpack
from . import _build


def pack_slots(slots: torch.Tensor, cap_words: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """slots (R, S) int64 -> (words (R, cap_words) int64, bits (R,) int64
    byte-aligned, overflow () bool); see bitpack.pack_slots."""
    if _build.on_cpu(slots):
        return bitpack.pack_slots(slots, cap_words)
    r, s = slots.shape
    _build.check(slots, "slots", torch.int64, (r, s))
    words = torch.empty((r, cap_words), dtype=torch.int64, device=slots.device)
    bits = torch.empty((r,), dtype=torch.int64, device=slots.device)
    _build.launch("mpeg2_pack_slots", "pack_slots", slots.device,
                  slots, words, bits, r, s, cap_words)
    return words, bits, (bits > 32 * cap_words).any()


def pack_symbols(codes: torch.Tensor, lens: torch.Tensor, cap_words: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(R, S) codes < 2**len and lens <= 24 -> as pack_slots, through the
    pack_slots kernel; see bitpack.pack_symbols."""
    if _build.on_cpu(codes, lens):
        return bitpack.pack_symbols(codes, lens, cap_words)
    return pack_slots(bitpack.symbol_slots(codes, lens), cap_words)


def merge_rows(words: torch.Tensor, bits: torch.Tensor, cap_words: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """words (R, C) int64, bits (R,) int64 byte-aligned -> (payload
    (cap_words,) int64, total bits); see bitpack.merge_rows."""
    if _build.on_cpu(words, bits):
        return bitpack.merge_rows(words, bits, cap_words)
    r, c = words.shape
    _build.check(words, "words", torch.int64, (r, c))
    _build.check(bits, "bits", torch.int64, (r,))
    out = torch.empty((cap_words,), dtype=torch.int64, device=words.device)
    _build.launch("mpeg2_merge_rows", "merge_rows", words.device,
                  words, bits, out, r, c, cap_words)
    return out, bits.sum()
