"""Slot-row packing (P): ``ops/bitpack``, ``csrc/pack.cu::pack_slots_kernel``.
Reads the (2 + mb rows, S) int32 slot grid, writes each row's words and its
bit count: the words the frame's bits need, counted at 4 bytes (32-bit
values)."""
KERNELS = ("pack_slots_kernel",)
WORD_BYTES = 4


def work(g, frame):
    rows = g.mby + 2
    return rows * (3 + 394 * g.mbx) * 4 + WORD_BYTES * (frame.row_words + rows), 0
