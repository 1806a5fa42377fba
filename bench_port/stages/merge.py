"""Row merge and sequence append (M): ``csrc/pack.cu::merge_rows_kernel``.
Reads the rows' words and bit counts, reads and writes the sequence words
under the frame's bits, words counted at 4 bytes."""
KERNELS = ("merge_rows_kernel",)
WORD_BYTES = 4


def work(g, frame):
    rows = g.mby + 2
    touched = (frame.bits + frame.bit_offset + 31) // 32
    return WORD_BYTES * (frame.row_words + rows) + 2 * WORD_BYTES * touched, 0
