"""Symbol glue (G): headers, macroblock type, vectors, CBP, DC, EOB and the
AC operands: ``ops/entropy``, ``csrc/glue.cu``, and the header rows' ``cat``
onto the slot grid.  Reads the coefficients, the maps and the GOP state,
writes zmod, the non-AC slot grid and the two header rows once; a nonzero
test a coefficient.  The ``cat`` is no work of its own: its time counts."""
KERNELS = ("glue_kernel", "CatArrayBatchedCopy")


def work(g, frame):
    slots = 3 + 394 * g.mbx
    io = 2 * 384 * 4 * g.mb + 9 * g.mb + 4 * g.mby * slots
    return io + 2 * slots * 4 + 8, 384 * g.mb
