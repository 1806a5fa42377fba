"""AC symbolisation (A): ``csrc/acsym.cu``.  Reads zmod and the non-AC
slots of the grid (16 a macroblock, 3 a slice header), writes the whole
int32 slot grid."""
KERNELS = ("acsym_kernel",)


def work(g, frame):
    slots = 3 + 394 * g.mbx
    return 384 * 4 * g.mb + (16 * g.mb + 3 * g.mby) * 4 + 4 * g.mby * slots, 0
