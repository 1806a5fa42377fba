"""Motion estimation and prediction (F): ``ops/motion``, ``csrc/me.cu``.
A P-frame reads the current luma and the reference planes, writes the inter
map, the vectors and the three prediction planes; its search is (2yr+1)^2
full-pel, 9 half-pel and 1 intra candidate absolute differences a pixel
plus the pixel sum, four to an INT32 operation (byte SIMD).  An I-frame
skips the search and reads no plane: me.cu only writes inter 0, mv 0 and
the predictions 128."""
KERNELS = ("me_fused_kernel",)
SAD_PER_OP = 4


def work(g, frame):
    wh, n_mb = g.width * g.height, g.mb
    writes = 9 * n_mb + wh + 2 * (wh // 4)          # inter, mvx, mvy; predictions
    if frame.is_i:
        return writes, 0
    reads = wh + wh + 2 * (wh // 4)                 # current y, reference y, u, v
    ops = n_mb * 256 * ((2 * g.yr + 1) ** 2 + 11) // SAD_PER_OP
    return reads + writes, ops
