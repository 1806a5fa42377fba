"""Transform (T): residual, DCT, quantise, dequantise, IDCT, reconstruction:
``ops/dct``, ``csrc/transform.cu``.  Reads the 4:2:0 planes, the
predictions and the inter map, writes int32 zig-zag coefficients and the
recon planes; 16 multiply-adds a coefficient for the forward DCT alone."""
KERNELS = ("transform_kernel",)


def work(g, frame):
    planes = 3 * g.width * g.height // 2
    return 3 * planes + g.mb * (1 + 384 * 4), 16 * 384 * g.mb
