"""Subsample 4:4:4 -> 4:2:0 (D): ``ops/colorspace``, ``csrc/subsample.cu``.
Both 4:4:4 chroma planes read once, both 4:2:0 planes written once, three
byte averages an output byte."""
KERNELS = ("subsample_kernel",)


def work(g, frame):
    chroma420 = 2 * (g.width // 2) * (g.height // 2)
    return 2 * g.width * g.height + chroma420, 3 * chroma420
