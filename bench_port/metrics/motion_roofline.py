"""Motion estimation and prediction's share of its roofline, in percent, over the traced
frames (stages/motion.py counts its work; Run.roofline_share)."""


def read(run, part=None):
    return run.roofline_share("motion")
