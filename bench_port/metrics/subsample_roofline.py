"""The 4:4:4 to 4:2:0 subsample's share of its roofline, in percent, over the traced
frames (stages/subsample.py counts its work; Run.roofline_share)."""


def read(run, part=None):
    return run.roofline_share("subsample")
