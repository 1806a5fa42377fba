"""AC symbolisation's share of its roofline, in percent, over the traced
frames (stages/acsym.py counts its work; Run.roofline_share)."""


def read(run, part=None):
    return run.roofline_share("acsym")
