"""The symbol glue's (with the header rows' cat) share of its roofline, in percent, over the traced
frames (stages/glue.py counts its work; Run.roofline_share)."""


def read(run, part=None):
    return run.roofline_share("glue")
