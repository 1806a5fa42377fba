"""Device operations (kernels, copies and fills) in the traced window, per
frame traced."""


def read(run, part=None):
    n = len(run.traced_frames)
    return len(run.trace.ops) / n if n and run.trace.ops else None
