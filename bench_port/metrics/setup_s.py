"""Set-up: from the start of the process to the first timed unit (imports,
the card's start, the kernels' build where it is not cached, the content
pool, the warm-up and the capture)."""


def read(run, part=None):
    return run.setup_s
