"""Pixels of the frames whose payload reached the host in the window, over
the window's seconds, in millions: frames already on the card."""


def read(run, part=None):
    return run.mpix_per_s()
