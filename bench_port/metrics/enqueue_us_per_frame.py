"""``enqueue_us_per_frame.<config>``: host microseconds a traced frame in the
port's span ``gop.feed`` (``encode_gop_scan``'s copies of a frame's planes
into the program and the graph's replay)."""
from tally import span_per_frame


def read(run, part=None):
    return span_per_frame(run, "gop.feed", 1e6)
