"""``collect_us_per_frame.<config>``: host microseconds a traced frame in the
port's span ``batch.collect`` (``parallel/dp.py``: the copies of each
stream's outputs out of the compiled program's tensors into the batch's
stacks)."""
from tally import span_per_frame


def read(run, part=None):
    return span_per_frame(run, "batch.collect", 1e6)
