"""``stack_ms_per_frame.<traffic>``: host milliseconds a traced frame in
the port's span ``push_chunk.stack`` (on a card, ``Encoder.push_chunk``'s copy
of each frame into a page-locked slot; on the CPU, its ``np.stack`` of each
plane of the chunk)."""
from tally import span_per_frame


def read(run, part=None):
    return span_per_frame(run, "push_chunk.stack", 1e3)
