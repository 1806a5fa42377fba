"""``sync_ms_per_frame.<traffic>``: host milliseconds a traced frame in the
port's span ``push_chunk.sync`` (the blocking reads of the overflow flag, the
bit count, the frames' bits and types and the GOP state: the host waits
there for the chunk's device work)."""
from tally import span_per_frame


def read(run, part=None):
    return span_per_frame(run, "push_chunk.sync", 1e3)
