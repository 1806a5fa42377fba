"""``download_host_ms_per_frame.<traffic>``: host milliseconds a traced frame
in the port's span ``push_chunk.download`` (the payload's copy to the host and
its conversion to bytes)."""
from tally import span_per_frame


def read(run, part=None):
    return span_per_frame(run, "push_chunk.download", 1e3)
