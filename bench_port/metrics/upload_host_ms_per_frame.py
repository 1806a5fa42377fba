"""``upload_host_ms_per_frame.<traffic>``: host milliseconds a traced frame
in the port's span ``push_chunk.upload`` (the three pageable uploads of the
chunk's stacks; ``upload_ms_per_frame`` is their device side)."""
from tally import span_per_frame


def read(run, part=None):
    return span_per_frame(run, "push_chunk.upload", 1e3)
