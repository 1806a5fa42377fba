"""``upload_host_ms_per_frame.<traffic>``: host milliseconds a traced frame
in the port's span ``push_chunk.upload`` (on a card, the waits for a slot
whose copy to the card has not ended and the enqueues of the slots' copies
into the device stack; on the CPU, the three uploads of the chunk's stacks;
``upload_ms_per_frame`` is their device side)."""
from tally import span_per_frame


def read(run, part=None):
    return span_per_frame(run, "push_chunk.upload", 1e3)
