"""``host_syncs_per_frame.<traffic>``: the port's counter ``host_syncs``
(each blocking device read of ``Encoder.push_chunk`` and ``push_frame``) per
traced frame."""
from tally import count_per_frame


def read(run, part=None):
    return count_per_frame(run, "host_syncs")
