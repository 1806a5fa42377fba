"""``host_launches_per_frame.<config>``: the port's counter ``host_launches``
(each host-side enqueue of the compiled programs: copies into their inputs,
scalar fills, zeroings, the result's two ops and each graph replay) per
traced frame."""
from tally import count_per_frame


def read(run, part=None):
    return count_per_frame(run, "host_launches")
