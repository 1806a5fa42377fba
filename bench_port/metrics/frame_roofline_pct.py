"""The whole frame step's share of the card: the sum of every stage's bound
(every file in stages/) over the traced frames, over the device's busy time
in the traced window, in percent.  It counts the same work whatever kernels
implement it, so it bounds a gain after a kernel is fused away."""


def read(run, part=None):
    if run.trace.busy_s <= 0:
        return None
    bound = sum(run.peaks.bound_s(*stage.work(run.geometry, f))
                for stage in run.stages().values() for f in run.traced_frames)
    return 100.0 * bound / run.trace.busy_s
