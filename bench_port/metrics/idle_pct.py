"""``idle_pct.<traffic>``: the share of the traced window in which no
kernel, copy or fill ran on the card, in percent.  The suffix only keeps
apart the cells whose end-to-end metrics differ."""


def read(run, part=None):
    if run.trace.window_s <= 0 or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
