"""``idle_share.<cell kind>``: the share of the traced window, in %, in
which no operation (kernel, copy, fill) ran on the device: one minus the
union of the profiler's device intervals over the window."""


def read(run, summary, name):
    if summary.window_s <= 0 or summary.busy_s <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_s / summary.window_s)
