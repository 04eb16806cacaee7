"""The share of the window in which nothing ran on the device: 100 times
1 less the union of the trace's device ops (kernels, copies, fills)
over the window."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
