"""Device milliseconds of the seed search's kernels K9-K12 (and the
sharded K13: csrc/fm_index.cu, fm_sharded.cu, workqueue_search.cu,
frontier_search.cu, select_anchors.cu) in the window, per 1000 reads
aligned, from the profiler's trace."""

PATTERN = (r"\b(fm_\w*kernel|workqueue_kernel|frontier_kernel"
           r"|select_kernel)\b")


def read(run):
    if run.trace is None or not run.kreads:
        return None
    return run.trace.kernel_seconds(PATTERN) * 1000.0 / run.kreads
