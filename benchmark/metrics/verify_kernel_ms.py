"""Device milliseconds of the verification kernels K1-K3
(floxer_tpu_torch/csrc/myers_*.cu) in the window, per 1000 reads
aligned, from the profiler's trace."""

PATTERN = r"\bmyers_\w*kernel\b"


def read(run):
    if run.trace is None or not run.kreads:
        return None
    return run.trace.kernel_seconds(PATTERN) * 1000.0 / run.kreads
