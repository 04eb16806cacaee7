"""Self time of the wave loop, per 1000 reads aligned: the duration of
every `verify.chunk` span and of its `verify.*` descendants (build, sim,
wave, scan) less what their children on the same thread cover. What is
left is the loop's own bookkeeping, in Python, NumPy and the native
cache scan; the spans of other work are left out: the host engine
(`verify.host_engine`), the device's dispatch and wait
(`verify.device_dispatch`, `verify.device_wait`) and the wait for the
chunk's search (`pipeline.wait_search`)."""

from benchmark.spans import per_kread, self_seconds

OTHER_WORK = ("verify.host_engine", "verify.device_dispatch",
              "verify.device_wait")


def read(run):
    return per_kread(run, lambda spans: self_seconds(
        spans.spans, "verify.chunk", "verify.", OTHER_WORK))
