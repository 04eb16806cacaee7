"""Seconds the pipeline waited for the previous chunk's finalize stage
(root tracebacks, statistics and SAM records on the finalize thread) to
end (the program's `pipeline.wait_finalize` spans), per 1000 reads
aligned."""

from benchmark.spans import per_kread


def read(run):
    return per_kread(run,
                     lambda spans: spans.seconds("pipeline.wait_finalize"))
