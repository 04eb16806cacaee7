"""Seconds the pipeline waited for a chunk's seed search before its wave
loop could start (the program's `pipeline.wait_search` spans), per 1000
reads aligned: the search on the critical path, not hidden under the
previous chunk's verification."""

from benchmark.spans import per_kread


def read(run):
    return per_kread(run, lambda spans: spans.seconds("pipeline.wait_search"))
