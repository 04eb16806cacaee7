"""Seconds in the native host Myers engine during verification (the
program's `verify.host_engine` spans: the host-routed buckets of every
wave, the fused waves' host share included), per 1000 reads aligned."""

from benchmark.spans import per_kread


def read(run):
    return per_kread(run, lambda spans: spans.seconds("verify.host_engine"))
