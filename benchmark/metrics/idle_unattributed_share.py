"""Percent of the window's device-idle time (the complement of the union
of device ops that device_idle_share reads) during which the thread that
ran the job's align phase had no program span open below `job` or
`align`, or none at all (between jobs too). Each idle instant goes to the
innermost span open on that thread; what no span names is this share."""

from benchmark.spans import traced_jobs, unattributed_share


def read(run):
    jobs = traced_jobs(run)
    if run.trace is None or not jobs:
        return None
    return unattributed_share(run.trace, [spans for _, spans in jobs])
