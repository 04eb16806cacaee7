"""Reads of the window's jobs over the first job's start to the last
job's end, on the client's clock: what a user waits for on a read set."""


def read(run):
    if run.window_s <= 0:
        return None
    return sum(job.reads for job in run.ok_jobs) / run.window_s
