"""Seconds from the process's start to the window: the server, the
genome, the index, the reads and the warm-up job."""


def read(run):
    return run.setup_s
