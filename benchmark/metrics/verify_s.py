"""The stage split's `verify=` seconds of the window's jobs, per 1000
reads aligned: the host wall of the pipeline's verify stage."""


def read(run):
    return run.stage_per_kread("verify")
