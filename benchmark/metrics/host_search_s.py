"""The stage split's `search=` seconds of the window's jobs, per 1000
reads aligned, in cells whose seed search runs on the host
(search_host.py over native/csrc/search.cpp): that stage's host wall.
device_search_s.py reads the same log field; the two are kept apart
because the layers differ, and each lists only its own cells."""


def read(run):
    return run.stage_per_kread("search")
