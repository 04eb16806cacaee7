"""The stage split's `search=` seconds of the window's jobs, per 1000
reads aligned, in cells with --device-search (search_device.py,
search_queue.py, search_select_device.py over index/device_index.py):
that stage's host wall, the K10 and K12 launches and the host stages
around them. host_search_s.py reads the same log field; the two are kept
apart because the layers differ, and each lists only its own cells."""


def read(run):
    return run.stage_per_kread("search")
