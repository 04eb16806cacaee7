"""Percent of the verification's useful band cells that the router sent
to the card: 100 x verify.cells_device / (verify.cells_device +
verify.cells_host), the program's counters over the window's traced
jobs, counted where the router decides (the fused wave and the bucketed
batcher)."""

from benchmark.spans import counter_sum


def read(run):
    device = counter_sum(run, "verify.cells_device")
    host = counter_sum(run, "verify.cells_host")
    if device is None or not device + host:
        return None
    return 100.0 * device / (device + host)
