"""torch.cuda.max_memory_allocated() of the whole run, set-up included,
in GiB: every device buffer of the port is the caching allocator's."""


def read(run):
    return run.memory_peak_bytes / float(1 << 30)
