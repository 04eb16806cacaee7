"""The benchmark of floxer_tpu_torch: its warm server on simulated long
reads, measured from a client in the same process (see README.md)."""
