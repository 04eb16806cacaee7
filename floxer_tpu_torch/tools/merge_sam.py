# Copied from floxer_tpu/tools/merge_sam.py; relative imports resolve to this package's copies.
"""Merge strided per-host SAM shards into one canonical file.

Companion to --num-hosts/--host-id query sharding (parallel/multihost.py):
shard h holds the queries with internal_id % H == h in order, so the merge
is a round-robin interleave of per-query record groups, restoring global
query order.
"""

from __future__ import annotations

import argparse
import sys

from ..parallel.multihost import merge_sam_shards


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="merge_sam",
        description="Merge strided per-host SAM shards into one file "
        "ordered by query.",
    )
    parser.add_argument(
        "-i", "--inputs", nargs="+", required=True,
        help="Shard SAM files in host-id order.",
    )
    parser.add_argument("-o", "--output", required=True)
    args = parser.parse_args(argv)

    total = merge_sam_shards(args.inputs, args.output)
    print(f"merged {total} queries from {len(args.inputs)} shards", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
