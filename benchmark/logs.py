"""Parsers of the program's end-of-job log lines.

`finished aligning successfully in X seconds` is the align phase's wall of
one job. `stage split: search=..s verify=..s finalize=..s ...
launches=K1:n,...` gives the host walls of the pipeline's stages, which
overlap, and the CUDA launches of the job.
"""

from __future__ import annotations

import re

ALIGN_SECONDS = re.compile(r"finished aligning successfully in ([0-9.]+) seconds")
STAGE_SPLIT = re.compile(
    r"stage split: search=([0-9.]+)s verify=([0-9.]+)s finalize=([0-9.]+)s"
    r".*?launches=(\S*)"
)


def align_seconds(lines) -> float | None:
    for line in lines:
        match = ALIGN_SECONDS.search(line)
        if match:
            return float(match.group(1))
    return None


def stage_split(lines) -> dict | None:
    """{"search", "verify", "finalize": seconds, "launches": {kernel: n}}"""
    for line in lines:
        match = STAGE_SPLIT.search(line)
        if match:
            launches = {}
            for item in filter(None, match.group(4).split(",")):
                kernel, _, count = item.partition(":")
                launches[kernel] = int(count)
            return {
                "search": float(match.group(1)),
                "verify": float(match.group(2)),
                "finalize": float(match.group(3)),
                "launches": launches,
            }
    return None
