# Copied from floxer_tpu/output.py; relative imports resolve to this package's copies.
"""Per-query SAM record construction (parity: output.cpp:49-108)."""

from __future__ import annotations

from .alphabet import ranks_to_chars
from .io.sam import (
    FLAG_REVERSE,
    FLAG_SECONDARY,
    FLAG_UNMAPPED,
    MAPQ_NOT_AVAILABLE,
    AlignmentOutput,
    SamRecord,
)
from .io.sequence_io import QueryRecord
from .ops.dp_reference import Orientation
from .utils.mathutils import saturate_to_int32_max
from .verify import QueryAlignments


def write_alignments_for_query(
    output: AlignmentOutput,
    query: QueryRecord,
    alignments: QueryAlignments,
    references,
) -> int:
    """Emit all records for one query; returns the number of alignments."""
    primary_written = False
    num_alignments = 0

    for reference_id, reference in enumerate(references):
        for alignment in alignments.per_reference[reference_id]:
            flag = (
                FLAG_REVERSE
                if alignment.orientation == Orientation.REVERSE_COMPLEMENT
                else 0
            )
            is_primary = (
                not primary_written
                and alignments.best_num_errors == alignment.num_errors
            )
            if is_primary:
                seq = ranks_to_chars(query.rank_sequence)
                qual = query.quality
                primary_written = True
            else:
                flag |= FLAG_SECONDARY
                seq = ""
                qual = ""
            output.write_record(
                SamRecord(
                    qname=query.id,
                    flag=flag,
                    rname=reference.id,
                    pos=saturate_to_int32_max(alignment.start_in_reference),
                    mapq=MAPQ_NOT_AVAILABLE,
                    cigar=alignment.cigar,
                    seq=seq,
                    qual=qual,
                    tags=[("NM", "i", alignment.num_errors)],
                )
            )
            num_alignments += 1

    if not primary_written:
        output.write_record(
            SamRecord(
                qname=query.id,
                flag=FLAG_UNMAPPED,
                rname="",
                pos=-1,
                mapq=MAPQ_NOT_AVAILABLE,
                cigar=[],
                seq=ranks_to_chars(query.rank_sequence),
                qual=query.quality,
                tags=[],
            )
        )

    return num_alignments


def format_elapsed_time(seconds: float) -> str:
    """Human-readable elapsed time for logs (parity: output.cpp:153-172 —
    '{:.7} seconds' below one minute, then MM:SS minutes / H:MM:SS hours)."""
    if seconds <= 60:
        return f"{seconds:.7g} seconds"
    all_in_seconds = int(seconds)
    secs = all_in_seconds % 60
    all_in_minutes = all_in_seconds // 60
    minutes = all_in_minutes % 60
    hours = (all_in_minutes // 60) % 24
    if hours > 0:
        return f"{hours}:{minutes:02}:{secs:02} hours"
    return f"{minutes:02}:{secs:02} minutes"


def format_large_number(number: int) -> str:
    """Thousands separators for logs (parity: output.cpp:174-193)."""
    return f"{number:,}"
