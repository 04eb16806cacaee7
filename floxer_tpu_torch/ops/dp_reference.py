# Copied from floxer_tpu/ops/dp_reference.py; relative imports resolve to this package's copies.
"""Numpy reference implementation of semi-global edit-distance alignment.

This is the correctness oracle for the Pallas kernels and the host fallback
path. Semantics mirror the reference's seqan3 wrapper (src/lib/alignment.cpp):

  - global alignment with free end gaps on the REFERENCE only: the query must
    align end to end, the reference may overhang on both sides for free
    (alignment.cpp:88-96). DP: dp[0][j] = 0, dp[i][0] = i.
  - edit scheme (unit costs), alignment rejected when distance > k
    (min_score cutoff, alignment.cpp:96).
  - the optimum is the RIGHTMOST minimal cell of the last row among end
    columns 0..n-1 — the final column (ending flush with the window end) is
    not considered, which the reference's span math accounts for with its
    +1 margin (base_length = span + 2*errors + 1, verification.cpp:164).
  - traceback preference on cost ties: vertical (insertion, consumes query),
    then diagonal (match/mismatch), then horizontal (deletion, consumes
    reference).
  These two rules are pinned jointly by alignment_test.cpp ("4=1X2=",
  begin 2), verification_test.cpp ("10=1I9=1D10=", begin 50) and the e2e
  expectations of floxer_whole_program_via_cli_test.cpp:44-100 (query3/4
  insertion-form CIGARs with their exact position ranges) — no other
  (end-choice, trace-priority) combination satisfies all of them.
  - three output modes (alignment.hpp:53-55): existence only; score + begin
    position via aligning the REVERSED sequences and deriving begin from the
    reversed end position (alignment.cpp:115-145); full CIGAR with extended
    ops = / X / I / D (alignment.cpp:147-180).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np


class AlignmentMode(enum.Enum):
    ONLY_VERIFY_EXISTENCE = "only_verify_existence"
    WITHOUT_CIGAR = "verify_and_return_alignment_without_cigar"
    WITH_CIGAR = "verify_and_return_alignment_with_cigar"


class Orientation(enum.Enum):
    FORWARD = "forward"
    REVERSE_COMPLEMENT = "reverse_complement"


@dataclass
class QueryAlignment:
    """One accepted alignment of a query to a reference (alignment.hpp:18-23)."""

    start_in_reference: int
    num_errors: int
    orientation: Orientation
    cigar: list[tuple[int, str]] = field(default_factory=list)

    def cigar_string(self) -> str:
        if hasattr(self.cigar, "string"):  # run-length Cigar container
            return self.cigar.string() or "*"
        return "".join(f"{count}{op}" for count, op in self.cigar) or "*"


@dataclass
class AlignmentResult:
    exists: bool
    alignment: QueryAlignment | None = None


def semi_global_dp_matrix(reference: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Full (m+1, n+1) DP matrix; dp[i][j] = min edit distance between
    query[:i] and any suffix of reference[:j]. Row-vectorized via the
    prefix-min scan trick for the horizontal dependency."""
    reference = np.asarray(reference, dtype=np.uint8)
    query = np.asarray(query, dtype=np.uint8)
    n = reference.shape[0]
    m = query.shape[0]

    dp = np.empty((m + 1, n + 1), dtype=np.int32)
    dp[0, :] = 0
    col_idx = np.arange(n + 1, dtype=np.int32)
    for i in range(1, m + 1):
        sub_cost = (reference != query[i - 1]).astype(np.int32)
        # candidates without the horizontal dependency
        tmp = np.empty(n + 1, dtype=np.int32)
        tmp[0] = i  # dp[i][0] = i (query prefix vs empty reference suffix)
        tmp[1:] = np.minimum(dp[i - 1, :-1] + sub_cost, dp[i - 1, 1:] + 1)
        # dp[i][j] = min_{l<=j} tmp[l] + (j - l): prefix-min scan
        dp[i] = np.minimum.accumulate(tmp - col_idx) + col_idx
    return dp


def _rightmost_argmin(last_row: np.ndarray) -> int:
    """Rightmost minimal end column among 0..n-1 (the flush-with-window-end
    column n is excluded, see module docstring)."""
    eligible = last_row[:-1] if last_row.shape[0] > 1 else last_row
    return int(eligible.shape[0] - 1 - np.argmin(eligible[::-1]))


def _traceback(
    dp: np.ndarray, reference: np.ndarray, query: np.ndarray, end_col: int
) -> tuple[int, list[tuple[int, str]]]:
    """Walk back from (m, end_col) to row 0; returns (begin_col, cigar).

    Tie preference: vertical (I), diagonal, horizontal (D)."""
    i = dp.shape[0] - 1
    j = end_col
    ops: list[str] = []
    while i > 0:
        here = dp[i, j]
        if here == dp[i - 1, j] + 1:
            ops.append("I")
            i -= 1
        elif j > 0 and here == dp[i - 1, j - 1] + (
            1 if reference[j - 1] != query[i - 1] else 0
        ):
            ops.append("=" if reference[j - 1] == query[i - 1] else "X")
            i -= 1
            j -= 1
        else:
            assert j > 0 and here == dp[i, j - 1] + 1
            ops.append("D")
            j -= 1
    ops.reverse()

    cigar: list[tuple[int, str]] = []
    for op in ops:
        if cigar and cigar[-1][1] == op:
            cigar[-1] = (cigar[-1][0] + 1, op)
        else:
            cigar.append((1, op))
    return j, cigar


def banded_cigar_traceback(
    reference: np.ndarray,
    query: np.ndarray,
    end_col: int,
    distance: int,
) -> tuple[int, list[tuple[int, str]]]:
    """Reconstruct (begin, cigar) from a device-reported (end_col, distance).

    Recomputes only the band |j - i - (end_col - m)| <= distance around the
    optimal path's diagonal — every optimal path into (m, end_col) stays
    inside it, and band-edge inflation cannot flip the tie-preference (an
    inflated neighbor can never satisfy the traceback equality, since
    adjacent true DP values differ by at most 1). Produces byte-identical
    CIGARs to the full-matrix _traceback. Dispatches to the native C++
    implementation (floxer_tpu/native/traceback.cpp) when available.
    """
    from ..native import native_banded_traceback

    native = native_banded_traceback(reference, query, end_col, distance)
    if native is not None:
        return native

    reference = np.asarray(reference, dtype=np.uint8)
    query = np.asarray(query, dtype=np.uint8)
    m = query.shape[0]
    center = end_col - m  # the path's anchor diagonal
    half = max(distance, 0)
    width = 2 * half + 1
    big = np.int32(1 << 20)

    # dp_band[i, d] = dp[i, i + center - half + d]
    dp_band = np.full((m + 1, width), big, dtype=np.int32)
    cols0 = center - half + np.arange(width)
    valid0 = (cols0 >= 0) & (cols0 <= reference.shape[0])
    dp_band[0, valid0] = 0  # free leading reference gaps
    for i in range(1, m + 1):
        cols = i + center - half + np.arange(width)
        valid = (cols >= 0) & (cols <= reference.shape[0])
        # diagonal predecessor: dp[i-1][j-1] = band[i-1, d]
        ref_chars = reference[np.clip(cols - 1, 0, reference.shape[0] - 1)]
        sub = (ref_chars != query[i - 1]).astype(np.int32)
        diag = np.where(cols >= 1, dp_band[i - 1] + sub, big)
        # vertical predecessor: dp[i-1][j] = band[i-1, d+1]
        up = np.concatenate([dp_band[i - 1, 1:], [big]]) + 1
        best = np.minimum(diag, up)
        # horizontal: dp[i][j-1] = band[i, d-1] (prefix scan within the row)
        row = np.minimum.accumulate(
            np.where(valid, best, big) - np.arange(width)
        ) + np.arange(width)
        dp_band[i] = np.where(valid, np.minimum(best, row), big)

    def cell(i, j):
        d = j - (i + center - half)
        if 0 <= d < width:
            return int(dp_band[i, d])
        return int(big)

    i, j = m, end_col
    assert cell(i, j) == distance, (cell(i, j), distance)
    ops: list[str] = []
    while i > 0:
        here = cell(i, j)
        if here == cell(i - 1, j) + 1:
            ops.append("I")
            i -= 1
        elif j > 0 and here == cell(i - 1, j - 1) + (
            1 if reference[j - 1] != query[i - 1] else 0
        ):
            ops.append("=" if reference[j - 1] == query[i - 1] else "X")
            i -= 1
            j -= 1
        else:
            assert j > 0 and here == cell(i, j - 1) + 1
            ops.append("D")
            j -= 1
    ops.reverse()
    cigar: list[tuple[int, str]] = []
    for op in ops:
        if cigar and cigar[-1][1] == op:
            cigar[-1] = (cigar[-1][0] + 1, op)
        else:
            cigar.append((1, op))
    return j, cigar


# alignment.cpp:81: the reference warns when one DP matrix is estimated
# above `very_large_memory_usage` = 10 GB. The banded kernels bound their
# memory by construction, so only this full-matrix oracle path (reached by
# direct-full verification of a huge span) can grow unboundedly — mirror
# the warning (alignment.cpp:149-154) before allocating.
VERY_LARGE_DP_MATRIX_BYTES = 10 * 1024**3


def _warn_if_very_large_dp(num_reference: int, num_query: int) -> None:
    # the reference estimates matrix bytes as cells x trace-cell size; the
    # numpy matrix here stores int32 cells on (m+1) x (n+1)
    estimated = (num_reference + 1) * (num_query + 1) * 4
    if estimated > VERY_LARGE_DP_MATRIX_BYTES:
        import logging

        logging.getLogger("floxer-tpu").warning(
            "an alignment used a very large DP matrix: estimated %.1f GiB "
            "(reference span %d x query %d). This will likely result in "
            "high running times.",
            estimated / 1024**3,
            num_reference,
            num_query,
        )


def align_semi_global(
    reference: np.ndarray,
    query: np.ndarray,
    num_allowed_errors: int,
    orientation: Orientation = Orientation.FORWARD,
    mode: AlignmentMode = AlignmentMode.ONLY_VERIFY_EXISTENCE,
    reference_span_offset: int = 0,
) -> AlignmentResult:
    """Drop-in equivalent of alignment::align (alignment.cpp:83-181)."""
    reference = np.asarray(reference, dtype=np.uint8)
    query = np.asarray(query, dtype=np.uint8)
    _warn_if_very_large_dp(len(reference), len(query))

    if mode == AlignmentMode.WITHOUT_CIGAR:
        # reversed-sequence trick (alignment.cpp:115-145): begin position from
        # the end position of the reversed alignment, no traceback needed.
        dp = semi_global_dp_matrix(reference[::-1], query[::-1])
        last = dp[-1]
        end_col_rev = _rightmost_argmin(last)
        distance = int(last[end_col_rev])
        if distance > num_allowed_errors:
            return AlignmentResult(exists=False)
        begin = reference.shape[0] - end_col_rev
        return AlignmentResult(
            exists=True,
            alignment=QueryAlignment(
                start_in_reference=reference_span_offset + begin,
                num_errors=distance,
                orientation=orientation,
                cigar=[],
            ),
        )

    dp = semi_global_dp_matrix(reference, query)
    last = dp[-1]
    end_col = _rightmost_argmin(last)
    distance = int(last[end_col])
    if distance > num_allowed_errors:
        return AlignmentResult(exists=False)

    if mode == AlignmentMode.ONLY_VERIFY_EXISTENCE:
        return AlignmentResult(exists=True)

    begin, cigar = _traceback(dp, reference, query, end_col)
    return AlignmentResult(
        exists=True,
        alignment=QueryAlignment(
            start_in_reference=reference_span_offset + begin,
            num_errors=distance,
            orientation=orientation,
            cigar=cigar,
        ),
    )
