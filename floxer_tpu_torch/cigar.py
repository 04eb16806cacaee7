# Copied from floxer_tpu/cigar.py; relative imports resolve to this package's copies.
"""Run-length CIGAR container.

The reference materializes CIGARs as op vectors via seqan3's
cigar_from_alignment (src/lib/alignment.cpp:147-180, extended ops =/X/I/D).
Here the native traceback emits the runs (counts + op chars) and the
preformatted SAM string in C++ (native/traceback.cpp
floxer_banded_traceback_rle); this class carries those arrays and only
materializes Python tuples when a consumer genuinely iterates — a 20 kb
read has ~2k runs, and building/formatting them per record in Python was a
measured hotspot of the output stage.

Behaves like the list[(count, op)] the pure-Python paths produce, so both
representations flow through QueryAlignment.cigar interchangeably.
"""

from __future__ import annotations

import numpy as np


class Cigar:
    __slots__ = ("counts", "op_chars", "_string", "_tuples")

    def __init__(
        self,
        counts: np.ndarray,
        op_chars: np.ndarray,
        string: str | None = None,
    ):
        self.counts = counts  # int64 [runs]
        self.op_chars = op_chars  # uint8 ASCII [runs]
        self._string = string
        self._tuples: list[tuple[int, str]] | None = None

    def string(self) -> str:
        s = self._string
        if s is None:
            s = self._string = "".join(
                f"{n}{op}" for n, op in self.tuples()
            )
        return s

    def tuples(self) -> list[tuple[int, str]]:
        t = self._tuples
        if t is None:
            t = self._tuples = list(
                zip(
                    self.counts.tolist(),
                    self.op_chars.tobytes().decode("ascii"),
                )
            )
        return t

    def consumed_reference_bases(self) -> int:
        """Sum of counts of ops that consume reference (M/D/N/=/X)."""
        consuming = np.frombuffer(b"MDN=X", dtype=np.uint8)
        return int(self.counts[np.isin(self.op_chars, consuming)].sum())

    def __len__(self) -> int:
        return int(self.counts.shape[0])

    def __bool__(self) -> bool:
        return self.counts.shape[0] > 0

    def __iter__(self):
        return iter(self.tuples())

    def __getitem__(self, i):
        return self.tuples()[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, Cigar):
            return self.tuples() == other.tuples()
        if isinstance(other, (list, tuple)):
            return self.tuples() == list(other)
        return NotImplemented

    def __repr__(self) -> str:  # pragma: no cover
        return f"Cigar({self.string()!r})"
