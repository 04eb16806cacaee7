# Copied from floxer_tpu/intervals.py; relative imports resolve to this package's copies.
"""Half-open intervals and the verified-interval cache.

Reference parity: include/intervals.hpp + src/lib/intervals.cpp, pinned by
test/intervals_test.cpp. The cache deliberately does NOT merge touching
intervals (a past bug documented in intervals_test.cpp:128-132): containment
queries must only succeed against a single stored interval that equals or
contains the target.

Host-side structure: instead of the reference's red-black interval tree, we
keep starts sorted (bisect) alongside a lazily rebuilt prefix-max of ends,
which answers "does any stored interval with start <= t.start have
end >= t.end?" in O(log n) with O(n) amortized inserts — the exact same
containment predicate, batch-friendly for the device pipeline where whole
span batches are deduplicated before kernel launch.
"""

from __future__ import annotations

import enum
from bisect import bisect_right
from dataclasses import dataclass


class IntervalRelationship(enum.Enum):
    COMPLETELY_ABOVE = "completely_above"
    COMPLETELY_BELOW = "completely_below"
    CONTAINS = "contains"
    EQUAL = "equal"
    INSIDE = "inside"
    OVERLAPPING_OR_TOUCHING_ABOVE = "overlapping_or_touching_above"
    OVERLAPPING_OR_TOUCHING_BELOW = "overlapping_or_touching_below"


@dataclass(frozen=True, order=True)
class HalfOpenInterval:
    """[start, end), must be non-empty (intervals.hpp:24-40)."""

    start: int
    end: int

    def size(self) -> int:
        return self.end - self.start

    def relationship_with(self, other: "HalfOpenInterval") -> IntervalRelationship:
        """7-way classification (intervals.cpp:26-46); note the closed-interval
        comparisons: touching intervals are 'overlapping_or_touching'."""
        assert self.start < self.end and other.start < other.end
        if self.start > other.end:
            return IntervalRelationship.COMPLETELY_ABOVE
        if self.end < other.start:
            return IntervalRelationship.COMPLETELY_BELOW
        if self.start == other.start and self.end == other.end:
            return IntervalRelationship.EQUAL
        if self.start <= other.start and self.end >= other.end:
            return IntervalRelationship.CONTAINS
        if self.start >= other.start and self.end <= other.end:
            return IntervalRelationship.INSIDE
        if self.start > other.start and self.start <= other.end:
            return IntervalRelationship.OVERLAPPING_OR_TOUCHING_ABOVE
        assert self.end < other.end and self.end >= other.start
        return IntervalRelationship.OVERLAPPING_OR_TOUCHING_BELOW

    def trim_from_both_sides(self, amount: int) -> "HalfOpenInterval":
        """Shrink from both ends, keeping at least one element
        (intervals.cpp:48-58, pinned by intervals_test.cpp:65-85)."""
        assert self.start < self.end
        new_end = max(self.start + 1, 0 if amount > self.end else self.end - amount)
        new_start = min(new_end - 1, self.start + amount)
        return HalfOpenInterval(new_start, new_end)


class VerifiedIntervals:
    """Cache of already-verified root spans for one (reference, orientation).

    contains(t) is true iff some single stored interval s satisfies
    s.start <= t.start and s.end >= t.end (equal or contains,
    intervals.cpp:92-127). insert skips covered intervals (intervals.cpp:84-90).
    Default activity is ON (intervals.hpp:70); the CLI flag wires OFF.
    """

    def __init__(self, active: bool = True):
        self._active = active
        self._starts: list[int] = []  # sorted
        self._ends: list[int] = []  # parallel to _starts
        self._prefix_max_end: list[int] = []
        self._dirty = False

    def configure(self, active: bool) -> None:
        self._active = active

    def _refresh(self) -> None:
        if self._dirty:
            running = 0
            self._prefix_max_end = []
            for e in self._ends:
                running = e if e > running else running
                self._prefix_max_end.append(running)
            self._dirty = False

    def contains(self, target: HalfOpenInterval) -> bool:
        if not self._active:
            return False
        self._refresh()
        # candidates: stored intervals with start <= target.start
        idx = bisect_right(self._starts, target.start)
        if idx == 0:
            return False
        return self._prefix_max_end[idx - 1] >= target.end

    def insert(self, new_interval: HalfOpenInterval) -> None:
        if not self._active or self.contains(new_interval):
            return
        pos = bisect_right(self._starts, new_interval.start)
        self._starts.insert(pos, new_interval.start)
        self._ends.insert(pos, new_interval.end)
        self._dirty = True

    def __len__(self) -> int:
        return len(self._starts)


def create_verified_intervals_per_reference(
    num_references: int, active: bool
) -> list[VerifiedIntervals]:
    """One cache per reference (intervals.cpp:129-141); the batch pipeline
    replaces the reference's shared_mutex with per-batch sequential access."""
    return [VerifiedIntervals(active) for _ in range(num_references)]
