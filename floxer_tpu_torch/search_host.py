# Copied from floxer_tpu/search_host.py; relative imports resolve to this package's copies.
"""Approximate seed search + anchor selection (host reference path).

Parity target: src/lib/search.cpp. Per seed, the FM-index is searched with an
expanded search scheme, collecting ANCHOR GROUPS (cursor interval + error
count, search.hpp:127-130). Group post-processing mirrors the reference
exactly:

  - hard cap: if the raw anchor total exceeds max_num_anchors_hard, the seed
    is fully excluded (search.cpp:190-202) unless strategy first_reported
  - group ordering count_first / errors_first / none (search.cpp:204-229)
  - choice strategies round_robin / full_groups / first_reported with the
    soft cap (search.cpp:239-302); every chosen cursor row is located
  - erase_useless_anchors dominance sweep (search.cpp:352-389)

The edit-distance scheme traversal is a DFS with the usual canonicalization
(substitutions only with a differing symbol, no insertion<->deletion
adjacency) and final dedup of identical (interval, errors) groups. The device
path (search_device.py) re-implements this traversal as a masked frontier
over cursor batches; this module is its oracle.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from .index.fmindex import Cursor, FmIndex
from .pex import Seed
from .schemes import ExpandedSearch, expand_scheme

# matches the reference's SIZE_MAX marker (search.hpp:132): a marked anchor
# can never dominate anything
ERASE_MARKER = 2**62

# symbols usable for substitutions/insertions: real residues only (1..5);
# rank 0 is the sequence separator and can never be part of a match
_EDIT_SYMBOLS = (1, 2, 3, 4, 5)


class AnchorGroupOrder(enum.Enum):
    COUNT_FIRST = "count_first"
    ERRORS_FIRST = "errors_first"
    NONE = "none"


class AnchorChoiceStrategy(enum.Enum):
    ROUND_ROBIN = "round_robin"
    FULL_GROUPS = "full_groups"
    FIRST_REPORTED = "first_reported"


@dataclass
class SearchConfig:
    max_num_anchors_hard: int = 500
    max_num_anchors_soft: int = 50
    anchor_group_order: AnchorGroupOrder = AnchorGroupOrder.COUNT_FIRST
    anchor_choice_strategy: AnchorChoiceStrategy = AnchorChoiceStrategy.ROUND_ROBIN
    erase_useless_anchors: bool = True


@dataclass
class Anchor:
    """A located candidate position (search.hpp:27-38)."""

    pex_leaf_index: int
    reference_id: int
    reference_position: int
    num_errors: int

    def is_better_than(self, other: "Anchor") -> bool:
        position_difference = abs(self.reference_position - other.reference_position)
        return (
            self.num_errors <= other.num_errors
            and position_difference <= other.num_errors - self.num_errors
        )


@dataclass
class AnchorGroup:
    cursor: Cursor
    num_errors: int


@dataclass
class AnchorsOfSeed:
    num_kept_useful_anchors: int = 0
    num_kept_raw_anchors: int = 0
    num_excluded_raw_anchors_by_soft_cap: int = 0
    anchors_by_reference: list[list[Anchor]] = field(default_factory=list)
    # array form (native select path): int64 [k, 3] rows of (reference_id,
    # position, num_errors) in final iteration order — reference ascending,
    # so the flat row order equals the anchors_by_reference iteration order.
    # When set, anchors_by_reference stays empty and Anchor objects are only
    # materialized on demand (iter_anchors).
    rows: np.ndarray | None = None
    leaf_index: int = -1


@dataclass
class SearchResult:
    anchors_by_seed: list[AnchorsOfSeed] = field(default_factory=list)
    num_fully_excluded_seeds: int = 0

    def iter_anchors(self):
        """Flattened (seed, reference, anchor) order (search.cpp:78-109)."""
        for anchors_of_seed in self.anchors_by_seed:
            if anchors_of_seed.rows is not None:
                leaf_index = anchors_of_seed.leaf_index
                for ref, pos, err in anchors_of_seed.rows.tolist():
                    yield Anchor(
                        pex_leaf_index=leaf_index,
                        reference_id=ref,
                        reference_position=pos,
                        num_errors=err,
                    )
                continue
            for anchors in anchors_of_seed.anchors_by_reference:
                yield from anchors

    def flat_arrays(self):
        """(leaf_index[N] i64, reference_id[N] i64, position[N] i64) over
        all anchors in iter_anchors order, without materializing Anchor
        objects for seeds that carry array rows."""
        leaves: list[np.ndarray] = []
        rows: list[np.ndarray] = []
        for anchors_of_seed in self.anchors_by_seed:
            if anchors_of_seed.rows is not None:
                k = anchors_of_seed.rows.shape[0]
                if k:
                    leaves.append(
                        np.full(k, anchors_of_seed.leaf_index, dtype=np.int64)
                    )
                    rows.append(anchors_of_seed.rows)
                continue
            for anchors in anchors_of_seed.anchors_by_reference:
                if anchors:
                    leaves.append(
                        np.fromiter(
                            (a.pex_leaf_index for a in anchors),
                            count=len(anchors),
                            dtype=np.int64,
                        )
                    )
                    rows.append(
                        np.array(
                            [
                                (a.reference_id, a.reference_position, 0)
                                for a in anchors
                            ],
                            dtype=np.int64,
                        ).reshape(len(anchors), 3)
                    )
        if not rows:
            empty = np.zeros(0, dtype=np.int64)
            return empty, empty, empty
        leaf = np.concatenate(leaves)
        merged = np.concatenate(rows)
        return leaf, merged[:, 0], merged[:, 1]


class SearchResultSoA:
    """Array-form search result produced by the chunk-batched native path:
    per-seed counters and a seed-major flat anchor table instead of one
    AnchorsOfSeed object per seed (a 250-read chunk has ~250k seeds — the
    object forms cost more than the FM search itself). Duck-type compatible
    with SearchResult for every consumer on the batched engine; the legacy
    object view is materialized lazily via the anchors_by_seed property."""

    __slots__ = (
        "leaf",  # int64 [n_seeds] pex leaf index per seed
        "kept_useful",  # int64 [n_seeds]
        "kept_raw",  # int64 [n_seeds]
        "excluded_soft",  # int64 [n_seeds]
        "seed_starts",  # int64 [n_seeds + 1] offsets into rows_flat
        "rows_flat",  # int64 [K, 3] (reference_id, position, num_errors)
        "num_fully_excluded_seeds",
    )

    def __init__(
        self, leaf, kept_useful, kept_raw, excluded_soft, seed_starts,
        rows_flat,
    ):
        self.leaf = leaf
        self.kept_useful = kept_useful
        self.kept_raw = kept_raw
        self.excluded_soft = excluded_soft
        self.seed_starts = seed_starts
        self.rows_flat = rows_flat
        self.num_fully_excluded_seeds = 0

    @property
    def anchors_by_seed(self) -> list[AnchorsOfSeed]:
        starts = self.seed_starts
        return [
            AnchorsOfSeed(
                num_kept_useful_anchors=int(self.kept_useful[i]),
                num_kept_raw_anchors=int(self.kept_raw[i]),
                num_excluded_raw_anchors_by_soft_cap=int(self.excluded_soft[i]),
                rows=self.rows_flat[starts[i] : starts[i + 1]],
                leaf_index=int(self.leaf[i]),
            )
            for i in range(self.leaf.shape[0])
        ]

    def iter_anchors(self):
        """Flattened (seed, reference, anchor) order (search.cpp:78-109)."""
        counts = np.diff(self.seed_starts)
        leaf_rep = np.repeat(self.leaf, counts)
        for lf, (ref, pos, err) in zip(
            leaf_rep.tolist(), self.rows_flat.tolist()
        ):
            yield Anchor(
                pex_leaf_index=lf,
                reference_id=ref,
                reference_position=pos,
                num_errors=err,
            )

    def flat_arrays(self):
        """(leaf_index[N], reference_id[N], position[N]) in iteration order."""
        counts = np.diff(self.seed_starts)
        leaf_rep = np.repeat(self.leaf, counts)
        return leaf_rep, self.rows_flat[:, 0], self.rows_flat[:, 1]


class _SearchAborted(Exception):
    pass


def _run_scheme_search(
    index: FmIndex,
    pattern: np.ndarray,
    search: ExpandedSearch,
    report,
) -> None:
    """DFS one expanded search over the bidirectional index.

    report(cursor, errors) is called for every completed leaf; raising
    _SearchAborted stops the whole traversal (search_n's cap semantics).
    """

    def process_part(cursor: Cursor, part_idx: int, errors: int, last_op: str) -> None:
        if part_idx == len(search.pi):
            report(cursor, errors)
            return
        start, end = search.part_spans[part_idx]
        direction = search.directions[part_idx]
        if direction > 0:
            first_char = start
        else:
            first_char = end - 1
        step(cursor, part_idx, first_char, errors, last_op)

    def step(
        cursor: Cursor, part_idx: int, char_pos: int, errors: int, last_op: str
    ) -> None:
        start, end = search.part_spans[part_idx]
        direction = search.directions[part_idx]
        done = char_pos >= end if direction > 0 else char_pos < start

        if done:
            # part boundary: enforce the cumulative lower bound
            if errors < search.lower[part_idx]:
                return
            process_part(cursor, part_idx + 1, errors, last_op)
            return

        upper = search.upper[part_idx]
        pattern_symbol = int(pattern[char_pos])
        extend = index.extend_right_all if direction > 0 else index.extend_left_all
        next_pos = char_pos + direction

        children = extend(cursor)

        # match
        child = children[pattern_symbol]
        if not child.empty:
            step(child, part_idx, next_pos, errors, "M")

        if errors < upper:
            for symbol in _EDIT_SYMBOLS:
                if symbol == pattern_symbol:
                    continue
                child = children[symbol]
                if not child.empty:
                    # substitution
                    step(child, part_idx, next_pos, errors + 1, "M")
            # insertion (text symbol consumed, pattern position unchanged)
            if last_op != "D":
                for symbol in _EDIT_SYMBOLS:
                    child = children[symbol]
                    if not child.empty:
                        step(child, part_idx, char_pos, errors + 1, "I")
            # deletion (pattern symbol skipped, no extension)
            if last_op != "I":
                step(cursor, part_idx, next_pos, errors + 1, "D")

    process_part(index.root_cursor(), 0, 0, "M")


def search_seed_groups(
    index: FmIndex,
    pattern: np.ndarray,
    max_errors: int,
    max_total_count: int,
    allow_native: bool = True,
) -> tuple[list[AnchorGroup], int, bool]:
    """All anchor groups for one seed, deduplicated by (interval, errors)
    keeping the first-reported order. Returns (groups, total_raw_anchors,
    aborted) where aborted means the count cap stopped the search early
    (parity: search_ng21::search_n, search.cpp:173-188).

    Runs the native C++ DFS (floxer_tpu/native/search.cpp) when available —
    byte-identical group order to the Python DFS below, which remains the
    oracle (tests/test_native_search.py asserts equality)."""
    expanded = expand_scheme(max_errors, len(pattern))

    if allow_native:
        from .native import native_search_seed

        native = native_search_seed(index, pattern, expanded, max_total_count)
        if native is not None:
            rows, total, aborted = native
            groups = [
                AnchorGroup(
                    Cursor(int(lb), int(lb_rev), int(length)), int(errors)
                )
                for lb, lb_rev, length, errors in rows
            ]
            return groups, total, aborted

    groups: list[AnchorGroup] = []
    seen: dict[tuple[int, int, int], int] = {}
    total = 0
    aborted = False

    def report(cursor: Cursor, errors: int) -> None:
        nonlocal total
        key = (cursor.lb, cursor.length, errors)
        if key in seen:
            return
        seen[key] = len(groups)
        groups.append(AnchorGroup(cursor, errors))
        total += cursor.length
        if total >= max_total_count:
            raise _SearchAborted()

    try:
        for search in expanded:
            _run_scheme_search(index, pattern, search, report)
    except _SearchAborted:
        aborted = True
    return groups, total, aborted


@dataclass
class ChunkSeedArrays:
    """Flattened per-seed arrays over a whole chunk of (seeds, query) jobs:
    the shared front half of every chunk-level search path (host native and
    device frontier). Seeds are concatenated in job order; patterns are
    byte offsets into one concatenated query buffer."""

    bases: np.ndarray  # int64 [n_jobs + 1] query-buffer offsets per job
    buffer: np.ndarray  # uint8 concatenated query rank sequences
    job_seed_base: np.ndarray  # int64 [n_jobs + 1] global seed id bases
    length_g: np.ndarray  # int64 [total_seeds]
    errors_g: np.ndarray  # int64 [total_seeds]
    qpos_g: np.ndarray  # int64 [total_seeds] position within the query
    leaf_g: np.ndarray  # int64 [total_seeds] pex leaf index
    job_g: np.ndarray  # int64 [total_seeds] owning job
    offsets_g: np.ndarray  # int64 [total_seeds] pattern offset into buffer

    @property
    def total_seeds(self) -> int:
        return int(self.job_seed_base[-1])


def assemble_chunk_seed_arrays(
    jobs: list[tuple[list[Seed], np.ndarray]],
) -> ChunkSeedArrays:
    """Vectorized assembly of ChunkSeedArrays (seed lists are memoized per
    PEX tree, so their array forms come from pex.seed_stat_arrays' cache)."""
    from .pex import seed_stat_arrays

    n_jobs = len(jobs)
    bases = np.zeros(n_jobs + 1, dtype=np.int64)
    np.cumsum([q.shape[0] for _, q in jobs], out=bases[1:])
    buffer = (
        np.concatenate([q for _, q in jobs])
        if jobs
        else np.zeros(0, dtype=np.uint8)
    )
    per_job = [seed_stat_arrays(seeds) for seeds, _ in jobs]
    job_seed_base = np.zeros(n_jobs + 1, dtype=np.int64)
    np.cumsum([a[0].shape[0] for a in per_job], out=job_seed_base[1:])
    length_g = (
        np.concatenate([a[0] for a in per_job])
        if per_job
        else np.zeros(0, dtype=np.int64)
    )
    errors_g = (
        np.concatenate([a[1] for a in per_job])
        if per_job
        else np.zeros(0, dtype=np.int64)
    )
    qpos_g = (
        np.concatenate([a[2] for a in per_job])
        if per_job
        else np.zeros(0, dtype=np.int64)
    )
    leaf_g = (
        np.concatenate([a[3] for a in per_job])
        if per_job
        else np.zeros(0, dtype=np.int64)
    )
    job_g = np.repeat(
        np.arange(n_jobs, dtype=np.int64), np.diff(job_seed_base)
    )
    offsets_g = bases[job_g] + qpos_g
    return ChunkSeedArrays(
        bases=bases,
        buffer=buffer,
        job_seed_base=job_seed_base,
        length_g=length_g,
        errors_g=errors_g,
        qpos_g=qpos_g,
        leaf_g=leaf_g,
        job_g=job_g,
        offsets_g=offsets_g,
    )


def build_soa_results(
    arrays: ChunkSeedArrays,
    nw_g: np.ndarray,
    kept_raw_g: np.ndarray,
    kept_useful_g: np.ndarray,
    excluded_soft_g: np.ndarray,
    rows_parts: list[np.ndarray],
    gid_parts: list[np.ndarray],
) -> list["SearchResultSoA"]:
    """Shared back half of the chunk-level search: order the flat anchor
    rows seed-major and slice per-job SearchResultSoA views."""
    total_seeds = arrays.total_seeds
    if rows_parts:
        rows_all = np.concatenate(rows_parts)
        gid_all = np.concatenate(gid_parts)
        order = np.argsort(gid_all, kind="stable")
        rows_flat = rows_all[order]
    else:
        rows_flat = np.zeros((0, 3), dtype=np.int64)
    seed_starts_g = np.zeros(total_seeds + 1, dtype=np.int64)
    np.cumsum(nw_g, out=seed_starts_g[1:])

    results: list[SearchResultSoA] = []
    job_seed_base = arrays.job_seed_base
    for j in range(len(job_seed_base) - 1):
        a, b = int(job_seed_base[j]), int(job_seed_base[j + 1])
        ra = int(seed_starts_g[a])
        results.append(
            SearchResultSoA(
                leaf=arrays.leaf_g[a:b],
                kept_useful=kept_useful_g[a:b],
                kept_raw=kept_raw_g[a:b],
                excluded_soft=excluded_soft_g[a:b],
                seed_starts=seed_starts_g[a : b + 1] - ra,
                rows_flat=rows_flat[ra : int(seed_starts_g[b])],
            )
        )
    return results


@dataclass
class Searcher:
    """Parity: search::searcher (search.hpp:104-112, search.cpp:143-324)."""

    index: FmIndex
    num_reference_sequences: int
    config: SearchConfig
    num_threads: int = 1

    def search_cap(self) -> int:
        """search_n's result cap (search.cpp:176-179)."""
        if self.config.anchor_choice_strategy == AnchorChoiceStrategy.FIRST_REPORTED:
            return self.config.max_num_anchors_soft
        return self.config.max_num_anchors_hard + 1

    def search_seeds_many(
        self, jobs: list[tuple[list[Seed], np.ndarray]]
    ) -> list[SearchResult]:
        """Chunk-level search: all jobs' seeds of one (length, errors)
        class go through a single native call with buffer-offset patterns
        (no per-pattern copies, one worker-thread spawn set per class
        instead of one per query). Per-job results are identical to
        search_seeds; falls back to the per-job path without the native
        library."""
        import os

        from .native import get_library, native_search_select_batch_offsets

        if os.environ.get("FLOXER_TPU_NO_NATIVE_SELECT") or (
            get_library() is None
        ):
            return [self.search_seeds(s, q) for s, q in jobs]

        config = self.config
        order_code = {
            AnchorGroupOrder.COUNT_FIRST: 0,
            AnchorGroupOrder.ERRORS_FIRST: 1,
            AnchorGroupOrder.NONE: 2,
        }[config.anchor_group_order]
        choice_code = {
            AnchorChoiceStrategy.ROUND_ROBIN: 0,
            AnchorChoiceStrategy.FULL_GROUPS: 1,
            AnchorChoiceStrategy.FIRST_REPORTED: 2,
        }[config.anchor_choice_strategy]

        # fully vectorized assembly: per-seed arrays are concatenated over
        # all jobs, classed by (length, errors), searched with ONE native
        # call per class, and scattered back into per-seed global counter
        # arrays. No per-seed Python objects are built — results are
        # SearchResultSoA slices of the global arrays.
        n_jobs = len(jobs)
        if n_jobs == 0:
            return []
        arrays = assemble_chunk_seed_arrays(jobs)
        total_seeds = arrays.total_seeds
        buffer = arrays.buffer
        length_g = arrays.length_g
        errors_g = arrays.errors_g
        qpos_g = arrays.qpos_g
        job_g = arrays.job_g
        job_seed_base = arrays.job_seed_base
        offsets_g = arrays.offsets_g

        nw_g = np.zeros(total_seeds, dtype=np.int64)
        kept_raw_g = np.zeros(total_seeds, dtype=np.int64)
        kept_useful_g = np.zeros(total_seeds, dtype=np.int64)
        excluded_soft_g = np.zeros(total_seeds, dtype=np.int64)
        rows_parts: list[np.ndarray] = []
        gid_parts: list[np.ndarray] = []
        redo_gids: list[int] = []

        class_key = length_g * 4096 + errors_g  # errors < 4096 (CLI bound)
        unique_keys, inverse = np.unique(class_key, return_inverse=True)
        for c, key in enumerate(unique_keys.tolist()):
            sel = np.flatnonzero(inverse == c)  # ascending == seed order
            length, errors = key // 4096, key % 4096
            expanded = expand_scheme(errors, length)
            out = native_search_select_batch_offsets(
                self.index,
                buffer,
                offsets_g[sel],
                expanded,
                self.search_cap(),
                config.max_num_anchors_hard,
                config.max_num_anchors_soft,
                order_code,
                choice_code,
                config.erase_useless_anchors,
                self.num_threads,
            )
            if out is None:
                return [self.search_seeds(s, q) for s, q in jobs]
            anchors_arr, counts = out
            status = counts[:, 0]
            nw = counts[:, 1]
            # status&2 = group-buffer overflow (redo in Python below);
            # status&4 = hard-cap excluded (all counters stay zero)
            special = (status & 6) != 0
            ok = ~special
            if special.any():
                redo_gids.extend(
                    sel[np.flatnonzero(status & 2)].tolist()
                )
                nw = np.where(ok, nw, 0)
            sub = sel[ok] if special.any() else sel
            nw_g[sub] = nw[ok] if special.any() else nw
            kept_raw_g[sub] = counts[ok, 2]
            kept_useful_g[sub] = counts[ok, 3]
            excluded_soft_g[sub] = counts[ok, 4] - counts[ok, 2]
            valid = (
                np.arange(anchors_arr.shape[1], dtype=np.int64)[None, :]
                < nw[:, None]
            )
            rows_parts.append(anchors_arr[valid])
            gid_parts.append(np.repeat(sel, nw))

        for gid in redo_gids:
            job_idx = int(job_g[gid])
            i = gid - int(job_seed_base[job_idx])
            seeds, query = jobs[job_idx]
            qpos = int(qpos_g[gid])
            length = int(length_g[gid])
            groups, total, _ = search_seed_groups(
                self.index,
                query[qpos : qpos + length],
                int(errors_g[gid]),
                self.search_cap(),
            )
            aos = self.process_seed_groups(seeds[i], groups, total)
            rows = np.array(
                [
                    (a.reference_id, a.reference_position, a.num_errors)
                    for anchors in aos.anchors_by_reference
                    for a in anchors
                ],
                dtype=np.int64,
            ).reshape(-1, 3)
            nw_g[gid] = rows.shape[0]
            kept_raw_g[gid] = aos.num_kept_raw_anchors
            kept_useful_g[gid] = aos.num_kept_useful_anchors
            excluded_soft_g[gid] = aos.num_excluded_raw_anchors_by_soft_cap
            rows_parts.append(rows)
            gid_parts.append(np.full(rows.shape[0], gid, dtype=np.int64))

        return build_soa_results(
            arrays,
            nw_g,
            kept_raw_g,
            kept_useful_g,
            excluded_soft_g,
            rows_parts,
            gid_parts,
        )

    def search_seeds(self, seeds: list[Seed], query: np.ndarray) -> SearchResult:
        # primary path: the whole per-seed pipeline (DFS, caps, ordering,
        # choice, locate, dominance sweep) in one native call per seed
        # class — the Python stages below are GIL-bound and dominate the
        # multi-threaded search otherwise
        native = self._search_seeds_native_select(seeds, query)
        if native is not None:
            return native

        result = SearchResult()
        result.anchors_by_seed = [None] * len(seeds)

        # batch uniform-length seed groups through the native runtime (one
        # ctypes call + optional C++ worker threads instead of per-seed
        # dispatch); the per-seed DFS is unchanged semantically
        group_results = self._search_all_groups(seeds, query)

        # phase 1: choice loops (pure host bookkeeping, no positions needed)
        chosen = [
            self.choose_anchor_rows(seed, *group_results[i])
            for i, seed in enumerate(seeds)
        ]
        # phase 2: ONE batched locate for every pick of every seed
        all_rows = [row for _, rows, _, _ in chosen for row in rows]
        reference_ids, positions = self.index.locate_batch(
            np.asarray(all_rows, dtype=np.int64), self.num_threads
        )
        # phase 3: per-seed anchor construction + dominance sweep
        offset = 0
        for i, seed in enumerate(seeds):
            excluded, rows, errors, num_kept_raw = chosen[i]
            if excluded:
                result.anchors_by_seed[i] = AnchorsOfSeed(
                    anchors_by_reference=[
                        [] for _ in range(self.num_reference_sequences)
                    ]
                )
                continue
            count = len(rows)
            result.anchors_by_seed[i] = self.finalize_anchors(
                seed,
                errors,
                reference_ids[offset : offset + count],
                positions[offset : offset + count],
                group_results[i][1],
                num_kept_raw,
            )
            offset += count
        return result

    def _search_seeds_native_select(
        self, seeds: list[Seed], query: np.ndarray
    ) -> SearchResult | None:
        """All seeds through floxer_search_select_batch (native DFS +
        anchor selection per search.cpp:143-324), one call per uniform
        (length, errors) class; None when the native library is missing
        (or FLOXER_TPU_NO_NATIVE_SELECT is set, for A/B runs). Output
        equality with the Python stages is asserted by
        tests/test_native_search.py and the pipeline fuzz suite."""
        import os

        if os.environ.get("FLOXER_TPU_NO_NATIVE_SELECT"):
            return None
        from .native import native_search_select_batch

        config = self.config
        order_code = {
            AnchorGroupOrder.COUNT_FIRST: 0,
            AnchorGroupOrder.ERRORS_FIRST: 1,
            AnchorGroupOrder.NONE: 2,
        }[config.anchor_group_order]
        choice_code = {
            AnchorChoiceStrategy.ROUND_ROBIN: 0,
            AnchorChoiceStrategy.FULL_GROUPS: 1,
            AnchorChoiceStrategy.FIRST_REPORTED: 2,
        }[config.anchor_choice_strategy]

        result = SearchResult()
        result.anchors_by_seed = [None] * len(seeds)
        by_class: dict[tuple[int, int], list[int]] = {}
        for i, seed in enumerate(seeds):
            by_class.setdefault((seed.length, seed.num_errors), []).append(i)

        for (length, errors), indices in by_class.items():
            expanded = expand_scheme(errors, length)
            patterns = np.stack(
                [
                    query[
                        seeds[i].query_position : seeds[i].query_position
                        + length
                    ]
                    for i in indices
                ]
            )
            out = native_search_select_batch(
                self.index,
                patterns,
                expanded,
                self.search_cap(),
                config.max_num_anchors_hard,
                config.max_num_anchors_soft,
                order_code,
                choice_code,
                config.erase_useless_anchors,
                self.num_threads,
            )
            if out is None:
                return None
            anchors_arr, counts = out
            counts_rows = counts.tolist()
            for j, i in enumerate(indices):
                status, num_written, kept_raw, kept_useful, total_raw = (
                    counts_rows[j]
                )
                if status & 2:
                    # group-buffer overflow: redo this seed in Python
                    groups, total, _ = search_seed_groups(
                        self.index, patterns[j], errors, self.search_cap()
                    )
                    result.anchors_by_seed[i] = self.process_seed_groups(
                        seeds[i], groups, total
                    )
                    continue
                if status & 4:  # hard-cap excluded: all counters zero
                    result.anchors_by_seed[i] = AnchorsOfSeed(
                        rows=anchors_arr[j, :0], leaf_index=seeds[i].pex_leaf_index
                    )
                    continue
                result.anchors_by_seed[i] = AnchorsOfSeed(
                    num_kept_useful_anchors=kept_useful,
                    num_kept_raw_anchors=kept_raw,
                    num_excluded_raw_anchors_by_soft_cap=total_raw - kept_raw,
                    rows=anchors_arr[j, :num_written],
                    leaf_index=seeds[i].pex_leaf_index,
                )
        return result

    def _search_all_groups(self, seeds: list[Seed], query: np.ndarray):
        from .native import native_search_seeds_batch

        out: list = [None] * len(seeds)
        by_class: dict[tuple[int, int], list[int]] = {}
        for i, seed in enumerate(seeds):
            by_class.setdefault((seed.length, seed.num_errors), []).append(i)

        for (length, errors), indices in by_class.items():
            expanded = expand_scheme(errors, length)
            cap = self.search_cap()
            batch = None
            if len(indices) > 1:
                patterns = np.stack(
                    [
                        query[
                            seeds[i].query_position : seeds[i].query_position
                            + length
                        ]
                        for i in indices
                    ]
                )
                batch = native_search_seeds_batch(
                    self.index, patterns, expanded, cap, self.num_threads
                )
            for slot, i in enumerate(indices):
                entry = batch[slot] if batch is not None else None
                if entry is not None:
                    rows, total, _ = entry
                    groups = [
                        AnchorGroup(
                            Cursor(int(lb), int(lb_rev), int(ln)), int(er)
                        )
                        for lb, lb_rev, ln, er in rows
                    ]
                    out[i] = (groups, total)
                else:
                    seed = seeds[i]
                    pattern = query[
                        seed.query_position : seed.query_position + seed.length
                    ]
                    groups, total, _ = search_seed_groups(
                        self.index, pattern, seed.num_errors, cap
                    )
                    out[i] = (groups, total)
        return out

    def choose_anchor_rows(
        self, seed: Seed, groups: list[AnchorGroup], total_raw: int
    ) -> tuple[bool, list[int], list[int], int]:
        """Hard-cap exclusion + group ordering + choice strategy
        (search.cpp:190-299). Returns (excluded, picked_rows, picked_errors,
        num_kept_raw). The choice loops never need anchor positions — only
        cursor lengths and error counts — so picks are plain BWT rows,
        located later in one batched (native) call per query."""
        config = self.config

        if (
            total_raw > config.max_num_anchors_hard
            and config.anchor_choice_strategy != AnchorChoiceStrategy.FIRST_REPORTED
        ):
            # seed fully excluded (search.cpp:190-202)
            return True, [], [], 0

        if config.anchor_group_order != AnchorGroupOrder.NONE:
            # the reference sorts with std::ranges::sort (search.cpp:204-229)
            # — an UNSTABLE introsort whose tie placement (and, for the
            # degenerate errors_first predicate, the entire result) is
            # defined by the algorithm. std_sort is a faithful libstdc++
            # replica, so the permutation matches the reference bit-exactly
            # given the same input order (DFS emission order here).
            from .utils.introsort import (
                count_first_comp,
                errors_first_comp,
                std_sort,
            )

            comp = (
                count_first_comp
                if config.anchor_group_order == AnchorGroupOrder.COUNT_FIRST
                else errors_first_comp
            )
            std_sort(
                groups,
                lambda g1, g2: comp(
                    (g1.cursor.length, g1.num_errors),
                    (g2.cursor.length, g2.num_errors),
                ),
            )

        num_kept_raw = 0
        picked_rows: list[int] = []
        picked_errors: list[int] = []

        def emit(group: AnchorGroup, row_offset: int) -> None:
            picked_rows.append(group.cursor.lb + row_offset)
            picked_errors.append(group.num_errors)

        if config.anchor_choice_strategy == AnchorChoiceStrategy.ROUND_ROBIN:
            # rotate over the remaining groups, one anchor per group per
            # round (search.cpp:239-272)
            remaining = list(range(len(groups)))
            round_no = 0
            idx = 0
            while remaining and num_kept_raw != config.max_num_anchors_soft:
                group = groups[remaining[idx]]
                emit(group, round_no)
                num_kept_raw += 1
                if group.cursor.length == round_no + 1:
                    remaining.pop(idx)
                else:
                    idx += 1
                if idx >= len(remaining):
                    idx = 0
                    round_no += 1
        else:  # FULL_GROUPS and FIRST_REPORTED (search.cpp:273-299)
            for group in groups:
                if num_kept_raw == config.max_num_anchors_soft:
                    break
                for row in range(group.cursor.length):
                    emit(group, row)
                    num_kept_raw += 1
                    if num_kept_raw == config.max_num_anchors_soft:
                        break

        return False, picked_rows, picked_errors, num_kept_raw

    def finalize_anchors(
        self,
        seed: Seed,
        picked_errors: list[int],
        reference_ids,
        positions,
        total_raw: int,
        num_kept_raw: int,
    ) -> AnchorsOfSeed:
        """Build per-reference anchor lists from located picks and run the
        dominance sweep (search.cpp:300-318)."""
        anchors_by_reference: list[list[Anchor]] = [
            [] for _ in range(self.num_reference_sequences)
        ]
        leaf_index = seed.pex_leaf_index
        for reference_id, position, errors in zip(
            reference_ids, positions, picked_errors
        ):
            anchors_by_reference[reference_id].append(
                Anchor(
                    pex_leaf_index=leaf_index,
                    reference_id=int(reference_id),
                    reference_position=int(position),
                    num_errors=errors,
                )
            )

        num_excluded_soft = total_raw - num_kept_raw
        num_kept_useful = num_kept_raw
        if self.config.erase_useless_anchors:
            num_kept_useful = erase_useless_anchors(anchors_by_reference)

        return AnchorsOfSeed(
            num_kept_useful_anchors=num_kept_useful,
            num_kept_raw_anchors=num_kept_raw,
            num_excluded_raw_anchors_by_soft_cap=num_excluded_soft,
            anchors_by_reference=anchors_by_reference,
        )

    def process_seed_groups(
        self, seed: Seed, groups: list[AnchorGroup], total_raw: int
    ) -> AnchorsOfSeed:
        """Group post-processing: hard cap, ordering, choice strategy,
        dominance sweep (search.cpp:190-318). Shared by the host DFS and the
        device frontier search. Single-seed convenience wrapper around
        choose_anchor_rows + locate_batch + finalize_anchors."""
        excluded, picked_rows, picked_errors, num_kept_raw = (
            self.choose_anchor_rows(seed, groups, total_raw)
        )
        if excluded:
            return AnchorsOfSeed(
                anchors_by_reference=[
                    [] for _ in range(self.num_reference_sequences)
                ]
            )
        reference_ids, positions = self.index.locate_batch(
            np.asarray(picked_rows, dtype=np.int64)
        )
        return self.finalize_anchors(
            seed, picked_errors, reference_ids, positions, total_raw,
            num_kept_raw,
        )


def erase_useless_anchors(anchors_by_reference: list[list[Anchor]]) -> int:
    """Dominance sweep over position-sorted anchors (search.cpp:352-389):
    anchor a dominates b iff a.errors <= b.errors and |a.pos - b.pos| <=
    b.errors - a.errors. Returns the number of kept anchors; sorts and
    filters in place."""
    num_kept_useful = 0
    for anchors in anchors_by_reference:
        if not anchors:
            continue
        anchors.sort(key=lambda a: a.reference_position)
        current = 0
        while current < len(anchors) - 1:
            other = current + 1
            while other < len(anchors) and anchors[current].is_better_than(
                anchors[other]
            ):
                anchors[other].num_errors = ERASE_MARKER
                other += 1
            if other < len(anchors) and anchors[other].is_better_than(anchors[current]):
                anchors[current].num_errors = ERASE_MARKER
            current = other
        anchors[:] = [a for a in anchors if a.num_errors != ERASE_MARKER]
        num_kept_useful += len(anchors)
    return num_kept_useful
