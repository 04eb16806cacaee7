"""Counterpart of floxer_tpu/search_device.py: the device seed search of
--device-search.

DeviceSearcher.search_seeds_many runs a read chunk's seeds in four
stages, as the reference does:
1. discovery: every eligible seed of the chunk (pattern length at most
   _MAX_DEVICE_PATTERN) in ONE work-queue search on the index's device
   (search_queue.workqueue_runner: K10 on the card), its scheme classes
   one per (errors, length) pair; or, with FLOXER_TPU_SEARCH_NO_CHUNK_FUSE
   set, the legacy block loop: per error class, blocks of _BLOCK_SEEDS
   seeds, each a frontier search of its own (ops/frontier: K11 on the
   card, a class's blocks in one launch), drained through a bounded
   window of launches in flight;
2. the keep-first dedup by (seed, lb, length, errors) and the running-total
   cap replay over the reports in host-DFS order, which reproduce the host
   DFS's (groups, total, aborted) per seed;
3. anchor selection over the found groups by the native library, or on
   the device with FLOXER_TPU_DEVICE_SELECT set
   (search_select_device: K12 on the card);
4. the native DFS redo of the seeds the device did not search: the long
   ones and the overflowed ones.
Without the native select (FLOXER_TPU_NO_NATIVE_SELECT, or no native
library) every query takes the per-query device search instead
(search_seeds: one frontier search a (length, errors) bucket of its seeds,
search_seeds_device). So the output equals the host search's, including
where the anchor caps bind.

ShardedDeviceSearcher (--index-shards N) runs the same stages over the
row-sharded index (parallel/sharded_index.py): the legacy block loop on
K11 over the shard tables, the per-query frontier likewise, the native
select and the host locate.

Not ported: the chunk frontier (FLOXER_TPU_SEARCH_ENGINE=frontier, an
ablation; it raises NotImplementedError).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

import torch

from . import tracing
from .ops.frontier import frontier_search_batch
from .schemes import ExpandedSearch, expand_scheme
from .search_queue import workqueue_runner

# longest pattern sent to the device search: longer seeds join the native
# DFS redo. The reference set it against a TPU execution watchdog; it
# moves seeds between the device and the host and never changes output
# (ROADMAP: a limit to revisit on the card).
_MAX_DEVICE_PATTERN = 112
# the legacy block loop's geometry (the reference's defaults): seeds a
# block, a block's frontier and report capacities, blocks in flight before
# the oldest is drained to the host, and the pattern pad quantum
_BLOCK_SEEDS = 256
_BLOCK_FRONTIER = 1 << 15
_BLOCK_REPORTS = 1 << 13
_INFLIGHT_BLOCKS = 4
_LEN_QUANTUM = 32
# blocks of one _run_block call (one K11 launch): a block's frontier
# scratch is 2.6 MB at _BLOCK_FRONTIER
_LAUNCH_BLOCKS = 256


def _gather_padded_patterns(arrays, sel, pad_len):
    """[len(sel), pad_len] int32 pattern block from the chunk's flat seed
    buffer: offsets broadcast + in-range mask + clamped gather."""
    gather = arrays.offsets_g[sel][:, None] + np.arange(
        pad_len, dtype=np.int64
    )
    in_range = (
        np.arange(pad_len, dtype=np.int64)[None, :]
        < arrays.length_g[sel][:, None]
    )
    return np.where(
        in_range,
        arrays.buffer[np.minimum(gather, arrays.buffer.shape[0] - 1)],
        0,
    ).astype(np.int32)


def refuse_unported_branches() -> None:
    """Raise when the environment selects the one search branch the port
    does not carry (the reference would take it): the chunk frontier."""
    engine = os.environ.get("FLOXER_TPU_SEARCH_ENGINE", "workqueue")
    if engine != "workqueue":
        raise NotImplementedError(
            f"FLOXER_TPU_SEARCH_ENGINE={engine}: only the work-queue device "
            "search is ported to floxer_tpu_torch (the chunk frontier is "
            "an ablation that is not ported)"
        )


def chunk_operands(arrays):
    """The work-queue operands of a chunk's eligible seeds: (patterns
    [k, pad_len] int32, the scheme class of each, their global seed ids,
    SchemeTables with one class per (errors, length) pair, the largest
    error count), or None when no seed is eligible."""
    eligible = np.flatnonzero(arrays.length_g <= _MAX_DEVICE_PATTERN)
    if eligible.size == 0:
        return None
    err_len = np.stack(
        [arrays.errors_g[eligible], arrays.length_g[eligible]], axis=1
    )
    uniq_pairs, class_of = np.unique(err_len, axis=0, return_inverse=True)
    # numpy 2.0.0 returns a 2-D inverse for axis-unique
    class_of = np.asarray(class_of).reshape(-1)
    tables = SchemeTables.from_length_classes(
        [expand_scheme(int(e), int(length)) for e, length in uniq_pairs]
    )
    pad_len = -(-int(arrays.length_g[eligible].max()) // 8) * 8
    patterns = _gather_padded_patterns(arrays, eligible, pad_len)
    return patterns, class_of, eligible, tables, int(uniq_pairs[:, 0].max())


def legacy_blocks(arrays):
    """The legacy block loop's frontier operands of a chunk, one error
    class at a time: (patterns int32 [F, _BLOCK_SEEDS, pad_len], seed
    classes int32 [F, _BLOCK_SEEDS] (the last block padded with the dead
    class), SchemeTables with one class per length, max_iterations, the
    class's global seed ids) for each error count with eligible seeds."""
    for errors in np.unique(arrays.errors_g).tolist():
        sel = np.flatnonzero(
            (arrays.errors_g == errors)
            & (arrays.length_g <= _MAX_DEVICE_PATTERN)
        )
        if sel.shape[0] == 0:
            continue
        lengths = arrays.length_g[sel]
        uniq_lens, len_class = np.unique(lengths, return_inverse=True)
        len_class = np.asarray(len_class).reshape(-1)
        tables = SchemeTables.from_length_classes(
            [expand_scheme(errors, int(length)) for length in uniq_lens]
        )
        pad_len = -(-int(uniq_lens.max()) // _LEN_QUANTUM) * _LEN_QUANTUM
        max_iterations = pad_len + int(errors) + 2 * tables.num_parts + 2
        num_blocks = -(-sel.shape[0] // _BLOCK_SEEDS)
        padded = np.zeros((num_blocks * _BLOCK_SEEDS, pad_len),
                          dtype=np.int32)
        padded[:sel.shape[0]] = _gather_padded_patterns(arrays, sel, pad_len)
        seed_class = np.full(num_blocks * _BLOCK_SEEDS, tables.dead_class,
                             dtype=np.int32)
        seed_class[:sel.shape[0]] = len_class
        yield (padded.reshape(num_blocks, _BLOCK_SEEDS, pad_len),
               seed_class.reshape(num_blocks, _BLOCK_SEEDS), tables,
               max_iterations, sel)


def replay_groups(rep, redo_set_mask, cap):
    """The keep-first dedup by (seed, lb, length, errors) and the
    running-total cap replay of a chunk's report rows (int64 [k, 5] = gid,
    lb, lb_rev, length, errors, each seed's rows in host-DFS order), the
    seeds in redo_set_mask dropped: (groups [G, 4] = lb, lb_rev, length,
    errors; group_starts [S + 1]; totals [S], the running total at each
    seed's stop point; statuses [S], bit 0 for an aborted seed), which
    reproduce the host DFS's (groups, total, aborted) per seed."""
    total_seeds = redo_set_mask.shape[0]
    if rep.shape[0]:
        rep = rep[~redo_set_mask[rep[:, 0]]]
    statuses = np.zeros(total_seeds, dtype=np.int64)
    if rep.shape[0]:
        # stable per-gid grouping preserves per-seed DFS order
        rep = rep[np.argsort(rep[:, 0], kind="stable")]
        # keep-first dedup by (gid, lb, len, err): lexsort is stable, so
        # the first row of each equal-key run is the first DFS report
        perm = np.lexsort((rep[:, 4], rep[:, 3], rep[:, 1], rep[:, 0]))
        key = rep[perm][:, [0, 1, 3, 4]]
        first = np.ones(rep.shape[0], dtype=bool)
        first[1:] = np.any(key[1:] != key[:-1], axis=1)
        rep = rep[np.sort(perm[first])]
    gid_of_group = rep[:, 0]

    if rep.shape[0]:
        # cap replay: a group is kept iff the running total BEFORE it is
        # under the cap; the crossing group is included and the seed is
        # marked aborted (status bit 0)
        csum = np.cumsum(rep[:, 3])
        seg_first = np.ones(rep.shape[0], dtype=bool)
        seg_first[1:] = gid_of_group[1:] != gid_of_group[:-1]
        base = np.zeros(rep.shape[0], dtype=np.int64)
        starts_pos = np.flatnonzero(seg_first)
        base[starts_pos] = csum[starts_pos] - rep[starts_pos, 3]
        base = np.maximum.accumulate(base)
        running = csum - base
        keep = (running - rep[:, 3]) < cap
        seed_aborted = np.zeros(total_seeds, dtype=bool)
        np.logical_or.at(
            seed_aborted, gid_of_group[keep], running[keep] >= cap
        )
        statuses[seed_aborted] = 1
        rep = rep[keep]
        running = running[keep]
        gid_of_group = rep[:, 0]
    groups_flat = rep[:, [1, 2, 3, 4]]

    group_counts = np.bincount(gid_of_group, minlength=total_seeds)
    group_starts = np.zeros(total_seeds + 1, dtype=np.int64)
    np.cumsum(group_counts, out=group_starts[1:])
    totals = np.zeros(total_seeds, dtype=np.int64)
    if rep.shape[0]:
        # truncated running total at each seed's stop point
        last_pos = group_starts[1:][group_counts > 0] - 1
        totals[np.unique(gid_of_group)] = running[last_pos]
    return groups_flat, group_starts, totals, statuses


def report_capacity(num_seeds: int) -> int:
    """Report rows of a dispatch of num_seeds seeds (the reference's
    sizing; the runner's one retry takes 4x)."""
    return max(32 * num_seeds, 1 << 13)


class DeviceSearcher:
    """A Searcher whose seed search discovers anchor groups on the device
    and reuses the host post-processing; seeds the device cannot finish
    go to the native DFS."""

    # the chunk path's discovery: one work-queue dispatch a chunk, unless
    # FLOXER_TPU_SEARCH_NO_CHUNK_FUSE is set (read at each chunk) or a
    # subclass clears this; else the legacy loop of one frontier search a
    # block
    _one_dispatch_chunk = True
    # counters for tests and chip_smoke.py: work-queue dispatches, and
    # the seeds redone on the host because they were long or because
    # their search overflowed. Each stage's time is a span of the job
    # (tracing.py), search.device.<stage>: work_queue (the dispatch: its
    # operands, upload, launch, download and report sort as children);
    # blocks (the legacy block loop's launches and drains); dedup_cap;
    # select (the native select); device_select (the device select, its
    # host group order select_order, the introsort loop, a child); redo;
    # frontier (the per-query path's frontier searches with their uploads
    # and downloads); frontier_replay (their reports' keep-first dedup
    # and cap replay in Python)
    _chunk_dispatches = 0
    redo_long = 0
    redo_overflow = 0
    # the pipeline's span around search_seeds_many
    trace_name = "search.device"

    def __init__(self, host_searcher, device_index):
        self._host = host_searcher
        self._device_index = device_index
        self.index = host_searcher.index
        self.num_reference_sequences = host_searcher.num_reference_sequences
        self.config = host_searcher.config

    def _run_search(self, patterns, errors, expanded):
        return search_seeds_device(
            self._device_index,
            patterns,
            errors,
            expanded,
            max_total_count=self._host.search_cap(),
        )

    def _run_block(
        self, padded, seed_class, tables, frontier_cap, report_cap, max_iter
    ):
        """Frontier searches of F blocks of one shape (padded int32 [F,
        _BLOCK_SEEDS, pad_len], seed_class int32 [F, _BLOCK_SEEDS]), each
        with its own capacities and flag, in one launch on the card;
        returns the device results (ops.frontier.FrontierBatch) so the
        caller can overlap several launches before synchronizing."""
        return block_search(self._device_index, padded, seed_class, tables,
                            frontier_cap, report_cap, max_iter)

    def _run_chunk_fused(self, arrays):
        """ONE work-queue dispatch for a whole chunk's eligible seeds:
        (report rows [k, 5] = gid, lb, lb_rev, len, err; overflow gids)."""
        with tracing.span("search.device.work_queue.operands"):
            operands = chunk_operands(arrays)
        if operands is None:
            return (
                np.zeros((0, 5), dtype=np.int64),
                np.zeros(0, dtype=np.int64),
            )
        return self._dispatch_workqueue(*operands)

    def _dispatch_workqueue(self, patterns, class_of, gids, tables,
                            max_errors):
        """One work-queue dispatch: (rows [k, 5] = gid, lb, lb_rev, len,
        err in per-seed host-DFS order; overflow gids). A persisting
        overflow routes every seed to the host redo."""
        rows6, overflow = workqueue_runner(
            self._device_index, patterns, class_of, tables,
            report_capacity(patterns.shape[0]), patterns.shape[1], max_errors,
        )
        type(self)._chunk_dispatches += 1
        rows = np.empty((rows6.shape[0], 5), dtype=np.int64)
        rows[:, 0] = gids[rows6[:, 4]]
        rows[:, 1:] = rows6[:, :4]  # lb, lb_rev, length, errors
        if overflow:
            return rows, gids.astype(np.int64)
        return rows, np.zeros(0, dtype=np.int64)

    def _legacy_block_loop(self, arrays, inflight, drain_one):
        """One frontier search per [_BLOCK_SEEDS]-seed block per error
        class (the reference's pre-chunk execution shape, which its
        sharded searcher runs); a class's blocks go to the device
        _LAUNCH_BLOCKS at a time in one _run_block call, and at most
        _INFLIGHT_BLOCKS calls stay in flight before the oldest is
        drained."""
        for padded, seed_class, tables, max_iterations, sel in (
            legacy_blocks(arrays)
        ):
            num_blocks = padded.shape[0]
            for first in range(0, num_blocks, _LAUNCH_BLOCKS):
                last = min(first + _LAUNCH_BLOCKS, num_blocks)
                out = self._run_block(
                    padded[first:last],
                    seed_class[first:last],
                    tables,
                    _BLOCK_FRONTIER,
                    _BLOCK_REPORTS,
                    max_iterations,
                )
                blocks = [
                    (sel[b * _BLOCK_SEEDS:(b + 1) * _BLOCK_SEEDS],
                     min(_BLOCK_SEEDS, sel.shape[0] - b * _BLOCK_SEEDS))
                    for b in range(first, last)
                ]
                inflight.append((out, blocks))
                while len(inflight) >= _INFLIGHT_BLOCKS:
                    drain_one()

    def _block_reports(self, arrays):
        """The legacy block loop's (report rows, overflow gids) of a
        chunk: a bounded window of launches in flight; each drained
        launch leaves one (reports, count, overflow, gids, n_real) a
        block."""
        inflight = []  # (FrontierBatch on the device, [(gids, n_real)])
        pending = []

        def drain_one():
            out, blocks = inflight.pop(0)
            d_reports = out.reports.cpu().numpy()
            d_num = out.num_reports.cpu().numpy()
            d_overflow = out.overflow.cpu().numpy()
            for b, (gids, n_real) in enumerate(blocks):
                pending.append((d_reports[b], int(d_num[b]),
                                d_overflow[b], gids, n_real))

        self._legacy_block_loop(arrays, inflight, drain_one)
        while inflight:
            drain_one()
        report_rows = []  # each [k, 5]: gid, lb, lb_rev, len, err
        overflow_gids = []
        for reports, num_reports, overflow, gids, n_real in pending:
            reports = reports[:num_reports]
            local = reports[:, 4]
            keep = local < n_real
            rows = np.empty((int(keep.sum()), 5), dtype=np.int64)
            rows[:, 0] = gids[local[keep]]
            rows[:, 1:] = reports[keep, :4]
            report_rows.append(rows)
            overflow_gids.append(gids[np.flatnonzero(overflow[:n_real])])
        return report_rows, overflow_gids

    def search_seeds_many(self, jobs):
        """Chunk-level device search: every job's seeds (all queries of a
        read chunk, fwd and rc) in one work-queue dispatch (or the legacy
        block loop), then the anchor selection over the groups found (the
        native select, or the device select) and the native redo of the
        seeds the device did not finish. Results are SearchResultSoA, the
        same as the host chunk path's. Without the native select every
        query takes the per-query device search (slower, same output)."""
        from .native import (
            get_library,
            native_search_select_batch_offsets,
            native_select_from_groups_batch,
        )
        from .search_host import (
            AnchorChoiceStrategy,
            AnchorGroupOrder,
            assemble_chunk_seed_arrays,
            build_soa_results,
        )

        if not jobs:
            return []
        refuse_unported_branches()
        if os.environ.get("FLOXER_TPU_NO_NATIVE_SELECT") or (
            get_library() is None
        ):
            # no native select: per-query device path (slower, same output)
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

        arrays = assemble_chunk_seed_arrays(jobs)
        total_seeds = arrays.total_seeds
        buffer = arrays.buffer

        # ---- stage 1: device group discovery ----
        long_gids = np.flatnonzero(arrays.length_g > _MAX_DEVICE_PATTERN)
        if self._one_dispatch_chunk and not os.environ.get(
            "FLOXER_TPU_SEARCH_NO_CHUNK_FUSE"
        ):
            with tracing.span("search.device.work_queue"):
                rows, ovf_gids = self._run_chunk_fused(arrays)
            report_rows = [rows]  # each [k, 5]: gid, lb, lb_rev, len, err
            overflow_gids = [ovf_gids]
        else:
            with tracing.span("search.device.blocks"):
                report_rows, overflow_gids = self._block_reports(arrays)
        ovf_gids = (np.concatenate(overflow_gids) if overflow_gids
                    else np.zeros(0, dtype=np.int64))
        redo = np.unique(np.concatenate([long_gids, ovf_gids]))
        type(self).redo_long += int(long_gids.size)
        type(self).redo_overflow += int(np.unique(ovf_gids).size)
        redo_set_mask = np.zeros(total_seeds, dtype=bool)
        redo_set_mask[redo] = True
        rep = (
            np.concatenate(report_rows)
            if report_rows
            else np.zeros((0, 5), dtype=np.int64)
        )

        # ---- stage 2: order-preserving dedup + cap replay ----
        with tracing.span("search.device.dedup_cap"):
            groups_flat, group_starts, totals, statuses = replay_groups(
                rep, redo_set_mask, self._host.search_cap()
            )

        # ---- stage 3: anchor selection over the found groups: on the
        # device (caps, order, choice, locate, dominance: K12 on the card)
        # with FLOXER_TPU_DEVICE_SELECT set, else the native select ----
        out = None
        if os.environ.get("FLOXER_TPU_DEVICE_SELECT") and getattr(
            self, "_device_index", None
        ) is not None:
            from .search_select_device import device_select_from_groups_batch

            with tracing.span("search.device.device_select"):
                out = device_select_from_groups_batch(
                    self._device_index,
                    groups_flat,
                    group_starts,
                    totals,
                    statuses,
                    config.max_num_anchors_hard,
                    config.max_num_anchors_soft,
                    order_code,
                    choice_code,
                    config.erase_useless_anchors,
                )
        else:
            with tracing.span("search.device.select"):
                out = native_select_from_groups_batch(
                    self.index,
                    groups_flat,
                    group_starts,
                    totals,
                    statuses,
                    config.max_num_anchors_hard,
                    config.max_num_anchors_soft,
                    order_code,
                    choice_code,
                    config.erase_useless_anchors,
                    self._host.num_threads,
                )
        if out is None:  # the library vanished mid-run: per-query path
            return [self.search_seeds(s, q) for s, q in jobs]
        anchors_arr, counts = out

        nw_g = np.zeros(total_seeds, dtype=np.int64)
        kept_raw_g = np.zeros(total_seeds, dtype=np.int64)
        kept_useful_g = np.zeros(total_seeds, dtype=np.int64)
        excluded_soft_g = np.zeros(total_seeds, dtype=np.int64)
        rows_parts: list[np.ndarray] = []
        gid_parts: list[np.ndarray] = []

        status = counts[:, 0]
        nw = counts[:, 1]
        ok = ((status & 6) == 0) & ~redo_set_mask
        nw = np.where(ok, nw, 0)
        sub = np.flatnonzero(ok)
        nw_g[sub] = nw[sub]
        kept_raw_g[sub] = counts[sub, 2]
        kept_useful_g[sub] = counts[sub, 3]
        excluded_soft_g[sub] = counts[sub, 4] - counts[sub, 2]
        valid = (
            np.arange(anchors_arr.shape[1], dtype=np.int64)[None, :]
            < nw[:, None]
        )
        rows_parts.append(anchors_arr[valid])
        gid_parts.append(np.repeat(np.arange(total_seeds), nw))

        # ---- stage 4: native DFS redo of the seeds the device left ----
        with tracing.span("search.device.redo", seeds=int(redo.shape[0])):
            redo_key = arrays.length_g[redo] * 4096 + arrays.errors_g[redo]
            for key_value in np.unique(redo_key).tolist():
                cls_sel = redo[redo_key == key_value]
                length, errors = key_value // 4096, key_value % 4096
                out = native_search_select_batch_offsets(
                    self.index,
                    buffer,
                    arrays.offsets_g[cls_sel],
                    expand_scheme(int(errors), int(length)),
                    self._host.search_cap(),
                    config.max_num_anchors_hard,
                    config.max_num_anchors_soft,
                    order_code,
                    choice_code,
                    config.erase_useless_anchors,
                    self._host.num_threads,
                )
                if out is None:  # the library vanished: per-query path
                    return [self.search_seeds(s, q) for s, q in jobs]
                r_anchors, r_counts = out
                r_status = r_counts[:, 0]
                r_nw = np.where((r_status & 6) == 0, r_counts[:, 1], 0)
                r_ok = np.flatnonzero((r_status & 6) == 0)
                nw_g[cls_sel[r_ok]] = r_nw[r_ok]
                kept_raw_g[cls_sel[r_ok]] = r_counts[r_ok, 2]
                kept_useful_g[cls_sel[r_ok]] = r_counts[r_ok, 3]
                excluded_soft_g[cls_sel[r_ok]] = (
                    r_counts[r_ok, 4] - r_counts[r_ok, 2]
                )
                r_valid = (
                    np.arange(r_anchors.shape[1], dtype=np.int64)[None, :]
                    < r_nw[:, None]
                )
                rows_parts.append(r_anchors[r_valid])
                gid_parts.append(np.repeat(cls_sel, r_nw))
                # a native group-buffer overflow (status & 2): re-search the
                # seed on its own on the host
                for gid in cls_sel[np.flatnonzero(r_status & 2)].tolist():
                    self._redo_seed_host(
                        int(gid), arrays, jobs, nw_g, kept_raw_g,
                        kept_useful_g, excluded_soft_g, rows_parts,
                        gid_parts,
                    )

        return build_soa_results(
            arrays,
            nw_g,
            kept_raw_g,
            kept_useful_g,
            excluded_soft_g,
            rows_parts,
            gid_parts,
        )

    def _redo_seed_host(
        self, gid, arrays, jobs, nw_g, kept_raw_g, kept_useful_g,
        excluded_soft_g, rows_parts, gid_parts,
    ):
        """Last-resort per-seed host redo (native group buffer overflow)."""
        from .search_host import search_seed_groups

        job_idx = int(arrays.job_g[gid])
        seed_idx = gid - int(arrays.job_seed_base[job_idx])
        seeds, query = jobs[job_idx]
        qpos = int(arrays.qpos_g[gid])
        length = int(arrays.length_g[gid])
        groups, total, _ = search_seed_groups(
            self.index,
            query[qpos : qpos + length],
            int(arrays.errors_g[gid]),
            self._host.search_cap(),
        )
        aos = self._host.process_seed_groups(seeds[seed_idx], groups, total)
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

    def search_seeds(self, seeds, query):
        """The per-query device search: one frontier search per (length,
        errors) bucket of the query's seeds; seeds longer than
        _MAX_DEVICE_PATTERN and seeds whose search overflowed take the
        host DFS."""
        from .index.fmindex import Cursor
        from .search_host import (
            AnchorGroup,
            SearchResult,
            search_seed_groups,
        )

        result = SearchResult()
        result.anchors_by_seed = [None] * len(seeds)

        buckets: dict[tuple[int, int], list[int]] = {}
        for i, seed in enumerate(seeds):
            buckets.setdefault((seed.length, seed.num_errors), []).append(i)

        for (length, errors), indices in buckets.items():
            patterns = [
                query[
                    seeds[i].query_position : seeds[i].query_position + length
                ]
                for i in indices
            ]
            if length > _MAX_DEVICE_PATTERN:
                # long seeds run the host DFS directly
                for slot, i in enumerate(indices):
                    groups, total_raw, _ = search_seed_groups(
                        self.index,
                        patterns[slot],
                        errors,
                        self._host.search_cap(),
                    )
                    result.anchors_by_seed[i] = (
                        self._host.process_seed_groups(
                            seeds[i], groups, total_raw
                        )
                    )
                continue
            expanded = expand_scheme(errors, length)
            groups_per_seed, totals, _aborted, overflow = self._run_search(
                patterns, errors, expanded
            )
            for slot, i in enumerate(indices):
                if overflow[slot]:
                    groups, total_raw, _ = search_seed_groups(
                        self.index,
                        patterns[slot],
                        errors,
                        self._host.search_cap(),
                    )
                else:
                    groups = [
                        AnchorGroup(Cursor(lb, lb_rev, ln), er)
                        for lb, lb_rev, ln, er in groups_per_seed[slot]
                    ]
                    total_raw = int(totals[slot])
                result.anchors_by_seed[i] = self._host.process_seed_groups(
                    seeds[i], groups, total_raw
                )
        return result


class ShardedDeviceSearcher(DeviceSearcher):
    """A DeviceSearcher whose frontier searches run against the
    row-sharded index (the hg38-scale configuration, where the occurrence
    table does not fit one device): K11 over the shard tables, all on one
    device. Anchor post-processing and locate stay on the host path, as in
    DeviceSearcher; it has no unsharded device index, so
    FLOXER_TPU_DEVICE_SELECT takes the native select."""

    # the reference builds its sharded program per block: chunks take the
    # legacy block loop (K11), never the work queue (K10)
    _one_dispatch_chunk = False

    def __init__(self, host_searcher, sharded_index):
        self._host = host_searcher
        self._sh = sharded_index
        self.index = host_searcher.index
        self.num_reference_sequences = host_searcher.num_reference_sequences
        self.config = host_searcher.config

    def _run_block(
        self, padded, seed_class, tables, frontier_cap, report_cap, max_iter
    ):
        return block_search(self._sh, padded, seed_class, tables,
                            frontier_cap, report_cap, max_iter)

    def _run_search(self, patterns, errors, expanded):
        return search_seeds_device(
            self._sh,
            patterns,
            errors,
            expanded,
            max_total_count=self._host.search_cap(),
        )


def make_sharded_searcher(host_searcher, host_index, num_shards: int,
                          device: torch.device):
    """A ShardedDeviceSearcher over num_shards shards of the index, all on
    `device` (the reference puts each on one of its first num_shards
    devices)."""
    from .index.device_index import ShardedDeviceIndex
    from .parallel.sharded_index import shard_full_index

    sh = ShardedDeviceIndex.from_shards(
        shard_full_index(host_index, num_shards), device
    )
    return ShardedDeviceSearcher(host_searcher, sh)


def block_search(index, padded, seed_class, tables, frontier_cap, report_cap,
                 max_iter):
    """F frontier searches of one shape (numpy padded int32 [F, S, L],
    seed_class int32 [F, S]) on the device of `index` (a DeviceIndex or a
    ShardedDeviceIndex) in one launch of K11; the device results
    (ops.frontier.FrontierBatch), not synchronized."""
    device = index.device
    return frontier_search_batch(
        index,
        torch.from_numpy(np.ascontiguousarray(padded, dtype=np.int32))
        .to(device),
        torch.from_numpy(np.ascontiguousarray(seed_class, dtype=np.int32))
        .to(device),
        torch.from_numpy(tables.fused()).to(device),
        tables.num_searches,
        tables.num_parts,
        frontier_cap,
        report_cap,
        max_iter,
    )


@dataclass(frozen=True)
class SchemeTables:
    """Expanded-search tables, numpy int32 [num_classes, num_searches,
    num_parts], one CLASS per (errors, length) pair of a chunk's seeds;
    fused() is the form the device search takes.

    Class `num_real`, the last, is the DEAD class, the reference's class
    for padding seeds (the parity tests pad with it): its parts are the
    empty span [0, 0) with direction +1 and lower bound 1, so a state of
    it hits the part boundary immediately, fails the lower bound, and dies
    without ever expanding or reporting. The dispatches here hand the
    search only real seeds."""

    start: np.ndarray
    end: np.ndarray
    direction: np.ndarray
    lower: np.ndarray
    upper: np.ndarray
    num_classes: int
    num_real: int
    num_searches: int
    num_parts: int

    @property
    def dead_class(self) -> int:
        return self.num_real

    def fused(self) -> np.ndarray:
        """int32 [classes * searches * parts, 8]: per (class, search, part)
        its direction, start, end, lower and upper bound, then the next
        part's direction, start and end (the last part repeats itself)."""

        def roll_next(table):
            return np.concatenate([table[:, :, 1:], table[:, :, -1:]], axis=2)

        return np.ascontiguousarray(np.stack(
            [
                self.direction, self.start, self.end, self.lower, self.upper,
                roll_next(self.direction), roll_next(self.start),
                roll_next(self.end),
            ],
            axis=3,
        ).reshape(-1, 8), dtype=np.int32)

    @classmethod
    def from_length_classes(
        cls, class_searches: list[tuple[ExpandedSearch, ...]]
    ):
        """Classes may be heterogeneous (different error counts => different
        search and part counts): shapes pad to the maxima. A class's missing
        SEARCHES get dead rows (empty span, lower 1). A search's missing
        trailing PARTS become continuation pads (empty span, direction +1,
        lower/upper copied from the search's last real part): a state
        finishing the real scheme steps through each pad by a boundary
        advance and reports at the global last part — same reports, same
        DFS order."""
        num_real = len(class_searches)
        num_searches = max(len(s) for s in class_searches)
        num_parts = max(
            len(search.pi)
            for searches in class_searches
            for search in searches
        )
        num_classes = num_real + 1
        start = np.zeros((num_classes, num_searches, num_parts), dtype=np.int32)
        end = np.zeros_like(start)
        # dead-class defaults for the dead class and the padding searches
        direction = np.ones_like(start)
        lower = np.ones_like(start)
        upper = np.zeros_like(start)
        for c, searches in enumerate(class_searches):
            for s, search in enumerate(searches):
                real_parts = len(search.pi)
                for j in range(real_parts):
                    start[c, s, j], end[c, s, j] = search.part_spans[j]
                    direction[c, s, j] = search.directions[j]
                    lower[c, s, j] = search.lower[j]
                    upper[c, s, j] = search.upper[j]
                for j in range(real_parts, num_parts):
                    start[c, s, j] = end[c, s, j] = 0
                    direction[c, s, j] = 1
                    lower[c, s, j] = search.lower[real_parts - 1]
                    upper[c, s, j] = search.upper[real_parts - 1]
        return cls(start, end, direction, lower, upper, num_classes,
                   num_real, num_searches, num_parts)

    @classmethod
    def from_searches(cls, searches: tuple[ExpandedSearch, ...]):
        return cls.from_length_classes([list(searches)])


def frontier_operands(patterns, expanded_searches, max_errors):
    """A per-query bucket's frontier operands, as the reference builds
    them: (padded int32 [num_padded, max_len], seed classes, SchemeTables
    of the one scheme, max_iterations). The seed count is padded to a
    power of two (at least 8) with seeds of the DEAD class: the initial
    frontier, and so the overflow flag, depend on it."""
    tables = SchemeTables.from_searches(expanded_searches)
    max_len = max(len(p) for p in patterns)
    num_padded = 8
    while num_padded < len(patterns):
        num_padded *= 2
    padded = np.zeros((num_padded, max_len), dtype=np.int32)
    seed_class = np.full(num_padded, tables.dead_class, dtype=np.int32)
    for i, pattern in enumerate(patterns):
        padded[i, : len(pattern)] = pattern
        seed_class[i] = 0
    max_iterations = max_len + max_errors + 2 * tables.num_parts + 2
    return padded, seed_class, tables, max_iterations


def search_seeds_device(
    index,
    patterns: list[np.ndarray],
    max_errors: int,
    expanded_searches,
    frontier_capacity: int = 1 << 14,
    report_capacity: int = 1 << 12,
    runner=None,
    max_total_count: int | None = None,
):
    """Run the frontier search for a batch of same-(length, errors) seeds
    on the index's device (K11 on the card, its plain version on the CPU).

    Returns (groups_per_seed: list[list[(lb, lb_rev, len, errors)]],
    totals, aborted, overflow). Groups come back in host-DFS order,
    deduplicated by (lb, len, errors) keeping the first report, truncated
    by the running-total cap replay when max_total_count is given: a group
    is kept iff the total BEFORE it is under the cap, totals[i] is the
    running total at the stop point, and aborted[i] mirrors the host DFS's
    abort. The search is the job's span search.device.frontier, the
    replay search.device.frontier_replay."""
    with tracing.span("search.device.frontier", seeds=len(patterns)):
        reports, overflow = _frontier_reports(
            index, patterns, max_errors, expanded_searches,
            frontier_capacity, report_capacity, runner,
        )
    with tracing.span("search.device.frontier_replay"):
        groups, totals, aborted = _replay_frontier_reports(
            reports, len(patterns), max_total_count
        )
    return groups, totals, aborted, overflow


def _frontier_reports(index, patterns, max_errors, expanded_searches,
                      frontier_capacity, report_capacity, runner):
    """One frontier search's reports (numpy [n, 5]: lb, lb_rev, length,
    errors, seed) and overflow flags."""
    padded, seed_class, tables, max_iterations = frontier_operands(
        patterns, expanded_searches, max_errors
    )

    if runner is not None:
        reports, num_reports, overflow = runner(
            padded,
            seed_class,
            tables,
            frontier_capacity,
            report_capacity,
            max_iterations,
        )
        reports = np.asarray(reports)[: int(num_reports)]
        overflow = np.asarray(overflow)
    else:
        out = block_search(index, padded[None], seed_class[None], tables,
                           frontier_capacity, report_capacity,
                           max_iterations)
        num_reports = int(out.num_reports[0])
        reports = out.reports[0, :num_reports].cpu().numpy()
        overflow = out.overflow[0].cpu().numpy()
    return reports, overflow


def _replay_frontier_reports(reports, num_patterns, max_total_count):
    """The keep-first dedup and cap replay of one frontier search's
    reports: (groups per seed, totals, aborted)."""
    cap = (1 << 62) if max_total_count is None else int(max_total_count)

    groups: list[list[tuple[int, int, int, int]]] = [
        [] for _ in range(num_patterns)
    ]
    totals = np.zeros(num_patterns, dtype=np.int64)
    aborted = np.zeros(num_patterns, dtype=bool)
    seen: set = set()
    # reports are in frontier slot order: interleaved across seeds, but in
    # exact DFS order within each seed, so the keep-first dedup and cap
    # replay below reproduce search_host.search_seed_groups
    for lb, lb_rev, length, errors, seed in reports.tolist():
        s = int(seed)
        if s >= num_patterns:  # padding seed
            continue
        if aborted[s]:
            continue
        key = (s, int(lb), int(length), int(errors))
        if key in seen:
            continue
        seen.add(key)
        groups[s].append((int(lb), int(lb_rev), int(length), int(errors)))
        totals[s] += int(length)
        if totals[s] >= cap:
            aborted[s] = True
    return groups, totals, aborted
