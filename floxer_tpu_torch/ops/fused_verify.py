"""One-dispatch fused verification of a wave over device-resident banks.

Counterpart of floxer_tpu/ops/fused_verify.py. One wave of the
verification cascade is staged on the host as a single int32 task table
(one upload) and then runs on the device without a host round trip: per
walk-level stage and kernel kind, in sorted (stage, kind) order,

  - every task is gated on its walk's aliveness (a level only counts if
    every earlier level of the same walk passed): dead tasks get window
    length 0, so the kernels score no column and return the sentinel
    (distance = pattern length, end 0), which the host never caches;
  - the task windows and patterns are gathered from the resident banks
    and the kernel of the segment's kind runs (K1 banded, K2 small,
    K3 large; ops/resident.py);
  - the verdicts fold back into the aliveness vector
    (alive[walk] = min(alive[walk], dist <= budget and alive)).

The host reads back one (distances, ends) block per wave.

Left out against the reference: the plan templates and dispatch caps
(_PLAN_TEMPLATES, _DISPATCHED_PLANS, replay_plan, record_shape) and the
power-of-two segment capacities, which only bounded XLA recompiles, and
the stable alive-first permutation, which only served the TPU kernels'
per-group column bounds: the CUDA kernels stop each task at its own tlen.
Without capacity padding there are no pad rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .myers import MAX_UNROLLED_WORDS, WORD
from .resident import (
    CHARS_PER_WORD,
    ResidentBank,
    _resident_banded_call_core,
    _resident_large_call_core,
    _resident_small_call_core,
    addr_arrays,
    check_gather,
)

KIND_BANDED = "banded"
KIND_SMALL = "small"
KIND_LARGE = "large"

# kernel tile widths the segment shapes round to (the reference's Pallas
# tilings, kept so both packages see the same band and Peq widths)
BAND_TILE_WORDS = 128
LARGE_TILE_WORDS = 128

# task-table columns (one int32 matrix ships every segment's scalars)
(
    COL_WIN_WORD0, COL_WIN_PHASE, COL_WIN_LEN, COL_PAT_WORD0,
    COL_PAT_PHASE, COL_STREAM_WORD0, COL_STREAM_PHASE, COL_PAT_LEN,
    COL_BUDGET, COL_WALK,
) = range(10)
NUM_COLS = 10


def classify_task(
    m: int, n: int, budget: int, force_banded: bool = False
) -> tuple[str, int]:
    """(kind, state_words) for one task; mirrors the routing of
    verify_batch._TaskBatcher (banded whenever its band state is strictly
    narrower than the full state at tile granularity, else full by word
    count). state_words is the task's own requirement: band words
    (banded) or pattern words (full). force_banded routes every eligible
    task through the banded kernel (a test hook)."""
    if 0 < budget < m and n >= m - budget:
        band_tiles = -(-(n - m + 2 * budget + 1) // (BAND_TILE_WORDS * WORD))
        full_tiles = -(-(-(-m // WORD)) // BAND_TILE_WORDS)
        if band_tiles < full_tiles or force_banded:
            return KIND_BANDED, band_tiles * BAND_TILE_WORDS
    words = -(-m // WORD)
    if words > MAX_UNROLLED_WORDS:
        return KIND_LARGE, words
    return KIND_SMALL, words


@dataclass
class _Segment:
    kind: str
    max_words: int = 0  # max per-task state words
    max_win: int = 0  # max window length
    # per-task host-side staging (python lists; converted on dispatch)
    win_starts: list = field(default_factory=list)
    win_lens: list = field(default_factory=list)
    pat_starts: list = field(default_factory=list)
    pat_lens: list = field(default_factory=list)
    budgets: list = field(default_factory=list)
    walk_slots: list = field(default_factory=list)
    task_refs: list = field(default_factory=list)  # caller handles

    def shape(self) -> tuple[int, int]:
        """(state words, window chars) the segment's kernel runs at."""
        if self.kind == KIND_BANDED:
            words = -(-self.max_words // BAND_TILE_WORDS) * BAND_TILE_WORDS
        elif self.kind == KIND_LARGE:
            words = -(-self.max_words // LARGE_TILE_WORDS) * LARGE_TILE_WORDS
        else:
            words = self.max_words
        n_chars = -(-max(self.max_win, 1) // CHARS_PER_WORD) * CHARS_PER_WORD
        return words, n_chars


class FusedBatch:
    """Host-side builder for one fused dispatch.

    add_task() stages one (walk, level) task; tasks of the same walk MUST
    be added in walk order (stage index = how many tasks this walk has
    staged so far; aliveness is chained through stages). run_async()
    issues the wave on the banks' device; collect() waits and returns
    {task_ref: (distance, end)}."""

    def __init__(
        self,
        ref_bank: ResidentBank,
        query_bank: ResidentBank,
        force_banded: bool = False,
    ):
        if ref_bank.device != query_bank.device:
            raise ValueError("both banks must live on one device")
        self.ref_bank = ref_bank
        self.query_bank = query_bank
        self.device = ref_bank.device
        self.force_banded = force_banded
        # stage -> {kind -> _Segment}; a segment runs at its largest
        # task's shape, the kernels stop each task at its own window
        self.stages: list[dict[str, _Segment]] = []
        self._stage_of_walk: dict[int, int] = {}
        self._walk_ids: dict[int, int] = {}  # walk_id -> dense slot
        self.num_tasks = 0
        self._pending = None  # (packed device result, segments)

    def add_task(
        self,
        walk_id: int,
        win_start: int,
        win_len: int,
        pat_start: int,
        pat_len: int,
        budget: int,
    ) -> tuple[int, str, int]:
        """Stages a task; returns an opaque ref for result lookup."""
        stage = self._stage_of_walk.get(walk_id, 0)
        self._stage_of_walk[walk_id] = stage + 1
        slot = self._walk_ids.setdefault(walk_id, len(self._walk_ids))
        kind, state_words = classify_task(
            pat_len, win_len, budget, self.force_banded
        )
        while len(self.stages) <= stage:
            self.stages.append({})
        seg = self.stages[stage].get(kind)
        if seg is None:
            seg = self.stages[stage][kind] = _Segment(kind)
        seg.max_words = max(seg.max_words, state_words)
        seg.max_win = max(seg.max_win, win_len)
        row = len(seg.win_starts)
        seg.win_starts.append(win_start)
        seg.win_lens.append(win_len)
        seg.pat_starts.append(pat_start)
        seg.pat_lens.append(pat_len)
        seg.budgets.append(budget)
        seg.walk_slots.append(slot)
        ref = (stage, kind, row)
        seg.task_refs.append(ref)
        self.num_tasks += 1
        return ref

    def padded_cells(self) -> int:
        """DP cells the dispatch computes at its segments' shapes
        (cost-model input): per segment, tasks x state rows x window
        chars."""
        total = 0
        for stage in self.stages:
            for seg in stage.values():
                words, n_chars = seg.shape()
                total += len(seg.win_starts) * words * WORD * n_chars
        return total

    def _segments(self) -> list[_Segment]:
        return [
            self.stages[stage][kind]
            for stage in range(len(self.stages))
            for kind in sorted(self.stages[stage])
        ]

    def run(self) -> dict:
        """One dispatch + wait; returns {task_ref: (distance, end)}."""
        if self.run_async():
            return self.collect()
        return {}

    def run_async(self) -> bool:
        """Issue the wave on the device without waiting; returns True when
        work was issued (collect() then returns its results)."""
        if self.num_tasks == 0:
            self._pending = None
            return False
        segments = self._segments()
        table = np.concatenate(
            [_segment_device_args(seg) for seg in segments],
            axis=0,
        )
        packed = _fused_call(
            self.ref_bank.flat,
            self.query_bank.flat,
            torch.from_numpy(table).to(self.device),
            plan=[(seg.kind, *seg.shape()) for seg in segments],
            counts=[len(seg.win_starts) for seg in segments],
            num_walks=len(self._walk_ids),
        )
        self._pending = (packed, segments)
        return True

    def collect(self) -> dict:
        """Wait for the issued wave: ONE [num_tasks, 2] download.
        Returns {task_ref: (distance, end)}."""
        if self._pending is None:
            return {}
        packed, segments = self._pending
        self._pending = None
        packed = packed.cpu().numpy()
        results = {}
        offset = 0
        for seg in segments:
            for row, ref in enumerate(seg.task_refs):
                results[ref] = (
                    int(packed[offset + row, 0]),
                    int(packed[offset + row, 1]),
                )
            offset += len(seg.task_refs)
        return results


def _segment_device_args(seg: _Segment) -> np.ndarray:
    """One [tasks, NUM_COLS] int32 block of the task table."""
    count = len(seg.win_starts)
    win_starts = np.asarray(seg.win_starts, dtype=np.int64)
    pat_starts = np.asarray(seg.pat_starts, dtype=np.int64)
    budgets = np.asarray(seg.budgets, dtype=np.int64)
    win_word0, win_phase = addr_arrays(win_starts)
    pat_word0, pat_phase = addr_arrays(pat_starts)
    stream_word0, stream_phase = addr_arrays(pat_starts + budgets)
    block = np.empty((count, NUM_COLS), dtype=np.int32)
    block[:, COL_WIN_WORD0] = win_word0
    block[:, COL_WIN_PHASE] = win_phase
    block[:, COL_WIN_LEN] = seg.win_lens
    block[:, COL_PAT_WORD0] = pat_word0
    block[:, COL_PAT_PHASE] = pat_phase
    block[:, COL_STREAM_WORD0] = stream_word0
    block[:, COL_STREAM_PHASE] = stream_phase
    block[:, COL_PAT_LEN] = seg.pat_lens
    block[:, COL_BUDGET] = budgets
    block[:, COL_WALK] = seg.walk_slots
    return block


def _fused_call(ref_flat, bank_flat, table, plan, counts, num_walks):
    """The whole wave on the device: per segment, gate on aliveness, run
    the kernel of the segment's kind, fold the verdicts into aliveness.
    `table` is the [num_tasks, NUM_COLS] int32 task table on the device.
    Returns [num_tasks, 2] int32 (distance, end) in table order."""
    alive = torch.ones(num_walks, dtype=torch.int32, device=table.device)
    out_dists = []
    out_ends = []
    offset = 0
    for (kind, words, n_chars), count in zip(plan, counts):
        check_gather(words, n_chars)
        # one contiguous row per task-table column
        col = table[offset : offset + count].t().contiguous()
        offset += count
        walk = col[COL_WALK].to(torch.int64)
        a = alive[walk]
        win_len = torch.where(a == 1, col[COL_WIN_LEN], 0)
        common = (
            ref_flat, bank_flat, col[COL_WIN_WORD0], col[COL_WIN_PHASE],
            win_len, col[COL_PAT_WORD0], col[COL_PAT_PHASE],
        )
        if kind == KIND_BANDED:
            dist, end = _resident_banded_call_core(
                *common, col[COL_STREAM_WORD0], col[COL_STREAM_PHASE],
                col[COL_PAT_LEN], col[COL_BUDGET],
                band_words=words, num_text=n_chars,
            )
        elif kind == KIND_LARGE:
            dist, end = _resident_large_call_core(
                *common, col[COL_PAT_LEN],
                num_words_padded=words, num_text=n_chars,
            )
        else:
            dist, end = _resident_small_call_core(
                *common, col[COL_PAT_LEN],
                num_words=words, num_text=n_chars,
            )
        ok = ((dist <= col[COL_BUDGET]) & (a == 1)).to(torch.int32)
        alive.scatter_reduce_(0, walk, ok, reduce="amin")
        out_dists.append(dist)
        out_ends.append(end)
    return torch.stack([torch.cat(out_dists), torch.cat(out_ends)], dim=1)
