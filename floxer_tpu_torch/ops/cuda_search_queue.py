"""K10: the work-queue seed search of --device-search on the card.

Counterpart of floxer_tpu/search_queue.py's _workqueue_search. The kernel
(csrc/workqueue_search.cu) runs one thread per (seed, search) root, an
explicit depth-first search in the host's edge order, at most `budget`
nodes a unit of work before the rest of the tree spills to a work list;
this wrapper launches it in generations, the first over the roots and
each later one over the entries the one before spilled (their count read
on the card), GENERATIONS_A_BATCH at a time with no synchronization
between them, until a generation spills nothing. It gives the same set of report rows as
search_queue.workqueue_search_plain, its plain version (rows equal once
sorted with search_queue.sort_reports), the same node count and the same
largest tree, whatever the budget. This wrapper takes CUDA tensors only:
search_queue.workqueue_runner runs the plain version for an index on the
CPU.
"""

from __future__ import annotations

import ctypes

import torch

from ..alphabet import SIGMA
from ._build import check_operand, launch

SOURCE = "floxer_tpu_torch/csrc/workqueue_search.cu"
REPLACES = "floxer_tpu/search_queue.py:90"
# the kernel's block, the key words it holds a thread in shared memory,
# the int32 fields of one frame of its stack and of one spilled entry (a
# frame, its seed and search, the key words, two of padding)
THREADS = 128
MAX_KEY_WORDS = 16
FRAME_INTS = 20
ENTRY_INTS = FRAME_INTS + 2 + MAX_KEY_WORDS + 2
# nodes a unit of work (a root or a spilled entry) expands before it
# spills, and each of the two work lists' default entries a root (at
# least MIN_LIST_ENTRIES)
BUDGET = 128
LIST_ENTRIES_PER_ROOT = 2
MIN_LIST_ENTRIES = 1 << 16
# the int64 counters the kernel keeps (csrc kCounters): reports
# appended, the overflow flag, the next root to hand out, nodes expanded,
# the largest tree of one root, entries spilled, the most one generation
# spilled; and each generation's own (kGenerationCounters): its next
# input entry, its output entries
COUNTERS = 7
GENERATION_COUNTERS = 2
# generations enqueued between two reads of the last one's output
GENERATIONS_A_BATCH = 4
# kernel launches in this process, and those of them past a search's
# first generation (read and reset by chip_smoke.py)
LAUNCHES = 0
SPILL_LAUNCHES = 0


def list_entries(roots: int) -> int:
    """A work list's default capacity for a launch of `roots` roots."""
    return max(LIST_ENTRIES_PER_ROOT * roots, MIN_LIST_ENTRIES)


def resident_blocks(device: torch.device) -> int:
    """Blocks of the kernel the card holds at once (SMs x occupancy): the
    grid, whose threads take roots from a shared counter until none is
    left, so the frame scratch is sized by it, not by the roots."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        launch("floxer_workqueue_occupancy", ctypes.addressof(blocks))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, blocks.value) * sms


def _check_operands(index, patterns, seed_class, scheme, num_searches,
                    num_parts, key_words):
    device = patterns.device
    if device.type != "cuda":
        raise ValueError(f"a CUDA kernel got operands on {device}")
    if not 1 <= key_words <= MAX_KEY_WORDS:
        raise ValueError(
            f"K10 keeps at most {MAX_KEY_WORDS} key words, got {key_words}"
        )
    S, L = patterns.shape
    check_operand(patterns, "patterns", (S, L), torch.int32, device)
    check_operand(seed_class, "seed_class", (S,), torch.int32, device)
    check_operand(scheme, "scheme", (scheme.shape[0], 8), torch.int32, device)
    if scheme.shape[0] % (num_searches * num_parts):
        raise ValueError("scheme rows are not classes x searches x parts")
    check_operand(index.C, "C", (SIGMA + 1,), torch.int32, device)
    for single in (index.fwd, index.rev):
        if index.rank_rows is None:
            nb = single.planes.shape[0]
            check_operand(single.occ, "occ", (nb + 1, SIGMA), torch.int32,
                          device)
            check_operand(single.planes, "planes", (nb, SIGMA, 4),
                          torch.int32, device)
    if index.rank_rows is not None:
        check_operand(index.rank_rows, "rank_rows",
                      (index.rank_rows.shape[0], 32), torch.int32, device)


class WorkqueueLaunch:
    """One K10 search's operands with its reports, counters, frame
    scratch, two work lists and root counts allocated once: launch()
    zeroes the counters and the root counts on the stream and enqueues
    the generations GENERATIONS_A_BATCH at a time, reading only the last
    one's output count (a synchronization) to know whether more are
    needed; result() reads the counters. start() and enqueue() are its
    two steps, so a search whose generations are known can be timed on
    the card alone."""

    def __init__(self, index, patterns, seed_class, scheme, num_searches,
                 num_parts, report_capacity, key_words, frame_capacity,
                 budget=BUDGET, list_capacity=None):
        _check_operands(index, patterns, seed_class, scheme, num_searches,
                        num_parts, key_words)
        if budget < 1:
            raise ValueError(f"K10's budget must be positive, got {budget}")
        device = patterns.device
        S, L = patterns.shape
        self.roots = S * num_searches
        self.report_capacity = report_capacity
        self.reports = torch.empty((report_capacity, 6 + key_words),
                                   dtype=torch.int32, device=device)
        self.counters = torch.zeros(COUNTERS, dtype=torch.int64,
                                    device=device)
        # two generations' counters: a generation reads the one before's
        self.generations = torch.zeros((2, GENERATION_COUNTERS),
                                       dtype=torch.int64, device=device)
        self.device = device
        self.launches = 0
        if self.roots == 0:
            return
        if list_capacity is None:
            list_capacity = list_entries(self.roots)
        self.list_capacity = list_capacity
        # the first generation's grid, and the later ones' (their input
        # counts are on the card)
        self.grids = [
            min(resident_blocks(device), -(-work // THREADS))
            for work in (self.roots, max(self.roots, list_capacity))
        ]
        self.scratch = torch.empty(
            self.grids[1] * THREADS * frame_capacity * FRAME_INTS,
            dtype=torch.int32, device=device,
        )
        self.lists = [torch.empty((list_capacity, ENTRY_INTS),
                                  dtype=torch.int32, device=device)
                      for _ in range(2)]
        self.root_nodes = torch.zeros(self.roots, dtype=torch.int32,
                                      device=device)
        rows = index.rank_rows
        self.args = (
            None if rows is None else rows.data_ptr(),
            index.fwd.occ.data_ptr(), index.fwd.planes.data_ptr(),
            index.rev.occ.data_ptr(), index.rev.planes.data_ptr(),
            int(index.rev_block_offset), index.C.data_ptr(), int(index.n),
            patterns.data_ptr(), S, L, seed_class.data_ptr(),
            scheme.data_ptr(), num_searches, num_parts, key_words,
            report_capacity, self.reports.data_ptr(),
            self.counters.data_ptr(), self.scratch.data_ptr(),
            frame_capacity, budget,
        )
        # the operands stay alive as long as the launch can run
        self.operands = (index, patterns, seed_class, scheme)

    def launch(self) -> None:
        """Every generation of the search, on the current stream."""
        self.start()
        if self.roots == 0:
            return
        while True:
            self.enqueue(GENERATIONS_A_BATCH)
            last = self.generations[(self.launches - 1) % 2, 1]
            overflow, spilled = torch.stack((self.counters[1], last)).tolist()
            if overflow or not spilled:
                break

    def start(self) -> None:
        """Zero the counters and the root counts, on the stream."""
        self.launches = 0
        self.counters.zero_()
        if self.roots:
            self.root_nodes.zero_()

    def enqueue(self, generations: int) -> None:
        """Launch the next `generations` generations (no
        synchronization): each reads the count the one before spilled."""
        global LAUNCHES, SPILL_LAUNCHES
        stream = torch.cuda.current_stream(self.device).cuda_stream
        with torch.cuda.device(self.device):
            for _ in range(generations):
                g = self.launches
                self.generations[g % 2].zero_()
                before = self.generations[(g - 1) % 2]
                launch("floxer_workqueue_search", *self.args,
                       self.lists[(g - 1) % 2].data_ptr(),
                       before[1].data_ptr() if g else None,
                       self.generations[g % 2].data_ptr(),
                       self.lists[g % 2].data_ptr(), self.list_capacity,
                       self.root_nodes.data_ptr(), self.grids[g > 0],
                       stream)
                LAUNCHES += 1
                SPILL_LAUNCHES += g > 0
                self.launches += 1

    def result(self):
        from ..search_queue import QueueRun

        count, overflow, _, nodes, largest, spilled, peak = (
            self.counters.tolist()
        )
        return QueueRun(
            self.reports,
            min(count, self.report_capacity),
            bool(overflow) or count > self.report_capacity,
            nodes,
            largest,
            spilled,
            self.launches,
            peak,
        )


def workqueue_search_cuda(index, patterns, seed_class, scheme, num_searches,
                          num_parts, report_capacity, key_words,
                          frame_capacity, budget=BUDGET, list_capacity=None):
    """K10 on CUDA operands: patterns int32 [S, L], seed_class int32 [S],
    the fused scheme rows int32 [classes * searches * parts, 8]. One
    launch a generation, at most `budget` nodes a unit of work, work lists
    of `list_capacity` entries (list_entries(roots) unless given); returns
    a search_queue.QueueRun. Overflow: reports past report_capacity, a
    path deeper than 8 * key_words nibbles, a stack past frame_capacity
    frames or a generation's spilled entries past a list's capacity."""
    run = WorkqueueLaunch(index, patterns, seed_class, scheme, num_searches,
                          num_parts, report_capacity, key_words,
                          frame_capacity, budget, list_capacity)
    run.launch()
    return run.result()
