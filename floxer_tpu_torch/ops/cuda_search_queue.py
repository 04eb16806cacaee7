"""K10: the work-queue seed search of --device-search on the card.

Counterpart of floxer_tpu/search_queue.py's _workqueue_search. The kernel
(csrc/workqueue_search.cu) runs one thread per (seed, search) root, an
explicit depth-first search in the host's edge order, and gives the same
set of report rows as search_queue.workqueue_search_plain, its plain
version (rows equal once sorted with search_queue.sort_reports). This
wrapper takes CUDA tensors only: search_queue.workqueue_runner runs the
plain version for an index on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from ..alphabet import SIGMA
from ._build import ALIGNER, check_operand, launch

SOURCE = "floxer_tpu_torch/csrc/workqueue_search.cu"
REPLACES = "floxer_tpu/search_queue.py:90"
# the kernel's block, the key words it holds a thread in shared memory,
# and the int32 fields of one frame of its stack
THREADS = 128
MAX_KEY_WORDS = 16
FRAME_INTS = 20
# slots of the int64 counters the kernel keeps: reports appended, the
# overflow flag, the next root to hand out, nodes expanded, the largest
# tree of one root
_REPORTS, _OVERFLOW, _NEXT_ROOT, _NODES, _LARGEST = range(5)
# kernel launches in this process (read and reset by chip_smoke.py)
LAUNCHES = 0


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


def workqueue_search_cuda(index, patterns, seed_class, scheme, num_searches,
                          num_parts, report_capacity, key_words,
                          frame_capacity):
    """K10 on CUDA operands: patterns int32 [S, L], seed_class int32 [S],
    the fused scheme rows int32 [classes * searches * parts, 8]. Returns a
    search_queue.QueueRun. Overflow: reports past report_capacity, a path
    deeper than 8 * key_words nibbles, or a stack past frame_capacity
    frames."""
    from ..search_queue import QueueRun

    global LAUNCHES
    _check_operands(index, patterns, seed_class, scheme, num_searches,
                    num_parts, key_words)
    device = patterns.device
    S, L = patterns.shape
    roots = S * num_searches
    reports = torch.empty((report_capacity, 6 + key_words), dtype=torch.int32,
                          device=device)
    counters = torch.zeros(8, dtype=torch.int64, device=device)
    if roots == 0:
        return QueueRun(reports, 0, False, 0, 0)
    blocks = min(resident_blocks(device), -(-roots // THREADS))
    scratch = torch.empty(blocks * THREADS * frame_capacity * FRAME_INTS,
                          dtype=torch.int32, device=device)
    rows = index.rank_rows
    with torch.cuda.device(device):
        launch(
            "floxer_workqueue_search",
            None if rows is None else rows.data_ptr(),
            index.fwd.occ.data_ptr(), index.fwd.planes.data_ptr(),
            index.rev.occ.data_ptr(), index.rev.planes.data_ptr(),
            int(index.rev_block_offset), index.C.data_ptr(), int(index.n),
            patterns.data_ptr(), S, L, seed_class.data_ptr(),
            scheme.data_ptr(), num_searches, num_parts, key_words,
            report_capacity, reports.data_ptr(), counters.data_ptr(),
            scratch.data_ptr(), frame_capacity, blocks,
            torch.cuda.current_stream(device).cuda_stream,
        )
    LAUNCHES += 1
    count, overflow, _, nodes, largest = counters[:5].tolist()
    return QueueRun(
        reports,
        min(count, report_capacity),
        bool(overflow) or count > report_capacity,
        nodes,
        largest,
    )
