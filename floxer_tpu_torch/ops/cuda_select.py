"""K12: anchor selection on the card (FLOXER_TPU_DEVICE_SELECT).

Counterpart of floxer_tpu/search_select_device.py's _select_kernel. The
kernel (csrc/select_anchors.cu) runs one warp for 32 seeds (a lane a seed
of at most one valid emission, the whole warp for each larger one, the
locates of the warp's emissions side by side) and gives what
search_select_device.select_plain, its plain version, gives:
the anchors [S, soft_cap, 3] (every slot written, zeros included) and the
counts [S, 5]. The locate of each chosen SA row is K9l's walk as a device
function inside it (its SA samples through the index's sampled-row
plane), so a selection is one launch. This wrapper takes CUDA
tensors only
(search_select_device.select_anchors runs the plain version for CPU
tensors); it does not synchronize.
"""

from __future__ import annotations

import torch

from ..alphabet import SIGMA
from ._build import check_operand, launch
from .cuda_fm_index import check_sample_plane

SOURCE = "floxer_tpu_torch/csrc/select_anchors.cu"
REPLACES = "floxer_tpu/search_select_device.py:73"
# warps a block (32 seeds a warp); the int32 arrays a warp keeps: of
# soft_cap, the columns of the seed it expands, and of the batch size
# (max(BATCH_MIN, soft_cap)), its batch of emissions; and the shared
# memory a block may take without an opt-in
WARPS = 8
SEEDS_PER_WARP = 32
COLUMN_ARRAYS = 5
BATCH_ARRAYS = 6
BATCH_MIN = 64
SHARED_LIMIT = 48 * 1024
# kernel launches in this process (read and reset by chip_smoke.py)
LAUNCHES = 0


def warp_words(soft_cap: int) -> int:
    """The int32 words of a warp's rows."""
    return (COLUMN_ARRAYS * soft_cap
            + BATCH_ARRAYS * max(BATCH_MIN, soft_cap))


def shared_bytes(soft_cap: int) -> int:
    """A block's shared memory for its warps' rows, or 0 when they do not
    fit SHARED_LIMIT and go to global scratch instead."""
    needed = WARPS * warp_words(soft_cap) * 4
    return needed if needed <= SHARED_LIMIT else 0


def _check_operands(index, lb, cnt, err, gid, perm, group_starts, totals,
                    statuses, soft_cap):
    device = lb.device
    if device.type != "cuda":
        raise ValueError(f"a CUDA kernel got operands on {device}")
    if soft_cap < 1:
        raise ValueError(f"soft_cap must be at least 1, got {soft_cap}")
    G = lb.shape[0]
    S = totals.shape[0]
    for tensor, name in ((lb, "lb"), (cnt, "cnt"), (err, "err"),
                         (gid, "gid"), (perm, "perm")):
        check_operand(tensor, name, (G,), torch.int32, device)
    check_operand(group_starts, "group_starts", (S + 1,), torch.int32, device)
    check_operand(totals, "totals", (S,), torch.int32, device)
    check_operand(statuses, "statuses", (S,), torch.int32, device)
    fwd = index.fwd
    check_operand(index.C, "C", (SIGMA + 1,), torch.int32, device)
    check_operand(fwd.bwt, "bwt", (fwd.bwt.shape[0],), torch.uint8, device)
    check_sample_plane(index, device)
    if fwd.rank_rows is not None:
        check_operand(fwd.rank_rows, "rank_rows",
                      (fwd.rank_rows.shape[0], 32), torch.int32, device)
    else:
        nb = fwd.planes.shape[0]
        check_operand(fwd.occ, "occ", (nb + 1, SIGMA), torch.int32, device)
        check_operand(fwd.planes, "planes", (nb, SIGMA, 4), torch.int32,
                      device)


def select_anchors_cuda(index, lb, cnt, err, gid, perm, group_starts, totals,
                        statuses, hard_cap, soft_cap, order_code,
                        choice_code, erase_useless):
    """K12 on CUDA operands (select_plain's arguments; the kernel reads
    each seed's groups from group_starts, so gid must be their seeds, and
    the permutation carries order_code): one launch, returns (anchors
    int32 [S, soft_cap, 3], counts int32 [S, 5])."""
    global LAUNCHES
    del order_code
    _check_operands(index, lb, cnt, err, gid, perm, group_starts, totals,
                    statuses, soft_cap)
    device = lb.device
    S = totals.shape[0]
    anchors = torch.empty((S, soft_cap, 3), dtype=torch.int32, device=device)
    counts = torch.empty((S, 5), dtype=torch.int32, device=device)
    if S == 0:
        return anchors, counts
    smem = shared_bytes(soft_cap)
    warps = -(-S // SEEDS_PER_WARP)
    scratch = None if smem else torch.empty(
        warps * warp_words(soft_cap), dtype=torch.int32, device=device
    )
    fwd = index.fwd
    with torch.cuda.device(device):
        launch(
            "floxer_select_anchors",
            None if fwd.rank_rows is None else fwd.rank_rows.data_ptr(),
            fwd.occ.data_ptr(), fwd.planes.data_ptr(), fwd.bwt.data_ptr(),
            index.C.data_ptr(), index.sample_plane.data_ptr(),
            index.sampled_values.data_ptr(), index.n,
            index.seq_starts.data_ptr(), index.seq_starts.shape[0],
            int(index.sampling_rate), lb.data_ptr(), cnt.data_ptr(),
            err.data_ptr(), perm.data_ptr(), group_starts.data_ptr(),
            totals.data_ptr(), statuses.data_ptr(), S, int(hard_cap),
            int(soft_cap), int(choice_code), 1 if erase_useless else 0,
            anchors.data_ptr(), counts.data_ptr(),
            None if scratch is None else scratch.data_ptr(), smem,
            torch.cuda.current_stream(device).cuda_stream,
        )
    LAUNCHES += 1
    return anchors, counts
