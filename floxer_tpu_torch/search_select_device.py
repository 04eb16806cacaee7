"""Counterpart of floxer_tpu/search_select_device.py: anchor selection on
the device (FLOXER_TPU_DEVICE_SELECT).

Given the device search's deduplicated, DFS-ordered anchor GROUPS per
seed, select as native/search.cpp's select_one does:
  - the hard-cap seed exclusion (skipped by first_reported),
  - the group order (count_first / errors_first / none), as a per-seed
    permutation computed on the host by utils/introsort.py's replica of
    std::sort, so ties land where the native select puts them,
  - the anchor choice (round_robin, or full_groups / first_reported: rows
    in group order) up to the soft cap,
  - the locate of every chosen SA row (index/device_index's bounded LF
    walk),
  - the stable order by (reference, position, emission), or by
    (reference, emission) without erase, and the erase-useless dominance
    sweep with its retroactive pivot marks.
A group ranked at or past the soft cap in its seed's order can never emit
before the cap binds, so only the first soft_cap groups of each seed are
read. The output equals native_select_from_groups_batch's.

select_plain is the reference's _select_kernel in torch ops; on the card
the selection is K12 (ops/cuda_select.py, csrc/select_anchors.cu, one warp
a seed). select_anchors picks by the operands' device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import tracing
from .index.device_index import locate_batch

# counts[:, 0] status bits, matching native/search.cpp select_one
_STATUS_OVERFLOW = 2
_STATUS_EXCLUDED = 4

_I32MAX = 2**31 - 1
# SA rows a locate of the plain version takes at once (its rank gathers
# hold 256 bytes a row)
_LOCATE_BATCH = 1 << 20


def select_plain(
    index,
    lb,  # int32 [G] group SA lower bound (fwd)
    cnt,  # int32 [G] group size (cursor length)
    err,  # int32 [G] group error count
    gid,  # int32 [G] owning seed, ascending
    perm,  # int32 [G] host-computed group-order permutation (introsort)
    group_starts,  # int32 [S + 1]
    totals,  # int32 [S] raw anchor totals per seed
    statuses,  # int32 [S] incoming status bits
    hard_cap: int,
    soft_cap: int,
    order_code: int,
    choice_code: int,
    erase_useless: bool,
):
    """The reference's _select_kernel in torch ops, on whatever device the
    operands lie: (anchors int32 [S, soft_cap, 3] = reference id,
    position, errors; counts int32 [S, 5] = status, anchors written, kept
    raw, kept useful, totals)."""
    del order_code  # the permutation carries the group order
    device = lb.device
    S = totals.shape[0]
    CAP = soft_cap
    G = lb.shape[0]

    def wide(tensor):
        return tensor.to(torch.int64)

    totals = wide(totals)
    # ---- seed-level status (hard cap; incoming overflow bits) ----
    excluded = (totals > hard_cap) & (choice_code != 2)
    status = wide(statuses) | torch.where(excluded, _STATUS_EXCLUDED, 0)
    seed_ok = (status & (_STATUS_OVERFLOW | _STATUS_EXCLUDED)) == 0

    # ---- dense [S, CAP] table of the first CAP choice-ordered groups ----
    perm = wide(perm)
    lb_s, cnt_s, err_s, gid_s = (wide(t)[perm] for t in (lb, cnt, err, gid))
    rank = torch.arange(G, device=device) - wide(group_starts)[gid_s]
    keep = (rank < CAP) & (gid_s < S)
    slot = torch.where(keep, gid_s * CAP + rank, S * CAP)

    def dense(values):
        out = torch.zeros(S * CAP + 1, dtype=torch.int64, device=device)
        out[slot[keep]] = values[keep]
        return out[:-1].reshape(S, CAP)

    d_lb, d_cnt, d_err = dense(lb_s), dense(cnt_s), dense(err_s)
    kept_raw = torch.where(seed_ok, totals.clamp(max=CAP), 0)

    # ---- emission-centric choice: emission e of a seed resolves to
    # (group g_e, row r_e), SA row = lb[g_e] + r_e ----
    sa_rows = torch.zeros((S, CAP), dtype=torch.int64, device=device)
    em_err = torch.zeros_like(sa_rows)
    em_valid = torch.zeros((S, CAP), dtype=torch.bool, device=device)
    if choice_code == 0:
        # round_robin: round r emits from the groups with cnt > r, in
        # order; n_r of them, s_cum their exclusive running count
        n_rounds = torch.stack(
            [(d_cnt > r).sum(dim=1) for r in range(CAP)], dim=1
        )
        s_cum = torch.cumsum(n_rounds, dim=1) - n_rounds
        for e in range(CAP):
            r = (s_cum <= e).sum(dim=1) - 1
            k = e - s_cum.gather(1, r[:, None])[:, 0]
            mask = d_cnt > r[:, None]
            csum = torch.cumsum(mask.long(), dim=1)
            is_target = mask & (csum == (k + 1)[:, None])
            sa_rows[:, e] = torch.where(is_target, d_lb, 0).sum(dim=1) + r
            em_err[:, e] = torch.where(is_target, d_err, 0).sum(dim=1)
            em_valid[:, e] = is_target.any(dim=1) & (e < kept_raw)
    else:
        # full_groups / first_reported: rows in group order
        prefix = torch.cumsum(d_cnt, dim=1) - d_cnt
        for e in range(CAP):
            g = ((prefix <= e) & (d_cnt > 0)).sum(dim=1) - 1
            g_cl = g.clamp(0, CAP - 1)[:, None]
            row_in_g = e - prefix.gather(1, g_cl)[:, 0]
            sa_rows[:, e] = d_lb.gather(1, g_cl)[:, 0] + row_in_g
            em_err[:, e] = d_err.gather(1, g_cl)[:, 0]
            em_valid[:, e] = (g >= 0) & (e < kept_raw)

    # ---- locate of the chosen SA rows (the others never reach the
    # output: they sort last and are never written) ----
    ref = torch.zeros((S, CAP), dtype=torch.int64, device=device)
    pos = torch.zeros_like(ref)
    chosen = em_valid.nonzero(as_tuple=True)
    chosen_rows = sa_rows[chosen].to(torch.int32)
    located = [locate_batch(index, chosen_rows[at:at + _LOCATE_BATCH])
               for at in range(0, chosen_rows.shape[0], _LOCATE_BATCH)]
    if located:
        ref[chosen] = wide(torch.cat([seq for seq, _ in located]))
        pos[chosen] = wide(torch.cat([at for _, at in located]))

    # ---- final ordering: stable by reference over emission order, then
    # (erase_useless) stable by position within a reference ----
    big_ref = torch.where(em_valid, ref, _I32MAX)  # invalid slots last
    order = torch.arange(CAP, device=device).expand(S, CAP)
    if erase_useless:
        order = torch.sort(pos, dim=1, stable=True).indices
    order = order.gather(1, torch.sort(big_ref.gather(1, order), dim=1,
                                       stable=True).indices)
    ref_o = big_ref.gather(1, order)
    pos_o = pos.gather(1, order)
    err_o = em_err.gather(1, order)
    valid_o = em_valid.gather(1, order)

    if erase_useless:
        # dominance sweep (search.cpp:352-389): a pivot marks the run of
        # followers it dominates; the first non-dominated follower may mark
        # the pivot back (retroactively) and becomes the new pivot
        marked = torch.zeros((S, CAP), dtype=torch.bool, device=device)
        p_ref = torch.full((S,), -1, dtype=torch.int64, device=device)
        p_pos = torch.zeros(S, dtype=torch.int64, device=device)
        p_err = torch.zeros_like(p_pos)
        p_idx = torch.zeros_like(p_pos)
        p_live = torch.zeros(S, dtype=torch.bool, device=device)
        seeds = torch.arange(S, device=device)
        for c in range(CAP):
            a_ref, a_pos, a_err, a_valid = (ref_o[:, c], pos_o[:, c],
                                            err_o[:, c], valid_o[:, c])
            same_seg = a_valid & p_live & (a_ref == p_ref)
            d = (p_pos - a_pos).abs()
            piv_dominates = same_seg & (p_err <= a_err) & (d <= a_err - p_err)
            a_dominates = same_seg & (a_err <= p_err) & (d <= p_err - a_err)
            marked[:, c] |= piv_dominates
            retro = same_seg & ~piv_dominates & a_dominates
            marked[seeds[retro], p_idx[retro]] = True
            handoff = (a_valid & ~same_seg) | (same_seg & ~piv_dominates)
            p_ref = torch.where(handoff, a_ref, p_ref)
            p_pos = torch.where(handoff, a_pos, p_pos)
            p_err = torch.where(handoff, a_err, p_err)
            p_idx = torch.where(handoff, c, p_idx)
            p_live = p_live | a_valid
        survives = valid_o & ~marked
        # compact survivors to the front, preserving order
        comp_rank = torch.cumsum(survives.long(), dim=1) - 1
        target = torch.where(survives, comp_rank, CAP)
        out = torch.zeros((S, CAP + 1, 3), dtype=torch.int64, device=device)
        rows3 = torch.stack([ref_o, pos_o, err_o], dim=-1)
        seed_rows = seeds[:, None].expand(S, CAP)
        out[seed_rows[survives], target[survives]] = rows3[survives]
        anchors = out[:, :CAP]
        num_written = survives.sum(dim=1)
        kept_useful = num_written
    else:
        anchors = torch.stack([ref_o, pos_o, err_o], dim=-1)
        anchors = torch.where(valid_o[:, :, None], anchors, 0)
        num_written = kept_raw
        kept_useful = kept_raw

    counts = torch.stack(
        [status, num_written, kept_raw, kept_useful, totals], dim=1
    )
    return anchors.to(torch.int32), counts.to(torch.int32)


def select_anchors(index, lb, cnt, err, gid, perm, group_starts, totals,
                   statuses, hard_cap, soft_cap, order_code, choice_code,
                   erase_useless):
    """The selection on the operands' device: K12 for CUDA tensors, the
    plain version for CPU tensors (select_plain's arguments and
    results)."""
    if lb.device.type == "cpu":
        return select_plain(index, lb, cnt, err, gid, perm, group_starts,
                            totals, statuses, hard_cap, soft_cap, order_code,
                            choice_code, erase_useless)
    from .ops.cuda_select import select_anchors_cuda

    return select_anchors_cuda(index, lb, cnt, err, gid, perm, group_starts,
                               totals, statuses, hard_cap, soft_cap,
                               order_code, choice_code, erase_useless)


def group_order(groups_flat, group_starts, order_code) -> np.ndarray:
    """int32 [G]: each seed's groups in the native select's order (the
    faithful introsort replica for count_first and errors_first, so ties,
    and the degenerate errors_first predicate, land where std::sort puts
    them; the found order for none)."""
    G = groups_flat.shape[0]
    perm = np.arange(G, dtype=np.int32)
    if order_code in (0, 1):
        from .utils.introsort import (
            count_first_comp,
            errors_first_comp,
            std_sort,
        )

        comp = count_first_comp if order_code == 0 else errors_first_comp
        counts64 = groups_flat[:, 2]
        errs64 = groups_flat[:, 3]
        for s in range(len(group_starts) - 1):
            a, b = int(group_starts[s]), int(group_starts[s + 1])
            if b - a > 1:
                seg = list(range(a, b))
                std_sort(
                    seg,
                    lambda i, j: comp(
                        (counts64[i], errs64[i]), (counts64[j], errs64[j])
                    ),
                )
                perm[a:b] = seg
    return perm


def device_select_from_groups_batch(
    device_index,
    groups_flat: np.ndarray,  # int64 [G, 4] (lb, lb_rev, len, err), canonical
    group_starts: np.ndarray,  # int64 [S + 1]
    totals: np.ndarray,  # int64 [S]
    statuses: np.ndarray,  # int64 [S]
    hard_cap: int,
    soft_cap: int,
    order_code: int,
    choice_code: int,
    erase_useless: bool,
):
    """Drop-in device replacement for native_select_from_groups_batch on
    the index's device: returns (anchors int64 [S, soft_cap, 3], counts
    int64 [S, 5]). The batch goes to the selection as it is (the
    reference pads its shapes to powers of two for its compiler; padding
    seeds and groups change no real seed's result). The host group order
    is the job's span search.device.select_order."""
    S = len(totals)
    G = groups_flat.shape[0]
    if S == 0:
        return (
            np.zeros((0, soft_cap, 3), dtype=np.int64),
            np.zeros((0, 5), dtype=np.int64),
        )
    with tracing.span("search.device.select_order"):
        perm = group_order(groups_flat, group_starts, order_code)
    gid = np.repeat(
        np.arange(S, dtype=np.int32),
        np.diff(group_starts).astype(np.int64),
    )
    device = device_index.device

    def upload(array):
        return torch.from_numpy(
            np.ascontiguousarray(array, dtype=np.int32)
        ).to(device)

    anchors, counts = select_anchors(
        device_index,
        upload(groups_flat[:, 0].reshape(G)),
        upload(groups_flat[:, 2].reshape(G)),
        upload(groups_flat[:, 3].reshape(G)),
        upload(gid),
        upload(perm),
        upload(group_starts),
        upload(np.minimum(totals, _I32MAX)),
        upload(statuses),
        min(int(hard_cap), _I32MAX),
        int(soft_cap),
        int(order_code),
        int(choice_code),
        bool(erase_useless),
    )
    return (anchors.cpu().numpy().astype(np.int64),
            counts.cpu().numpy().astype(np.int64))
