// K12: anchor selection on the device, a warp 32 seeds.
//
// Replaces floxer_tpu/search_select_device.py's _select_kernel (:73), the
// XLA program behind FLOXER_TPU_DEVICE_SELECT: for each seed, the status
// bits and the hard-cap exclusion (skipped by first_reported), the first
// soft_cap groups of the seed in the host-computed order, the emissions
// (round robin by rounds over the groups with count > r, or rows in group
// order for full_groups and first_reported), the locate of each emitted
// SA row (fm_locate_row, K9l's LF walk, as a device function), the stable
// order by (reference, position, emission), or (reference, emission)
// without erase, with invalid slots last, the dominance sweep with its
// retroactive pivot marks, and the compaction of the survivors. The
// output equals the reference's on groups of non-negative counts (SA
// interval lengths), and the native select's on the groups the search
// produces.
//
// A seed's valid emissions are a prefix e < E of its soft_cap slots: E =
// min(kept_raw, the rows of its first soft_cap groups, each at most
// soft_cap) under round robin, and kept_raw under full_groups and
// first_reported when a group counts a row (an emission past the groups'
// rows stays valid there, as in the reference), else 0. They sort before
// every invalid slot, so the kernel works on the E valid ones only, and
// a warp gathers its 32 seeds' emissions into one batch so that their
// locates, the latency that sets the kernel's time, run side by side:
//   - the warp first writes zeros over its 32 seeds' anchor rows,
//     coalesced (the wrapper allocates them empty);
//   - each lane takes its own seed's status, total and groups, writes
//     its counts row, and tells E = 0, E = 1 and E >= 2 apart; a seed
//     with E = 1 puts its one emission into the batch (round robin: the
//     first group that counts a row; the others: column 0, whatever it
//     counts, as the reference's formula gives);
//   - the warp then expands each seed with E >= 2, one after another,
//     into the batch: a round robin round is a ballot of the live columns
//     with count > r (an emission's index is the round's base plus the
//     popcount of the lanes below), full_groups a warp scan of the row
//     prefix and a binary search per emission;
//   - the lanes locate the batch's rows, a lane a row; an E = 1 seed's
//     lane writes its anchor, and each E >= 2 seed takes the warp again:
//     each key's rank among its E (stable by emission), lane 0's
//     dominance sweep over the E sorted keys (its retroactive marks need
//     the order), and a ballot compaction of the survivors.
// A batch holds max(64, soft_cap) emissions; a seed that does not fit
// starts the next batch, so most warps locate once.
// A warp's rows (the expanded seed's 5 int32 arrays of soft_cap, the
// batch's 6 of its size) lie in shared memory while a block's 8 warps fit
// 48 KB (soft_cap <= 139; ops/cuda_select.py decides), else in global
// scratch, one row set a warp.
//
// What bounds it on an H100: bytes, the anchor array written once (S x
// soft_cap x 3 int32, 69 MB on a 115k-seed chunk at soft cap 50); its
// operations are ~60 int32 ops an emitted anchor beside its locate (at
// most sampling_rate - 1 dependent LF steps of one rank each, a lookup in
// the sampled-row plane before each step and at the end, and a binary
// search of the sequence starts; chip_smoke.py's SELECT_OPS). The zeros go out as
// 16-byte stores of consecutive lanes; the locates' dependent gathers are
// latency-bound, and a warp runs up to 32 of them at once.

#include <cuda_runtime.h>

#include <cstdint>

#include "fm_rank.cuh"

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xFFFFFFFFu;
// status bits of counts[:, 0]
constexpr int kStatusOverflow = 2;
constexpr int kStatusExcluded = 4;
// a batch holds at least this many emissions (two locates a lane)
constexpr int kBatchMin = 64;
// the int32 arrays a warp keeps, in this order: of soft_cap, the columns
// of the seed it expands (lb, count, errors, row prefix, group index);
// of the batch size, the batch's emissions (SA row, errors, reference,
// position, sorted order, mark)
enum { cLb, cCnt, cErr, cAux, cCol, kColumnArrays };
enum { bRow, bErr, bRef, bPos, bOrder, bMark, kBatchArrays };

struct Params {
  FmLocateTables locate;
  const int* lb;            // [G]
  const int* cnt;           // [G]
  const int* err;           // [G]
  const int* perm;          // [G], a permutation within each seed's groups
  const int* group_starts;  // [S + 1]
  const int* totals;        // [S]
  const int* statuses;      // [S]
  int num_seeds, hard_cap, soft_cap, choice_code, erase_useless;
  int* anchors;  // [S, soft_cap, 3], written whole (zeros included)
  int* counts;   // [S, 5]
  int* scratch;  // [warps, warp_words] or null (shared memory)
};

__device__ inline int warp_inclusive_sum(int value, int lane) {
#pragma unroll
  for (int shift = 1; shift < 32; shift <<= 1) {
    const int other = __shfl_up_sync(kFull, value, shift);
    if (lane >= shift) value += other;
  }
  return value;
}

__device__ inline int warp_sum(int value) {
#pragma unroll
  for (int shift = 16; shift > 0; shift >>= 1) {
    value += __shfl_xor_sync(kFull, value, shift);
  }
  return value;
}

// a seed of E >= 2 on the whole warp (every lane calls these with the
// same arguments): its live columns, the seed's first min(groups,
// soft_cap) groups in the given order (the reference's others count 0
// and never emit), into `cols`; returns E
__device__ __forceinline__ int load_columns(const Params& p, int* cols,
                                            int lane, int first, int live,
                                            int kept_raw) {
  const int CAP = p.soft_cap;
  int* d_lb = cols + cLb * CAP;
  int* d_cnt = cols + cCnt * CAP;
  int* d_err = cols + cErr * CAP;
  for (int c = lane; c < live; c += 32) {
    const int g = p.perm[first + c];
    d_lb[c] = p.lb[g];
    d_cnt[c] = p.cnt[g];
    d_err[c] = p.err[g];
  }
  __syncwarp();
  if (p.choice_code == 0) {
    // round robin: E = min(kept_raw, the rows of the live columns, each
    // at most soft_cap)
    int rows_here = 0;  // at most soft_cap a lane, so the sum fits
    for (int c = lane; c < live; c += 32) {
      const int n = d_cnt[c];
      rows_here += n < 0 ? 0 : (n > CAP ? CAP : n);
      rows_here = rows_here < CAP ? rows_here : CAP;
    }
    const int total_rows = warp_sum(rows_here);
    return kept_raw < total_rows ? kept_raw : total_rows;
  }
  // full_groups / first_reported: each column's row prefix and its group
  // index, the counting columns up to it less one (a column index, as the
  // reference uses it); the prefix sums counts capped at soft_cap and
  // saturates there, which changes no comparison with an e below soft_cap
  int* aux = cols + cAux * CAP;
  int* col = cols + cCol * CAP;
  const unsigned upto = 0xFFFFFFFFu >> (31 - lane);
  int carry = 0, counting = 0;
  for (int c0 = 0; c0 < live; c0 += 32) {
    const int c = c0 + lane;
    int n = c < live ? d_cnt[c] : 0;
    n = n < 0 ? 0 : (n > CAP ? CAP : n);
    const int inclusive = warp_inclusive_sum(n, lane);
    const unsigned nonzero = __ballot_sync(kFull, n > 0);
    if (c < live) {
      aux[c] = carry + inclusive - n;
      col[c] = counting + __popc(nonzero & upto) - 1;
    }
    carry += __shfl_sync(kFull, inclusive, 31);
    carry = carry < CAP ? carry : CAP;
    counting += __popc(nonzero);
  }
  __syncwarp();
  return kept_raw;
}

// the seed's E emissions (SA row, errors) from its columns
__device__ __forceinline__ void emit(const Params& p, const int* cols,
                                     int* em_row, int* em_err, int lane,
                                     int live, int E) {
  const int CAP = p.soft_cap;
  const int* d_lb = cols + cLb * CAP;
  const int* d_cnt = cols + cCnt * CAP;
  const int* d_err = cols + cErr * CAP;
  if (p.choice_code == 0) {
    // round r's emissions are the columns with count > r in order,
    // placed after the earlier rounds'
    const unsigned below = (1u << lane) - 1u;
    int base = 0;
    for (int r = 0; base < E; ++r) {
      for (int c0 = 0; c0 < live; c0 += 32) {
        const int c = c0 + lane;
        const bool take = c < live && d_cnt[c] > r;
        const unsigned taken = __ballot_sync(kFull, take);
        if (take) {
          const int e = base + __popc(taken & below);
          if (e < E) {
            em_row[e] = d_lb[c] + r;
            em_err[e] = d_err[c];
          }
        }
        base += __popc(taken);
      }
    }
  } else {
    // emission e's group index: that of the last column whose prefix is
    // at most e (the prefixes rise: counts are non-negative; column 0's
    // is 0)
    const int* aux = cols + cAux * CAP;
    const int* col = cols + cCol * CAP;
    for (int e = lane; e < E; e += 32) {
      const int g = col[fm_upper_bound(aux, live, e) - 1];
      em_row[e] = d_lb[g] + (e - aux[g]);
      em_err[e] = d_err[g];
    }
  }
}

// a located seed of E >= 2 whose keys lie at [off, off + E) of the
// batch, on the whole warp: its order, sweep and output; returns the
// anchors written
__device__ __forceinline__ int finish_seed(const Params& p, int* batch,
                                           int size, int lane, int off,
                                           int E, int kept_raw, int* out) {
  const int* ref = batch + bRef * size + off;
  const int* pos = batch + bPos * size + off;
  const int* em_err = batch + bErr * size + off;
  int* order = batch + bOrder * size + off;
  int* mark = batch + bMark * size + off;
  // stable order: each key's rank among the E keys, ties by emission
  const bool by_pos = p.erase_useless != 0;
  for (int e = lane; e < E; e += 32) {
    const int my_ref = ref[e], my_pos = pos[e];
    int rank = 0;
    for (int f = 0; f < E; ++f) {
      const int f_ref = ref[f];
      const bool less =
          f_ref < my_ref ||
          (f_ref == my_ref &&
           ((by_pos && pos[f] < my_pos) ||
            ((!by_pos || pos[f] == my_pos) && f < e)));
      rank += less;
    }
    order[rank] = e;
  }
  __syncwarp();
  if (!p.erase_useless) {
    for (int c = lane; c < E; c += 32) {
      const int a = order[c];
      out[3 * c] = ref[a];
      out[3 * c + 1] = pos[a];
      out[3 * c + 2] = em_err[a];
    }
    return kept_raw;
  }
  if (lane == 0) {
    // dominance sweep over the sorted keys, segments reset at reference
    // changes; a follower the pivot does not dominate may mark the pivot
    // back and becomes the new pivot
    int p_ref = -1, p_pos = 0, p_err = 0, p_idx = 0;
    bool p_live = false;
    for (int c = 0; c < E; ++c) {
      const int a = order[c];
      const int a_ref = ref[a], a_pos = pos[a], a_err = em_err[a];
      const bool same_seg = p_live && a_ref == p_ref;
      const int d = p_pos > a_pos ? p_pos - a_pos : a_pos - p_pos;
      const bool piv_dominates =
          same_seg && p_err <= a_err && d <= a_err - p_err;
      const bool a_dominates =
          same_seg && a_err <= p_err && d <= p_err - a_err;
      if (piv_dominates) mark[c] = 1;
      if (same_seg && !piv_dominates && a_dominates) mark[p_idx] = 1;
      if (!same_seg || !piv_dominates) {
        p_ref = a_ref;
        p_pos = a_pos;
        p_err = a_err;
        p_idx = c;
      }
      p_live = true;
    }
  }
  __syncwarp();
  // the survivors, in order, to the front
  const unsigned below = (1u << lane) - 1u;
  int written = 0;
  for (int c0 = 0; c0 < E; c0 += 32) {
    const int c = c0 + lane;
    const bool keep = c < E && mark[c] == 0;
    const unsigned kept = __ballot_sync(kFull, keep);
    if (keep) {
      const int a = order[c];
      int* slot = out + 3 * (written + __popc(kept & below));
      slot[0] = ref[a];
      slot[1] = pos[a];
      slot[2] = em_err[a];
    }
    written += __popc(kept);
  }
  return written;
}

__global__ void __launch_bounds__(kWarps * 32) select_kernel(Params p) {
  extern __shared__ int shared_rows[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long warp_id = (long long)blockIdx.x * kWarps + warp;
  const long long first_seed = warp_id * 32;
  if (first_seed >= p.num_seeds) return;
  const int seeds = p.num_seeds - first_seed < 32
                        ? (int)(p.num_seeds - first_seed)
                        : 32;
  const int CAP = p.soft_cap;
  const int size = CAP > kBatchMin ? CAP : kBatchMin;
  const int warp_words = kColumnArrays * CAP + kBatchArrays * size;
  int* cols = p.scratch != nullptr ? p.scratch + warp_id * warp_words
                                   : shared_rows + warp * warp_words;
  int* batch = cols + kColumnArrays * CAP;
  int* em_row = batch + bRow * size;
  int* em_err = batch + bErr * size;
  const unsigned below = (1u << lane) - 1u;

  // ---- zeros over the warp's anchor rows (contiguous; 16-byte aligned,
  // as 32 seeds' rows are a multiple of 16 bytes)
  int* block_out = p.anchors + first_seed * CAP * 3;
  const int words = seeds * CAP * 3;
  int4* out4 = reinterpret_cast<int4*>(block_out);
  for (int i = lane; i < words / 4; i += 32) out4[i] = make_int4(0, 0, 0, 0);
  for (int i = (words & ~3) + lane; i < words; i += 32) block_out[i] = 0;
  __syncwarp();

  // ---- each lane's seed: status, caps, and how many emissions it has
  const int seed = (int)first_seed + lane;
  const bool mine = lane < seeds;
  int status = 0, total = 0, kept_raw = 0, first = 0, live = 0;
  if (mine) {
    total = p.totals[seed];
    const bool excluded = total > p.hard_cap && p.choice_code != 2;
    status = p.statuses[seed] | (excluded ? kStatusExcluded : 0);
    const bool seed_ok =
        (status & (kStatusOverflow | kStatusExcluded)) == 0;
    kept_raw = seed_ok ? (total < CAP ? total : CAP) : 0;
    first = p.group_starts[seed];
    const int groups = p.group_starts[seed + 1] - first;
    live = groups < CAP ? groups : CAP;
  }
  // E = 0 without a counting column; E >= 2 (large) when kept_raw >= 2
  // and, under round robin, the counting columns hold two rows
  int counting_col = -1;
  bool large = false;
  if (kept_raw > 0) {
    for (int c = 0; c < live; ++c) {
      const int n = p.cnt[p.perm[first + c]];
      if (n <= 0) continue;
      if (counting_col >= 0) {
        large = true;  // round robin: a second counting column
        break;
      }
      counting_col = c;
      if (kept_raw == 1) break;
      if (p.choice_code != 0 || n >= 2) {
        large = true;
        break;
      }
    }
  }
  int* counts_row = p.counts + (size_t)seed * 5;
  if (mine) {
    // a large seed's anchors written under erase come after its sweep
    const int written =
        p.erase_useless ? (counting_col >= 0 ? 1 : 0) : kept_raw;
    counts_row[0] = status;
    counts_row[1] = written;
    counts_row[2] = kept_raw;
    counts_row[3] = written;
    counts_row[4] = total;
  }

  // ---- the first batch: each E = 1 seed's emission
  const bool single = counting_col >= 0 && !large;
  unsigned in_batch = __ballot_sync(kFull, single);
  int off = 0, mine_E = 0;
  if (single) {
    off = __popc(in_batch & below);
    mine_E = 1;
    const int g =
        p.perm[first + (p.choice_code == 0 ? counting_col : 0)];
    em_row[off] = p.lb[g];
    em_err[off] = p.err[g];
  }
  int fill = __popc(in_batch);

  unsigned pending = __ballot_sync(kFull, large);
  for (;;) {
    // ---- the E >= 2 seeds, expanded into the batch while they fit
    while (pending != 0) {
      const int owner = __ffs(pending) - 1;
      const int s_first = __shfl_sync(kFull, first, owner);
      const int s_live = __shfl_sync(kFull, live, owner);
      const int s_kept = __shfl_sync(kFull, kept_raw, owner);
      const int E = load_columns(p, cols, lane, s_first, s_live, s_kept);
      if (fill + E > size) break;  // the next batch's first seed
      emit(p, cols, em_row + fill, em_err + fill, lane, s_live, E);
      if (lane == owner) {
        off = fill;
        mine_E = E;
      }
      in_batch |= 1u << owner;
      fill += E;
      pending &= pending - 1;
      __syncwarp();  // the columns are the next seed's
    }
    __syncwarp();

    // ---- the batch's locates, a lane a row
    int* ref = batch + bRef * size;
    int* pos = batch + bPos * size;
    int* mark = batch + bMark * size;
    for (int e = lane; e < fill; e += 32) {
      int seq, position;
      fm_locate_row(p.locate, em_row[e], &seq, &position);
      ref[e] = seq;
      pos[e] = position;
      mark[e] = 0;
    }
    __syncwarp();

    // ---- the outputs: an E = 1 seed's by its lane, the others' on the
    // warp one after another
    const bool here = (in_batch >> lane) & 1;
    if (here && mine_E == 1) {
      int* slot = p.anchors + (size_t)seed * CAP * 3;
      slot[0] = ref[off];
      slot[1] = pos[off];
      slot[2] = em_err[off];
    }
    unsigned larges = __ballot_sync(kFull, here && mine_E >= 2);
    while (larges != 0) {
      const int owner = __ffs(larges) - 1;
      larges &= larges - 1;
      const int s_off = __shfl_sync(kFull, off, owner);
      const int s_E = __shfl_sync(kFull, mine_E, owner);
      const int s_kept = __shfl_sync(kFull, kept_raw, owner);
      const int written = finish_seed(
          p, batch, size, lane, s_off, s_E, s_kept,
          p.anchors + ((size_t)first_seed + owner) * CAP * 3);
      if (lane == owner && p.erase_useless) {
        counts_row[1] = written;
        counts_row[3] = written;
      }
      __syncwarp();
    }
    if (pending == 0) break;
    in_batch = 0;
    fill = 0;
  }
}

}  // namespace

extern "C" {

// rows: the forward combined rank table, or null for the planes layout
// (occ, planes); sample_plane: the locate's sampled-row plane of the n
// rows (fm_rank.cuh); scratch: null to keep each warp's rows in shared memory
// (shared_bytes a block), else [ceil(S / 32), 5 * soft_cap + 6 *
// max(64, soft_cap)] int32
int floxer_select_anchors(
    const void* rows, const void* occ, const void* planes, const void* bwt,
    const void* C, const void* sample_plane, const void* sampled_values,
    int n, const void* seq_starts, int num_seqs, int sampling_rate,
    const void* lb, const void* cnt, const void* err, const void* perm,
    const void* group_starts, const void* totals, const void* statuses,
    int num_seeds, int hard_cap, int soft_cap, int choice_code,
    int erase_useless, void* anchors, void* counts, void* scratch,
    int shared_bytes, void* stream) {
  Params p;
  p.locate.fwd.rows = static_cast<const uint32_t*>(rows);
  p.locate.fwd.occ = static_cast<const int32_t*>(occ);
  p.locate.fwd.planes = static_cast<const uint32_t*>(planes);
  p.locate.fwd.row_offset = 0;
  p.locate.bwt = static_cast<const uint8_t*>(bwt);
  p.locate.C = static_cast<const int*>(C);
  p.locate.sample_plane = static_cast<const uint32_t*>(sample_plane);
  p.locate.sampled_values = static_cast<const int*>(sampled_values);
  p.locate.n = n;
  p.locate.seq_starts = static_cast<const int*>(seq_starts);
  p.locate.num_seqs = num_seqs;
  p.locate.sampling_rate = sampling_rate;
  p.lb = static_cast<const int*>(lb);
  p.cnt = static_cast<const int*>(cnt);
  p.err = static_cast<const int*>(err);
  p.perm = static_cast<const int*>(perm);
  p.group_starts = static_cast<const int*>(group_starts);
  p.totals = static_cast<const int*>(totals);
  p.statuses = static_cast<const int*>(statuses);
  p.num_seeds = num_seeds;
  p.hard_cap = hard_cap;
  p.soft_cap = soft_cap;
  p.choice_code = choice_code;
  p.erase_useless = erase_useless;
  p.anchors = static_cast<int*>(anchors);
  p.counts = static_cast<int*>(counts);
  p.scratch = static_cast<int*>(scratch);
  const int warps = (num_seeds + 31) / 32;
  const int blocks = (warps + kWarps - 1) / kWarps;
  select_kernel<<<blocks, kWarps * 32, shared_bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
