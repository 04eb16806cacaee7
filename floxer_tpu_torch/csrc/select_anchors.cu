// K12: anchor selection on the device, one warp a seed.
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
// retroactive pivot marks, and the compaction of the survivors. Each step
// follows the reference's formulas literally (every emission's round and
// group are counted over the seed's soft_cap columns), so the output
// equals it on any input, and equals the native select on the groups the
// search produces.
//
// Design: a warp's seed keeps its rows (11 int32 arrays of soft_cap) in
// shared memory, sized at launch from soft_cap while a block's 8 warps
// fit 48 KB (soft_cap <= 139; ops/cuda_select.py decides), else in global
// scratch, one row set a seed. The lanes take the columns and the
// emissions in turn; the prefix sums, the sweep (a sequential scan with
// retroactive marks) and the compaction run on lane 0 in order.
//
// What bounds it on an H100: operations, ~60 int32 ops an emitted anchor
// beside its locate (at most sampling_rate - 1 dependent LF steps of one
// rank each, and two binary searches; chip_smoke.py's SELECT_OPS), the
// emission formulas' soft_cap-long counts included once. The locate's
// dependent rank-row gathers are latency-bound; the lanes of a warp
// locate their emissions side by side, and many warps share an SM.

#include <cuda_runtime.h>

#include <cstdint>

#include "fm_rank.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kInt32Max = 0x7FFFFFFF;
// status bits of counts[:, 0]
constexpr int kStatusOverflow = 2;
constexpr int kStatusExcluded = 4;
// the int32 arrays of soft_cap a seed keeps, in this order
enum { aLb, aCnt, aErr, aAux, aRow, aEmErr, aValid, aRef, aPos, aSorted,
       aMark, kArrays };

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
  int* anchors;  // [S, soft_cap, 3], zeroed by the caller
  int* counts;   // [S, 5]
  int* scratch;  // [S, kArrays * soft_cap] or null (shared memory)
};

// key order of the final sort: (ref, pos, emission) with erase, else
// (ref, emission)
__device__ inline bool key_less(const int* ref, const int* pos, int a,
                                int b, bool by_pos) {
  if (ref[a] != ref[b]) return ref[a] < ref[b];
  if (by_pos && pos[a] != pos[b]) return pos[a] < pos[b];
  return a < b;
}

__global__ void __launch_bounds__(kWarps * 32) select_kernel(Params p) {
  extern __shared__ int shared_rows[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seed = blockIdx.x * kWarps + warp;
  if (seed >= p.num_seeds) return;
  const int CAP = p.soft_cap;
  int* rows = p.scratch != nullptr
                  ? p.scratch + (size_t)seed * kArrays * CAP
                  : shared_rows + warp * kArrays * CAP;
  int* d_lb = rows + aLb * CAP;
  int* d_cnt = rows + aCnt * CAP;
  int* d_err = rows + aErr * CAP;
  int* aux = rows + aAux * CAP;
  int* em_row = rows + aRow * CAP;
  int* em_err = rows + aEmErr * CAP;
  int* em_valid = rows + aValid * CAP;
  int* ref = rows + aRef * CAP;
  int* pos = rows + aPos * CAP;
  int* sorted = rows + aSorted * CAP;
  int* mark = rows + aMark * CAP;

  // ---- seed-level status (hard cap; incoming overflow bits)
  const int total = p.totals[seed];
  const bool excluded = total > p.hard_cap && p.choice_code != 2;
  const int status = p.statuses[seed] | (excluded ? kStatusExcluded : 0);
  const bool seed_ok = (status & (kStatusOverflow | kStatusExcluded)) == 0;
  const int kept_raw = seed_ok ? (total < CAP ? total : CAP) : 0;

  // ---- the first CAP groups of the seed in the given order
  const int first = p.group_starts[seed];
  const int groups = p.group_starts[seed + 1] - first;
  for (int c = lane; c < CAP; c += 32) {
    if (c < groups) {
      const int g = p.perm[first + c];
      d_lb[c] = p.lb[g];
      d_cnt[c] = p.cnt[g];
      d_err[c] = p.err[g];
    } else {
      d_lb[c] = 0;
      d_cnt[c] = 0;
      d_err[c] = 0;
    }
    mark[c] = 0;
  }
  __syncwarp();

  // ---- emissions: emission e resolves to (group, row), SA row = lb + row
  if (p.choice_code == 0) {
    // round robin: aux[r] = the groups with count > r, then their
    // exclusive running count
    for (int r = lane; r < CAP; r += 32) {
      int n = 0;
      for (int c = 0; c < CAP; ++c) n += d_cnt[c] > r;
      aux[r] = n;
    }
    __syncwarp();
    if (lane == 0) {
      int running = 0;
      for (int r = 0; r < CAP; ++r) {
        const int n = aux[r];
        aux[r] = running;
        running += n;
      }
    }
    __syncwarp();
    for (int e = lane; e < CAP; e += 32) {
      int r = -1;
      for (int c = 0; c < CAP; ++c) r += aux[c] <= e;
      const int k = e - aux[r];
      int seen = 0, got = 0, pick_lb = 0, pick_err = 0;
      for (int c = 0; c < CAP; ++c) {
        if (d_cnt[c] > r) {
          ++seen;
          if (seen == k + 1) {
            got = 1;
            pick_lb = d_lb[c];
            pick_err = d_err[c];
          }
        }
      }
      em_row[e] = pick_lb + r;
      em_err[e] = pick_err;
      em_valid[e] = got && e < kept_raw;
    }
  } else {
    // full_groups / first_reported: rows in group order; aux = the
    // exclusive row prefix
    if (lane == 0) {
      int running = 0;
      for (int c = 0; c < CAP; ++c) {
        aux[c] = running;
        running += d_cnt[c];
      }
    }
    __syncwarp();
    for (int e = lane; e < CAP; e += 32) {
      int g = -1;
      for (int c = 0; c < CAP; ++c) g += aux[c] <= e && d_cnt[c] > 0;
      const int g_cl = g < 0 ? 0 : (g > CAP - 1 ? CAP - 1 : g);
      em_row[e] = d_lb[g_cl] + (e - aux[g_cl]);
      em_err[e] = d_err[g_cl];
      em_valid[e] = g >= 0 && e < kept_raw;
    }
  }
  __syncwarp();

  // ---- locate of every chosen SA row; the others sort last
  for (int e = lane; e < CAP; e += 32) {
    int seq = kInt32Max, position = 0;
    if (em_valid[e]) fm_locate_row(p.locate, em_row[e], &seq, &position);
    ref[e] = seq;
    pos[e] = position;
  }
  __syncwarp();

  // ---- stable order: each emission's rank among the keys
  const bool by_pos = p.erase_useless != 0;
  for (int e = lane; e < CAP; e += 32) {
    int rank = 0;
    for (int f = 0; f < CAP; ++f) rank += key_less(ref, pos, f, e, by_pos);
    sorted[rank] = e;
  }
  __syncwarp();

  int* out = p.anchors + (size_t)seed * CAP * 3;
  int num_written;
  if (p.erase_useless) {
    if (lane == 0) {
      // dominance sweep over the sorted columns, segments reset at
      // reference changes; a follower the pivot does not dominate may
      // mark the pivot back and becomes the new pivot
      int p_ref = -1, p_pos = 0, p_err = 0, p_idx = 0;
      bool p_live = false;
      for (int c = 0; c < CAP; ++c) {
        const int a = sorted[c];
        const bool a_valid = em_valid[a] != 0;
        const int a_ref = ref[a], a_pos = pos[a], a_err = em_err[a];
        const bool same_seg = a_valid && p_live && a_ref == p_ref;
        const int d = p_pos > a_pos ? p_pos - a_pos : a_pos - p_pos;
        const bool piv_dominates =
            same_seg && p_err <= a_err && d <= a_err - p_err;
        const bool a_dominates =
            same_seg && a_err <= p_err && d <= p_err - a_err;
        if (piv_dominates) mark[c] = 1;
        if (same_seg && !piv_dominates && a_dominates) mark[p_idx] = 1;
        if ((a_valid && !same_seg) || (same_seg && !piv_dominates)) {
          p_ref = a_ref;
          p_pos = a_pos;
          p_err = a_err;
          p_idx = c;
        }
        p_live = p_live || a_valid;
      }
      // the survivors, in order, to the front
      int written = 0;
      for (int c = 0; c < CAP; ++c) {
        const int a = sorted[c];
        if (em_valid[a] && !mark[c]) {
          out[written * 3] = ref[a];
          out[written * 3 + 1] = pos[a];
          out[written * 3 + 2] = em_err[a];
          ++written;
        }
      }
      mark[0] = written;  // hand the count to the counts row below
    }
    __syncwarp();
    num_written = mark[0];
  } else {
    for (int c = lane; c < CAP; c += 32) {
      const int a = sorted[c];
      if (em_valid[a]) {
        out[c * 3] = ref[a];
        out[c * 3 + 1] = pos[a];
        out[c * 3 + 2] = em_err[a];
      }
    }
    num_written = kept_raw;
  }
  if (lane == 0) {
    int* row = p.counts + (size_t)seed * 5;
    row[0] = status;
    row[1] = num_written;
    row[2] = kept_raw;
    row[3] = num_written;
    row[4] = total;
  }
}

}  // namespace

extern "C" {

// rows: the forward combined rank table, or null for the planes layout
// (occ, planes); scratch: null to keep each seed's rows in shared memory
// (shared_bytes a block), else [S, 11 * soft_cap] int32
int floxer_select_anchors(
    const void* rows, const void* occ, const void* planes, const void* bwt,
    const void* C, const void* sampled_rows, const void* sampled_values,
    int ns, const void* seq_starts, int num_seqs, int sampling_rate,
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
  p.locate.sampled_rows = static_cast<const int*>(sampled_rows);
  p.locate.sampled_values = static_cast<const int*>(sampled_values);
  p.locate.ns = ns;
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
  const int blocks = (num_seeds + kWarps - 1) / kWarps;
  select_kernel<<<blocks, kWarps * 32, shared_bytes, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
