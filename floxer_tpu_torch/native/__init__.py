# Copied from floxer_tpu/native/__init__.py; builds this package's copy of
# the C++ sources (csrc/) into its own library.
"""Native (C++) components, loaded via ctypes with graceful fallbacks.

The shared library is compiled on demand with g++ from csrc/*.cpp into
build/floxer_tpu_torch_native/ at the repository root; environments
without a toolchain silently fall back to the pure numpy implementations.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

logger = logging.getLogger("floxer-tpu")

_NATIVE_DIR = Path(__file__).parent / "csrc"
_BUILD_DIR = (
    Path(__file__).resolve().parents[2] / "build" / "floxer_tpu_torch_native"
)
_LIB_PATH = _BUILD_DIR / "libfloxer_native.so"
_SOURCES = [
    _NATIVE_DIR / "sais.cpp",
    _NATIVE_DIR / "search.cpp",
    _NATIVE_DIR / "traceback.cpp",
    _NATIVE_DIR / "cachescan.cpp",
    _NATIVE_DIR / "myers_host.cpp",
    _NATIVE_DIR / "pextree.cpp",
]

_lib = None
_load_attempted = False


def _build_library() -> bool:
    try:
        newest_source = max(s.stat().st_mtime for s in _SOURCES)
        if _LIB_PATH.exists() and _LIB_PATH.stat().st_mtime >= newest_source:
            return True
        # compile to a per-process temp path and rename atomically:
        # concurrent processes (pytest spawning aligner subprocesses) must
        # never dlopen a half-written library
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp_path = _LIB_PATH.with_suffix(f".tmp{os.getpid()}.so")
        command = [
            "g++", "-O3", "-march=native", "-std=c++17",
            "-shared", "-fPIC",
            *[str(s) for s in _SOURCES],
            "-o", str(tmp_path),
        ]
        result = subprocess.run(command, capture_output=True, text=True)
        if result.returncode != 0:
            logger.debug("native build failed: %s", result.stderr)
            tmp_path.unlink(missing_ok=True)
            return False
        os.replace(tmp_path, _LIB_PATH)
        return True
    except Exception as error:  # noqa: BLE001
        logger.debug("native build unavailable: %s", error)
        return False


def get_library():
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    if os.environ.get("FLOXER_TPU_NO_NATIVE"):
        return None
    if not _build_library():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.floxer_build_suffix_array.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.floxer_build_suffix_array.restype = ctypes.c_int
        lib.floxer_build_suffix_array_inplace.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.floxer_build_suffix_array_inplace.restype = ctypes.c_int
        i64p = ctypes.POINTER(ctypes.c_int64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.floxer_search_seed.argtypes = [
            u8p, u8p, i64p, ctypes.c_int64,  # packed index + C + n
            u8p,  # pattern
            i64p, ctypes.c_int64, ctypes.c_int64,  # scheme
            ctypes.c_int64, ctypes.c_int64,  # caps
            i64p, i64p,  # outputs
        ]
        lib.floxer_search_seed.restype = ctypes.c_int
        lib.floxer_search_stats.argtypes = [i64p, ctypes.c_int64]
        lib.floxer_search_stats.restype = None
        lib.floxer_stage_ns.argtypes = [i64p, ctypes.c_int64]
        lib.floxer_stage_ns.restype = None
        lib.floxer_sort_groups_probe.argtypes = [
            i64p, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.floxer_banded_traceback.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            i64p, u8p, ctypes.c_int64, i64p,
        ]
        lib.floxer_banded_traceback.restype = ctypes.c_int
        lib.floxer_banded_traceback_rle.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64,
            i64p,  # out begin
            u8p, ctypes.c_int64,  # scratch ops
            i64p, u8p, ctypes.c_int64, i64p,  # RLE counts/chars/cap/out runs
            u8p, ctypes.c_int64, i64p,  # string buffer/cap/out len
        ]
        lib.floxer_banded_traceback_rle.restype = ctypes.c_int
        lib.floxer_search_seeds_batch.argtypes = [
            u8p, u8p, i64p, ctypes.c_int64,  # packed index + C + n
            u8p, ctypes.c_int64, ctypes.c_int64,  # patterns
            i64p, ctypes.c_int64, ctypes.c_int64,  # scheme
            ctypes.c_int64, ctypes.c_int64,  # caps
            i64p, i64p,  # outputs
            ctypes.c_int64,  # threads
        ]
        lib.floxer_search_seeds_batch.restype = ctypes.c_int
        lib.floxer_search_select_batch.argtypes = [
            u8p, u8p, i64p, ctypes.c_int64,  # packed index + C + n
            i64p, i64p, ctypes.c_int64,  # sampled SA
            i64p, ctypes.c_int64,  # seq starts
            u8p, ctypes.c_int64, ctypes.c_int64,  # patterns
            i64p, ctypes.c_int64, ctypes.c_int64,  # scheme
            ctypes.c_int64, ctypes.c_int64,  # max_total, max_groups
            ctypes.c_int64, ctypes.c_int64,  # hard, soft
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # order/choice/erase
            i64p, i64p,  # out anchors, counts
            ctypes.c_int64,  # threads
        ]
        lib.floxer_search_select_batch.restype = ctypes.c_int
        lib.floxer_search_select_batch_offsets.argtypes = [
            u8p, u8p, i64p, ctypes.c_int64,  # packed index + C + n
            i64p, i64p, ctypes.c_int64,  # sampled SA
            i64p, ctypes.c_int64,  # seq starts
            u8p, i64p, ctypes.c_int64,  # pattern buffer/offsets/count
            i64p, ctypes.c_int64, ctypes.c_int64,  # scheme
            ctypes.c_int64, ctypes.c_int64,  # max_total, max_groups
            ctypes.c_int64, ctypes.c_int64,  # hard, soft
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # order/choice/erase
            i64p, i64p,  # out anchors, counts
            ctypes.c_int64,  # threads
        ]
        lib.floxer_search_select_batch_offsets.restype = ctypes.c_int
        lib.floxer_select_from_groups_batch.argtypes = [
            u8p, i64p, ctypes.c_int64,  # packed fwd index + C + n (locate only)
            i64p, i64p, ctypes.c_int64,  # sampled SA
            i64p, ctypes.c_int64,  # seq starts
            i64p, i64p, i64p, i64p, ctypes.c_int64,  # groups/starts/totals/statuses/count
            ctypes.c_int64, ctypes.c_int64,  # hard, soft
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # order/choice/erase
            i64p, i64p,  # out anchors, counts
            ctypes.c_int64,  # threads
        ]
        lib.floxer_select_from_groups_batch.restype = ctypes.c_int
        lib.floxer_locate_batch.argtypes = [
            u8p, i64p, ctypes.c_int64,  # packed fwd index + C + n
            i64p, i64p, ctypes.c_int64,  # sampled SA
            i64p, ctypes.c_int64,  # rows
            i64p,  # out positions
            ctypes.c_int64,  # threads
        ]
        lib.floxer_locate_batch.restype = ctypes.c_int
        lib.floxer_cache_scan.argtypes = [
            i64p, i64p, ctypes.c_int64,  # segments
            i64p,  # sorted walk ids
            i64p, i64p, i64p, i64p,  # trim lo/hi, insert lo/hi
            u8p, ctypes.c_int64, u8p,  # state, enabled, out flags
        ]
        lib.floxer_cache_scan.restype = ctypes.c_int64
        lib.floxer_myers_distance_batch.argtypes = [
            u8p, i64p, i64p,  # window buffer/offsets/lengths
            u8p, i64p, i64p,  # pattern buffer/offsets/lengths
            i64p,  # budgets (-1 = always full-state)
            ctypes.c_int64,  # num tasks
            i64p, i64p,  # out distance, end
            ctypes.c_int64,  # threads
        ]
        lib.floxer_myers_distance_batch.restype = ctypes.c_int
        lib.floxer_build_pex_tree.argtypes = [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i64p, ctypes.c_int64,  # inner rows, capacity
            i64p, ctypes.c_int64,  # leaf rows, capacity
            i64p, i64p,  # out counts
        ]
        lib.floxer_build_pex_tree.restype = ctypes.c_int
        _lib = lib
    except (OSError, AttributeError) as error:
        # AttributeError: a stale libfloxer_native.so (fresh mtime, old
        # build, e.g. touched/copied without rebuild) missing a symbol must
        # degrade to the pure-Python path, not crash every native entry.
        logger.debug("native library load failed: %s", error)
        _lib = None
    return _lib


def search_stats(reset: bool = False):
    """(occ_all_calls, occ_pair_calls, dfs_steps) from the native DFS
    counters — meaningful only when FLOXER_TPU_SEARCH_STATS was set
    before the first search (the counters are opt-in, search.cpp:26-35).
    Returns None without the native library."""
    lib = get_library()
    if lib is None:
        return None
    out = np.zeros(3, dtype=np.int64)
    lib.floxer_search_stats(_as_i64p(out), ctypes.c_int64(1 if reset else 0))
    return tuple(int(v) for v in out)


def stage_ns(reset: bool = False):
    """(worker_ns, select_ns) summed across select-batch worker threads;
    only accumulated when FLOXER_TPU_SEARCH_STATS is set. None without
    the native library."""
    lib = get_library()
    if lib is None:
        return None
    out = np.zeros(2, dtype=np.int64)
    lib.floxer_stage_ns(_as_i64p(out), ctypes.c_int64(1 if reset else 0))
    return tuple(int(v) for v in out)


def _as_i64p(array: np.ndarray):
    return array.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _as_u8p(array: np.ndarray):
    return array.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def native_search_seed(
    index,  # floxer_tpu.index.fmindex.FmIndex
    pattern: np.ndarray,
    expanded_searches,  # tuple[schemes.ExpandedSearch]
    max_total: int,
):
    """Native scheme-DFS seed search; returns (groups, total, aborted) with
    byte-identical group order to search_host's Python DFS, or None when the
    native library is unavailable or the pattern length exceeds the scheme."""
    lib = get_library()
    if lib is None:
        return None

    num_searches = len(expanded_searches)
    num_parts = len(expanded_searches[0].pi)
    parts_flat = np.empty(num_searches * num_parts * 5, dtype=np.int64)
    pos = 0
    for search in expanded_searches:
        for j in range(num_parts):
            start, end = search.part_spans[j]
            parts_flat[pos : pos + 5] = (
                start,
                end,
                search.directions[j],
                search.lower[j],
                search.upper[j],
            )
            pos += 5

    # every reported group adds >= 1 to the total, so max_total bounds the
    # group count; clamp for unbounded probes (overflow falls back to Python)
    max_groups = int(min(max_total, 1_000_000)) + 8
    out_groups = np.empty(max_groups * 4, dtype=np.int64)
    out_meta = np.zeros(2, dtype=np.int64)

    pattern = np.ascontiguousarray(pattern, dtype=np.uint8)
    packed_fwd = index.fwd.packed_rows()
    packed_rev = index.rev.packed_rows()
    C = np.ascontiguousarray(index.C, dtype=np.int64)

    status = lib.floxer_search_seed(
        _as_u8p(packed_fwd),
        _as_u8p(packed_rev),
        _as_i64p(C),
        ctypes.c_int64(index.n),
        _as_u8p(pattern),
        _as_i64p(parts_flat),
        ctypes.c_int64(num_searches),
        ctypes.c_int64(num_parts),
        ctypes.c_int64(max_total),
        ctypes.c_int64(max_groups),
        _as_i64p(out_groups),
        _as_i64p(out_meta),
    )
    if status & 2:  # group buffer overflow: let the Python DFS handle it
        return None
    num_groups = int(out_meta[0])
    total = int(out_meta[1])
    aborted = bool(status & 1)
    groups = out_groups[: num_groups * 4].reshape(num_groups, 4)
    return groups, total, aborted


def _pack_scheme(expanded_searches):
    num_searches = len(expanded_searches)
    num_parts = len(expanded_searches[0].pi)
    parts_flat = np.empty(num_searches * num_parts * 5, dtype=np.int64)
    pos = 0
    for search in expanded_searches:
        for j in range(num_parts):
            start, end = search.part_spans[j]
            parts_flat[pos : pos + 5] = (
                start,
                end,
                search.directions[j],
                search.lower[j],
                search.upper[j],
            )
            pos += 5
    return parts_flat, num_searches, num_parts


def native_search_seeds_batch(
    index,
    patterns: np.ndarray,  # uint8 [num_seeds, pattern_len], uniform length
    expanded_searches,
    max_total: int,
    num_threads: int = 1,
):
    """Batched native scheme-DFS over uniform-length seeds; returns
    (list_of_(groups_array, total, aborted) or None per seed), or None when
    the native library is unavailable."""
    lib = get_library()
    if lib is None:
        return None

    parts_flat, num_searches, num_parts = _pack_scheme(expanded_searches)
    num_seeds, pattern_len = patterns.shape
    max_groups = int(min(max_total, 1_000_000)) + 8
    out_groups = np.empty(num_seeds * max_groups * 4, dtype=np.int64)
    out_meta = np.zeros(num_seeds * 3, dtype=np.int64)
    patterns = np.ascontiguousarray(patterns, dtype=np.uint8)

    packed_fwd = index.fwd.packed_rows()
    packed_rev = index.rev.packed_rows()
    C = np.ascontiguousarray(index.C, dtype=np.int64)

    lib.floxer_search_seeds_batch(
        _as_u8p(packed_fwd),
        _as_u8p(packed_rev),
        _as_i64p(C),
        ctypes.c_int64(index.n),
        _as_u8p(patterns),
        ctypes.c_int64(pattern_len),
        ctypes.c_int64(num_seeds),
        _as_i64p(parts_flat),
        ctypes.c_int64(num_searches),
        ctypes.c_int64(num_parts),
        ctypes.c_int64(max_total),
        ctypes.c_int64(max_groups),
        _as_i64p(out_groups),
        _as_i64p(out_meta),
        ctypes.c_int64(num_threads),
    )

    results = []
    for i in range(num_seeds):
        num_groups = int(out_meta[i * 3])
        total = int(out_meta[i * 3 + 1])
        status = int(out_meta[i * 3 + 2])
        if status & 2:
            results.append(None)  # overflow: caller falls back
            continue
        rows = out_groups[
            i * max_groups * 4 : i * max_groups * 4 + num_groups * 4
        ].reshape(num_groups, 4)
        results.append((rows.copy(), total, bool(status & 1)))
    return results


def native_search_select_batch(
    index,
    patterns: np.ndarray,  # uint8 [num_seeds, pattern_len], uniform length
    expanded_searches,
    max_total: int,
    hard_cap: int,
    soft_cap: int,
    group_order: int,  # 0 count_first, 1 errors_first, 2 none
    choice: int,  # 0 round_robin, 1 full_groups, 2 first_reported
    erase_useless: bool,
    num_threads: int = 1,
):
    """Combined native DFS + anchor selection (search.cpp:143-324 pipeline)
    per seed; returns (anchors_int64 [num_seeds, soft_cap, 3],
    counts_int64 [num_seeds, 5]) or None when the library is unavailable.
    counts rows are (status, num_written, num_kept_raw, num_kept_useful,
    total_raw); status bit 1 set means the caller must redo that seed."""
    lib = get_library()
    if lib is None:
        return None

    parts_flat, num_searches, num_parts = _pack_scheme(expanded_searches)
    num_seeds, pattern_len = patterns.shape
    max_groups = int(min(max_total, 1_000_000)) + 8
    out_anchors = np.empty(num_seeds * soft_cap * 3, dtype=np.int64)
    out_counts = np.zeros(num_seeds * 5, dtype=np.int64)
    patterns = np.ascontiguousarray(patterns, dtype=np.uint8)

    lib.floxer_search_select_batch(
        _as_u8p(index.fwd.packed_rows()),
        _as_u8p(index.rev.packed_rows()),
        _as_i64p(np.ascontiguousarray(index.C, dtype=np.int64)),
        ctypes.c_int64(index.n),
        _as_i64p(np.ascontiguousarray(index.sampled_rows)),
        _as_i64p(np.ascontiguousarray(index.sampled_values)),
        ctypes.c_int64(index.sampled_rows.shape[0]),
        _as_i64p(np.ascontiguousarray(index.seq_starts)),
        ctypes.c_int64(index.seq_starts.shape[0]),
        _as_u8p(patterns),
        ctypes.c_int64(pattern_len),
        ctypes.c_int64(num_seeds),
        _as_i64p(parts_flat),
        ctypes.c_int64(num_searches),
        ctypes.c_int64(num_parts),
        ctypes.c_int64(max_total),
        ctypes.c_int64(max_groups),
        ctypes.c_int64(hard_cap),
        ctypes.c_int64(soft_cap),
        ctypes.c_int64(group_order),
        ctypes.c_int64(choice),
        ctypes.c_int64(1 if erase_useless else 0),
        _as_i64p(out_anchors),
        _as_i64p(out_counts),
        ctypes.c_int64(num_threads),
    )
    return (
        out_anchors.reshape(num_seeds, soft_cap, 3),
        out_counts.reshape(num_seeds, 5),
    )


def native_locate_batch(
    index, rows: np.ndarray, num_threads: int = 1
) -> np.ndarray | None:
    """Text positions for a batch of BWT rows (the FmIndex.text_position LF
    walk, natively); None when the library is unavailable."""
    lib = get_library()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    out = np.empty(rows.shape[0], dtype=np.int64)
    lib.floxer_locate_batch(
        _as_u8p(index.fwd.packed_rows()),
        _as_i64p(np.ascontiguousarray(index.C, dtype=np.int64)),
        ctypes.c_int64(index.n),
        _as_i64p(np.ascontiguousarray(index.sampled_rows)),
        _as_i64p(np.ascontiguousarray(index.sampled_values)),
        ctypes.c_int64(index.sampled_rows.shape[0]),
        _as_i64p(rows),
        ctypes.c_int64(rows.shape[0]),
        _as_i64p(out),
        ctypes.c_int64(num_threads),
    )
    return out


_OP_CHARS = "=XID"


def native_banded_traceback(
    reference: np.ndarray, query: np.ndarray, end_col: int, distance: int
):
    """Native banded CIGAR traceback; (begin, Cigar) or None if unavailable.

    The C++ side run-length-encodes the op walk and formats the SAM CIGAR
    string in the same call (floxer_banded_traceback_rle) — per-op/per-run
    Python loops here were a measured hotspot of the output stage."""
    lib = get_library()
    if lib is None:
        return None
    from ..cigar import Cigar

    reference = np.ascontiguousarray(reference, dtype=np.uint8)
    query = np.ascontiguousarray(query, dtype=np.uint8)
    m = query.shape[0]
    max_ops = m + max(distance, 0) + 8
    scratch_ops = np.empty(max_ops, dtype=np.uint8)
    out_begin = np.zeros(1, dtype=np.int64)
    out_counts = np.empty(max_ops, dtype=np.int64)
    out_op_chars = np.empty(max_ops, dtype=np.uint8)
    out_num_runs = np.zeros(1, dtype=np.int64)
    max_str = 21 * max_ops + 8
    out_str = np.empty(max_str, dtype=np.uint8)
    out_str_len = np.zeros(1, dtype=np.int64)
    status = lib.floxer_banded_traceback_rle(
        _as_u8p(reference),
        ctypes.c_int64(reference.shape[0]),
        _as_u8p(query),
        ctypes.c_int64(m),
        ctypes.c_int64(end_col),
        ctypes.c_int64(distance),
        _as_i64p(out_begin),
        _as_u8p(scratch_ops),
        ctypes.c_int64(max_ops),
        _as_i64p(out_counts),
        _as_u8p(out_op_chars),
        ctypes.c_int64(max_ops),
        _as_i64p(out_num_runs),
        _as_u8p(out_str),
        ctypes.c_int64(max_str),
        _as_i64p(out_str_len),
    )
    if status != 0:
        return None
    runs = int(out_num_runs[0])
    cigar = Cigar(
        out_counts[:runs].copy(),
        out_op_chars[:runs].copy(),
        out_str[: int(out_str_len[0])].tobytes().decode("ascii"),
    )
    return int(out_begin[0]), cigar


def native_suffix_array(text: np.ndarray) -> np.ndarray | None:
    """SA-IS suffix array via the native library; None if unavailable.

    Builds in place in an (n+1)-entry buffer and returns the [1..n] VIEW,
    so no second 8n-byte array ever exists (genome-scale builds peak at
    text + one index array + n bits; see sais.cpp)."""
    lib = get_library()
    if lib is None:
        return None
    text = np.ascontiguousarray(text, dtype=np.uint8)
    n = text.shape[0]
    buf = np.empty(n + 1, dtype=np.int64)
    status = lib.floxer_build_suffix_array_inplace(
        text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(n),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if status != 0:
        return None
    return buf[1:]


def native_cache_scan(
    seg_begin: np.ndarray,
    seg_end: np.ndarray,
    sorted_ids: np.ndarray,
    trim_lo: np.ndarray,
    trim_hi: np.ndarray,
    ins_lo: np.ndarray,
    ins_hi: np.ndarray,
    state: np.ndarray,
    enabled: bool,
):
    """Verified-interval cache scan (cachescan.cpp) over walk arrays.

    Returns (need_count, out_flags) where out_flags is a per-walk uint8
    array: 0 avoided (covered by a CONFIRMED interval, or covered at all
    for already-computed walks), 1 needed, 2 passed through, 4 avoided but
    AT RISK (an uncomputed walk whose coverage rests only on optimistic
    insertions — it becomes needed if those walks break; used for cascade
    speculation). None when the library is unavailable. Semantics are
    asserted against the Python two-cache mirror by
    tests/test_cachescan.py."""
    lib = get_library()
    if lib is None:
        return None
    num_walks = state.shape[0]
    out_flags = np.full(num_walks, 255, dtype=np.uint8)
    need = lib.floxer_cache_scan(
        _as_i64p(np.ascontiguousarray(seg_begin, dtype=np.int64)),
        _as_i64p(np.ascontiguousarray(seg_end, dtype=np.int64)),
        ctypes.c_int64(seg_begin.shape[0]),
        _as_i64p(np.ascontiguousarray(sorted_ids, dtype=np.int64)),
        _as_i64p(np.ascontiguousarray(trim_lo, dtype=np.int64)),
        _as_i64p(np.ascontiguousarray(trim_hi, dtype=np.int64)),
        _as_i64p(np.ascontiguousarray(ins_lo, dtype=np.int64)),
        _as_i64p(np.ascontiguousarray(ins_hi, dtype=np.int64)),
        _as_u8p(np.ascontiguousarray(state, dtype=np.uint8)),
        ctypes.c_int64(1 if enabled else 0),
        _as_u8p(out_flags),
    )
    if need < 0:
        return None
    return int(need), out_flags


def native_search_select_batch_offsets(
    index,
    pattern_buffer: np.ndarray,  # uint8, chunk's concatenated sequences
    pattern_offsets: np.ndarray,  # int64 [num_seeds], byte offsets
    expanded_searches,
    max_total: int,
    hard_cap: int,
    soft_cap: int,
    group_order: int,
    choice: int,
    erase_useless: bool,
    num_threads: int = 1,
):
    """floxer_search_select_batch over buffer-offset patterns: all seeds of
    one (length, errors) class across a whole chunk in a single call.
    Returns (anchors_int64 [num_seeds, soft_cap, 3], counts_int64
    [num_seeds, 5]) or None when the library is unavailable."""
    lib = get_library()
    if lib is None:
        return None

    parts_flat, num_searches, num_parts = _pack_scheme(expanded_searches)
    num_seeds = pattern_offsets.shape[0]
    max_groups = int(min(max_total, 1_000_000)) + 8
    out_anchors = np.empty(num_seeds * soft_cap * 3, dtype=np.int64)
    out_counts = np.zeros(num_seeds * 5, dtype=np.int64)
    pattern_buffer = np.ascontiguousarray(pattern_buffer, dtype=np.uint8)
    pattern_offsets = np.ascontiguousarray(pattern_offsets, dtype=np.int64)

    lib.floxer_search_select_batch_offsets(
        _as_u8p(index.fwd.packed_rows()),
        _as_u8p(index.rev.packed_rows()),
        _as_i64p(np.ascontiguousarray(index.C, dtype=np.int64)),
        ctypes.c_int64(index.n),
        _as_i64p(np.ascontiguousarray(index.sampled_rows)),
        _as_i64p(np.ascontiguousarray(index.sampled_values)),
        ctypes.c_int64(index.sampled_rows.shape[0]),
        _as_i64p(np.ascontiguousarray(index.seq_starts)),
        ctypes.c_int64(index.seq_starts.shape[0]),
        _as_u8p(pattern_buffer),
        _as_i64p(pattern_offsets),
        ctypes.c_int64(num_seeds),
        _as_i64p(parts_flat),
        ctypes.c_int64(num_searches),
        ctypes.c_int64(num_parts),
        ctypes.c_int64(max_total),
        ctypes.c_int64(max_groups),
        ctypes.c_int64(hard_cap),
        ctypes.c_int64(soft_cap),
        ctypes.c_int64(group_order),
        ctypes.c_int64(choice),
        ctypes.c_int64(1 if erase_useless else 0),
        _as_i64p(out_anchors),
        _as_i64p(out_counts),
        ctypes.c_int64(num_threads),
    )
    return (
        out_anchors.reshape(num_seeds, soft_cap, 3),
        out_counts.reshape(num_seeds, 5),
    )


def native_select_from_groups_batch(
    index,
    groups_flat: np.ndarray,  # int64 [total_groups, 4] (lb, lb_rev, len, err)
    group_starts: np.ndarray,  # int64 [num_seeds + 1] seed-major offsets
    totals: np.ndarray,  # int64 [num_seeds] raw anchor totals
    statuses: np.ndarray,  # int64 [num_seeds] DFS status bits (0 = clean)
    hard_cap: int,
    soft_cap: int,
    group_order: int,
    choice: int,
    erase_useless: bool,
    num_threads: int = 1,
):
    """Anchor selection from externally discovered groups (the device
    frontier search): same outputs as native_search_select_batch_offsets —
    (anchors int64 [num_seeds, soft_cap, 3], counts int64 [num_seeds, 5]) —
    or None when the library is unavailable."""
    lib = get_library()
    if lib is None:
        return None

    num_seeds = group_starts.shape[0] - 1
    out_anchors = np.empty(num_seeds * soft_cap * 3, dtype=np.int64)
    out_counts = np.zeros(num_seeds * 5, dtype=np.int64)
    groups_flat = np.ascontiguousarray(groups_flat, dtype=np.int64)
    group_starts = np.ascontiguousarray(group_starts, dtype=np.int64)
    totals = np.ascontiguousarray(totals, dtype=np.int64)
    statuses = np.ascontiguousarray(statuses, dtype=np.int64)

    lib.floxer_select_from_groups_batch(
        _as_u8p(index.fwd.packed_rows()),
        _as_i64p(np.ascontiguousarray(index.C, dtype=np.int64)),
        ctypes.c_int64(index.n),
        _as_i64p(np.ascontiguousarray(index.sampled_rows)),
        _as_i64p(np.ascontiguousarray(index.sampled_values)),
        ctypes.c_int64(index.sampled_rows.shape[0]),
        _as_i64p(np.ascontiguousarray(index.seq_starts)),
        ctypes.c_int64(index.seq_starts.shape[0]),
        _as_i64p(groups_flat),
        _as_i64p(group_starts),
        _as_i64p(totals),
        _as_i64p(statuses),
        ctypes.c_int64(num_seeds),
        ctypes.c_int64(hard_cap),
        ctypes.c_int64(soft_cap),
        ctypes.c_int64(group_order),
        ctypes.c_int64(choice),
        ctypes.c_int64(1 if erase_useless else 0),
        _as_i64p(out_anchors),
        _as_i64p(out_counts),
        ctypes.c_int64(num_threads),
    )
    return (
        out_anchors.reshape(num_seeds, soft_cap, 3),
        out_counts.reshape(num_seeds, 5),
    )


def native_sort_groups_probe(
    counts: np.ndarray, errors: np.ndarray, order_code: int
) -> np.ndarray | None:
    """Test probe: libstdc++ std::sort permutation of (count, errors) rows
    under the reference's literal group-order comparators."""
    lib = get_library()
    if lib is None:
        return None
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    errors = np.ascontiguousarray(errors, dtype=np.int64)
    out = np.zeros(len(counts), dtype=np.int32)
    lib.floxer_sort_groups_probe(
        _as_i64p(counts),
        _as_i64p(errors),
        ctypes.c_int64(len(counts)),
        ctypes.c_int64(order_code),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def native_myers_distance_batch(
    windows: list[np.ndarray],
    patterns: list[np.ndarray],
    num_threads: int = 1,
    budgets=None,
):
    """Batched host Myers semi-global distance (myers_host.cpp).

    Returns (distance int64 [T], end_col int64 [T]) with the exact
    semantics of ops/dp_reference.semi_global_dp_matrix + _rightmost_argmin
    (optimum = rightmost minimal end column, flush column excluded); None
    when the library is unavailable. When budgets[i] >= 0 and the exactness
    band is narrower than the pattern, the banded sliding-window variant
    runs instead (output-equivalent for every value the pipeline consumes,
    ops/myers_banded.py)."""
    lib = get_library()
    if lib is None:
        return None
    T = len(windows)
    win_lens = np.fromiter((len(w) for w in windows), count=T, dtype=np.int64)
    pat_lens = np.fromiter((len(p) for p in patterns), count=T, dtype=np.int64)
    win_offsets = np.zeros(T, dtype=np.int64)
    np.cumsum(win_lens[:-1], out=win_offsets[1:])
    pat_offsets = np.zeros(T, dtype=np.int64)
    np.cumsum(pat_lens[:-1], out=pat_offsets[1:])
    win_buffer = (
        np.concatenate([np.ascontiguousarray(w, dtype=np.uint8) for w in windows])
        if T
        else np.zeros(0, dtype=np.uint8)
    )
    pat_buffer = (
        np.concatenate([np.ascontiguousarray(p, dtype=np.uint8) for p in patterns])
        if T
        else np.zeros(0, dtype=np.uint8)
    )
    out_distance = np.zeros(T, dtype=np.int64)
    out_end = np.zeros(T, dtype=np.int64)
    if budgets is None:
        budget_arr = np.full(T, -1, dtype=np.int64)
    else:
        budget_arr = np.ascontiguousarray(budgets, dtype=np.int64)
    status = lib.floxer_myers_distance_batch(
        _as_u8p(win_buffer),
        _as_i64p(win_offsets),
        _as_i64p(win_lens),
        _as_u8p(pat_buffer),
        _as_i64p(pat_offsets),
        _as_i64p(pat_lens),
        _as_i64p(budget_arr),
        ctypes.c_int64(T),
        _as_i64p(out_distance),
        _as_i64p(out_end),
        ctypes.c_int64(num_threads),
    )
    if status != 0:
        return None
    return out_distance, out_end


def native_build_pex_tree(
    total_query_length: int,
    query_num_errors: int,
    leaf_max_num_errors: int,
    strategy: int,
) -> tuple[np.ndarray, np.ndarray] | None:
    """PEX tree construction in C++ (pextree.cpp), byte-identical node
    arrays to the Python object builder (rows: parent, from, to, errors).

    Returns (inner [Ni, 4], leaves [Nl, 4]) int64 arrays or None when the
    library is unavailable or the capacity heuristic overflows (caller
    falls back to the Python builder)."""
    lib = get_library()
    if lib is None:
        return None
    cap = 2 * (query_num_errors + 2) + 8
    inner = np.empty((cap, 4), dtype=np.int64)
    leaves = np.empty((cap, 4), dtype=np.int64)
    num_inner = np.zeros(1, dtype=np.int64)
    num_leaves = np.zeros(1, dtype=np.int64)
    status = lib.floxer_build_pex_tree(
        ctypes.c_int64(total_query_length),
        ctypes.c_int64(query_num_errors),
        ctypes.c_int64(leaf_max_num_errors),
        ctypes.c_int64(strategy),
        _as_i64p(inner),
        ctypes.c_int64(cap),
        _as_i64p(leaves),
        ctypes.c_int64(cap),
        _as_i64p(num_inner),
        _as_i64p(num_leaves),
    )
    if status != 0:
        return None
    return (
        inner[: int(num_inner[0])].copy(),
        leaves[: int(num_leaves[0])].copy(),
    )
