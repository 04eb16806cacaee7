#!/usr/bin/env python3
"""Smoke run of floxer_tpu_torch, the PyTorch/CUDA port, on one NVIDIA
Hopper GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each on stdout, any failure exits non-zero:
  env      a CUDA device of capability >= 9.0; the card's name and power
           limit as nvidia-smi reports them
  build    nvcc builds csrc/*.cu for sm_90a (seconds); the research
           scripts' library (scripts/csrc/*.cu) builds beside it
  kernels  K1/K2/K3 against their plain PyTorch versions on the card on
           seeded cases (exact (dist, end) equality), K1 at the 20 kb root
           shape against the native host engine and the numpy band mirror;
           K4 (banded traceback) against its plain version on 2 root-shape
           tasks and against the host traceback (dp_reference, native) on
           every accepted root of a seeded batch; kernel, plain-version
           and host-pool times
  scripts  the research scripts' kernels K5-K8 (floxer_tpu_torch.scripts):
           every variant against its plain version on the card at
           COMPARE_TEXT columns (exact); K5 full at K1's end columns on
           K1's operands of the kernels phase; every variant timed at the
           scripts' 23040 columns on the entry points' inputs (us/col
           beside K1's at the root shape), K5 full = r4 there, and each
           output there equal to its plain version, run on CPU copies of
           the same inputs in worker processes since the kernels phase
           ended; then the three entry points' main() as a user runs them
           (python -m floxer_tpu_torch.scripts.<name>)
  toy_e2e  python -m floxer_tpu_torch --engine device on tests/data: the
           reference's expected records, empty stdout
  e2e      a simulated E. coli-sized genome (4.6 Mb) with 200 reads of
           20 kb at 7% error: pass A --engine device (every wave fused on
           the CUDA kernels), pass B on the native host engine only; SAM
           files byte-identical, K1-K3 launched in pass A. Pass B is the
           oracle of every pass below.
  traceback  pass C: --engine device with FLOXER_TPU_DEVICE_TRACEBACK=1
           (root CIGARs by K4); SAM = pass B, K4 launched
  legacy   pass D: --engine device with FLOXER_TPU_LEGACY_VERIFY=1 (the
           legacy object path: the bucketed batcher through resident banks
           and host slices); SAM = pass B, K1 and K2/K3 launched
  server   python -m floxer_tpu_torch --serve (jax blocked) and two
           --server --engine device jobs: SAM = pass B, the second job hits
           the resident bank cache; --shutdown-server and the daemon exit 0
  profile  --engine device --profile DIR: a torch.profiler trace naming
           K1's kernel, SAM = pass B
Each path is driven with the launch counts set to 0 just before it and
read just after (server jobs report theirs in their stage split line). The
line before the last is the kernel table as JSON (K1-K3 launches of pass
A, K4 of pass C, K5-K8 of the entry points' run); the last line is
{"ok": true, "device": {...}}.
"""

import contextlib
import functools
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 20261016
# K1 at the PEX root shape of 20 kb reads: tasks, pattern length, budget,
# band words (32-bit)
ROOT_SHAPE = (256, 20600, 1442, 256)
# K4 at the same root shape: tasks of the seeded batch, read error rate
TRACEBACK_TASKS = 128
TRACEBACK_ERROR = 0.066
E2E_READS = 200
# text columns at which K5-K8 are held against their plain versions (the
# plain versions loop over columns in Python, so the scripts' 23040 would
# take minutes); rows and band words are the scripts' own
COMPARE_TEXT = 1280
# processes that run K5-K8's plain versions at the scripts' 23040 columns
# on the CPU while the card runs on, and how long the scripts phase waits
# for them at its end
PLAIN_WORKERS = 4
PLAIN_TIMEOUT = 600
# runs the port's CLI with jax unimportable, as on a machine without jax
JAX_BLOCKED = (
    "import runpy, sys; sys.modules['jax'] = None; "
    "sys.argv = ['floxer_tpu_torch'] + sys.argv[1:]; "
    "runpy.run_module('floxer_tpu_torch', run_name='__main__')"
)


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def check(condition: bool, message: str) -> None:
    if not condition:
        raise SystemExit(f"chip_smoke: FAILED: {message}")


def cuda_ms(fn, repeats: int) -> float:
    """Mean milliseconds of fn() on the card (CUDA events, after one warm
    call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def mutate(rng, seq, rate):
    """Substitutions, insertions and deletions at `rate` per char."""
    import numpy as np

    out = []
    for ch in seq:
        r = rng.random()
        if r < rate / 3:
            out.append(1 + (int(ch) % 4))
        elif r < 2 * rate / 3:
            out.append(int(ch))
            out.append(int(rng.integers(1, 5)))
        elif r >= rate:
            out.append(int(ch))
    return np.asarray(out, dtype=np.uint8)


def small_cases(rng, count, m_lo, m_hi):
    """Seeded (pattern, text) pairs like tests/test_pallas_myers*.py make:
    a text, a mutated slice of it as the pattern."""
    import numpy as np

    patterns, texts = [], []
    for _ in range(count):
        m = int(rng.integers(m_lo, m_hi))
        n = int(rng.integers(m, m + 60))
        text = rng.integers(1, 5, size=n).astype(np.uint8)
        start = int(rng.integers(0, max(1, n - m)))
        pattern = text[start : start + m].copy()
        for _ in range(int(rng.integers(0, 5))):
            pos = int(rng.integers(0, len(pattern)))
            pattern[pos] = 1 + (pattern[pos] % 4)
        patterns.append(pattern)
        texts.append(text)
    return patterns, texts


def pad(seqs, width=None):
    import numpy as np

    width = width or max(len(s) for s in seqs)
    out = np.zeros((len(seqs), width), dtype=np.uint8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out, np.asarray([len(s) for s in seqs], dtype=np.int32)


def run_kernel_phase(device, rng):
    """Each kernel against its plain version on identical card tensors;
    K1 at the root shape against the native engine and the numpy mirror.
    Returns the per-kernel table rows (launch counts filled in later) and
    K1's (operands, end columns) of both K1 checks."""
    import numpy as np
    import torch

    from floxer_tpu.native import native_myers_distance_batch
    from floxer_tpu.ops.myers_banded import myers_banded_np
    from floxer_tpu_torch.ops import cuda_myers, cuda_myers_banded, cuda_myers_large
    from floxer_tpu_torch.ops.cuda_myers_banded import banded_operands
    from floxer_tpu_torch.ops.myers import build_peq_vectorized, u32_tensor

    def to_dev(array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(device)

    def compare(kernel, plain, args):
        got = [t.cpu().numpy() for t in kernel(*args)]
        want = [t.cpu().numpy() for t in plain(*args)]
        err = max(int(np.max(np.abs(g.astype(np.int64) - w))) if len(g) else 0
                  for g, w in zip(got, want))
        return got, want, err

    # ---- K1 inputs (host packers, as the reference's host wrapper does)
    def banded_args(patterns, texts, budgets, band_words):
        texts_u8, lens = pad(texts)
        operands, num_text = banded_operands(
            patterns, texts_u8, lens, np.asarray(budgets), band_words, device
        )
        return (*operands, band_words, num_text)

    rows = {}
    # K1's operands and end columns, which K5 `full` must reproduce
    k1_ends = []
    # K1 seeded small cases (test_pallas_myers_banded.py's generator)
    patterns, texts, budgets = [], [], []
    for _ in range(64):
        m = int(rng.integers(60, 500))
        budget = int(rng.integers(1, max(2, m // 5)))
        n = m + 2 * budget + 1 + int(rng.integers(0, budget + 2))
        text = rng.integers(1, 5, size=n).astype(np.uint8)
        start = int(rng.integers(0, n - m))
        pattern = mutate(rng, text[start : start + m], 0.05)
        if not 0 < budget < len(pattern):
            continue
        patterns.append(pattern)
        texts.append(text)
        budgets.append(budget)
    args = banded_args(patterns, texts, budgets, 128)
    got, _, err_small = compare(
        cuda_myers_banded.myers_banded, cuda_myers_banded.myers_banded_plain, args
    )
    check(err_small == 0, f"K1 differs from its plain version ({err_small})")
    k1_ends.append((args[:5], got[1]))

    # K1 at the 20 kb root shape: T=256, m ~ 20.6k, k = 1442, BW = 256
    T, m_root, k_root, bw_root = ROOT_SHAPE
    genome = rng.integers(1, 5, size=400_000).astype(np.uint8)
    patterns, texts = [], []
    for _ in range(T):
        n = m_root + 2 * k_root + 1 + int(rng.integers(0, 1200))
        start = int(rng.integers(0, len(genome) - n))
        window = genome[start : start + n]
        offset = int(rng.integers(0, n - m_root - k_root))
        patterns.append(
            mutate(rng, window[offset : offset + m_root], 0.05)[:m_root]
        )
        texts.append(window)
    budgets = [k_root] * T
    args = banded_args(patterns, texts, budgets, bw_root)
    got, want, err_root = compare(
        cuda_myers_banded.myers_banded, cuda_myers_banded.myers_banded_plain, args
    )
    check(err_root == 0, f"K1 differs from its plain version at the root "
          f"shape ({err_root})")
    k1_ends.append((args[:5], got[1]))
    native_dist, native_end = native_myers_distance_batch(
        texts, patterns, num_threads=min(8, os.cpu_count() or 1),
        budgets=budgets,
    )
    accepted = native_dist <= k_root
    check(bool(accepted.all()), "root-shape cases must all be within budget")
    check(np.array_equal(got[0], native_dist) and np.array_equal(
        got[1], native_end), "K1 differs from the native engine at the root "
          "shape")
    for i in range(2):  # the numpy band mirror is slow: a subset
        mirror = myers_banded_np(patterns[i], texts[i], k_root)
        check((int(got[0][i]), int(got[1][i])) == mirror,
              f"K1 differs from myers_banded_np on root task {i}")
    k1_ms = cuda_ms(lambda: cuda_myers_banded.myers_banded(*args), 5)
    t0 = time.monotonic()
    cuda_myers_banded.myers_banded_plain(*args)
    torch.cuda.synchronize()
    k1_plain_ms = (time.monotonic() - t0) * 1000
    # the launch lasts as long as its longest task: tlen - 1 columns
    k1_columns = max(len(t) for t in texts) - 1
    rows["K1"] = {
        "name": "myers_banded", "route": "cuda",
        "source": cuda_myers_banded.SOURCE,
        "replaces": cuda_myers_banded.REPLACES,
        "max_abs_err": max(err_small, err_root),
        "ms": k1_ms, "plain_ms": k1_plain_ms,
        "shape": f"T={T} m={m_root} k={k_root} BW={bw_root} "
                 f"n~{m_root + 2 * k_root + 600}",
        "us_per_col": k1_ms * 1000 / k1_columns, "columns": k1_columns,
    }

    # ---- K2 (test_pallas_myers.py's generator, then a timing shape of
    # 2048 inner nodes of 172 chars)
    def small_args(patterns, texts):
        pat, plen = pad(patterns)
        txt, tlen = pad(texts)
        peq = build_peq_vectorized(pat, plen)
        return (
            u32_tensor(np.transpose(peq, (2, 1, 0)), device), to_dev(plen),
            to_dev(txt.astype(np.int32).T), to_dev(tlen),
        )

    patterns, texts = small_cases(rng, 300, 2, 256)
    txt_garbage = [t.copy() for t in texts]
    for t in txt_garbage:
        t[::7] = rng.integers(6, 16, size=len(t[::7]))  # chars past a window
    _, _, err2 = compare(cuda_myers.myers_small, cuda_myers.myers_small_plain,
                         small_args(patterns, txt_garbage))
    check(err2 == 0, f"K2 differs from its plain version ({err2})")
    patterns, texts = small_cases(rng, 2048, 172, 173)
    args2 = small_args(patterns, texts)
    _, _, err2t = compare(cuda_myers.myers_small, cuda_myers.myers_small_plain,
                          args2)
    check(err2t == 0, f"K2 differs from its plain version ({err2t})")
    k2_ms = cuda_ms(lambda: cuda_myers.myers_small(*args2), 20)
    t0 = time.monotonic()
    cuda_myers.myers_small_plain(*args2)
    torch.cuda.synchronize()
    rows["K2"] = {
        "name": "myers_small", "route": "cuda",
        "source": cuda_myers.SOURCE, "replaces": cuda_myers.REPLACES,
        "max_abs_err": max(err2, err2t), "ms": k2_ms,
        "plain_ms": (time.monotonic() - t0) * 1000,
        "shape": "B=2048 m=172 n=172..231",
    }

    # ---- K3 (test_pallas_myers_large.py's generator, then a timing shape
    # of 256 inner nodes of 1376 chars)
    def large_args(patterns, texts, words_padded):
        pat, plen = pad(patterns)
        txt, tlen = pad(texts)
        peq = build_peq_vectorized(pat, plen)
        padded = np.zeros(peq.shape[:2] + (words_padded,), dtype=np.uint32)
        padded[:, :, : peq.shape[2]] = peq
        return (
            u32_tensor(padded, device), to_dev(plen),
            to_dev(txt.astype(np.int32)), to_dev(tlen),
        )

    patterns, texts = small_cases(rng, 64, 257, 4000)
    txt_garbage = [t.copy() for t in texts]
    for t in txt_garbage:
        t[::11] = rng.integers(6, 16, size=len(t[::11]))
    _, _, err3 = compare(cuda_myers_large.myers_large,
                         cuda_myers_large.myers_large_plain,
                         large_args(patterns, txt_garbage, 128))
    check(err3 == 0, f"K3 differs from its plain version ({err3})")
    patterns, texts = small_cases(rng, 256, 1376, 1377)
    args3 = large_args(patterns, texts, 128)
    _, _, err3t = compare(cuda_myers_large.myers_large,
                          cuda_myers_large.myers_large_plain, args3)
    check(err3t == 0, f"K3 differs from its plain version ({err3t})")
    k3_ms = cuda_ms(lambda: cuda_myers_large.myers_large(*args3), 10)
    t0 = time.monotonic()
    cuda_myers_large.myers_large_plain(*args3)
    torch.cuda.synchronize()
    rows["K3"] = {
        "name": "myers_large", "route": "cuda",
        "source": cuda_myers_large.SOURCE,
        "replaces": cuda_myers_large.REPLACES,
        "max_abs_err": max(err3, err3t), "ms": k3_ms,
        "plain_ms": (time.monotonic() - t0) * 1000,
        "shape": "B=256 m=1376 n=1376..1435 Wp=128",
    }
    return rows, k1_ends


def run_traceback_phase(device, rng):
    """K4 at the 20 kb root shape: equal to its plain version on two tasks
    and to the host traceback (native/traceback.cpp through dp_reference)
    on every accepted root of a seeded batch. Returns the table row."""
    import numpy as np
    import torch

    from floxer_tpu.native import native_myers_distance_batch
    from floxer_tpu.ops import dp_reference
    from floxer_tpu_torch.ops import traceback_device as td

    _, m_root, k_root, _ = ROOT_SHAPE
    genome = rng.integers(1, 5, size=400_000).astype(np.uint8)
    windows, patterns = [], []
    for _ in range(TRACEBACK_TASKS):
        n = m_root + 2 * k_root + 1 + int(rng.integers(0, 1200))
        start = int(rng.integers(0, len(genome) - n))
        window = genome[start : start + n]
        offset = int(rng.integers(0, n - m_root - k_root))
        patterns.append(mutate(
            rng, window[offset : offset + m_root], TRACEBACK_ERROR
        )[:m_root])
        windows.append(window)
    dist, end = native_myers_distance_batch(
        windows, patterns, num_threads=min(8, os.cpu_count() or 1)
    )
    tasks = [
        (w, p, int(e), int(d))
        for w, p, e, d in zip(windows, patterns, end, dist)
        if d <= k_root
    ]
    check(len(tasks) >= TRACEBACK_TASKS // 2,
          f"only {len(tasks)} root tasks within the budget")

    # the batched entry on every accepted root against the host pool
    started = time.monotonic()
    got = td.banded_cigar_traceback_device_batch(tasks, device)
    batch_s = time.monotonic() - started
    started = time.monotonic()
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        host = list(pool.map(
            lambda task: dp_reference.banded_cigar_traceback(*task), tasks
        ))
    host_pool_s = time.monotonic() - started
    mismatches = sum(g != h for g, h in zip(got, host))
    check(mismatches == 0, f"K4 differs from the host traceback on "
          f"{mismatches} of {len(tasks)} root tasks")

    # K4 against its plain version on two root-shape tasks (same inputs)
    pair = tasks[:2]
    m_pad = max(td._pad_quantum(len(p), 2048) for _, p, _, _ in pair)
    n_pad = max(td._pad_quantum(len(w), 2048) for w, _, _, _ in pair)
    w_pad = max(td._pad_quantum(2 * d + 1, 256) for _, _, _, d in pair)
    windows2 = np.zeros((2, n_pad), dtype=np.int32)
    patterns2 = np.zeros((2, m_pad), dtype=np.int32)
    scalars = np.zeros((4, 2), dtype=np.int32)
    for s, (w, p, e, d) in enumerate(pair):
        windows2[s, : len(w)] = w
        patterns2[s, : len(p)] = p
        scalars[:, s] = (len(w), len(p), e, d)

    def to_dev(array):
        return torch.from_numpy(np.ascontiguousarray(array)).to(device)

    args = (to_dev(windows2), to_dev(patterns2),
            *(to_dev(row) for row in scalars))
    shape = dict(m_pad=m_pad, w_pad=w_pad, n_pad=n_pad)
    kernel_out = [t.cpu().numpy() for t in
                  td.banded_directions_and_walk(*args, **shape)]
    started = time.monotonic()
    plain_out = [t.cpu().numpy() for t in
                 td.banded_directions_and_walk_plain(*args, **shape)]
    torch.cuda.synchronize()
    plain_ms = (time.monotonic() - started) * 1000
    err = max(int(np.max(np.abs(k.astype(np.int64) - p)))
              for k, p in zip(kernel_out, plain_out))
    check(err == 0, f"K4 differs from its plain version ({err})")
    k4_ms = cuda_ms(lambda: td.banded_directions_and_walk(*args, **shape), 3)
    return {
        "name": "traceback_banded", "route": "cuda",
        "source": td.SOURCE, "replaces": td.REPLACES,
        "max_abs_err": err, "ms": k4_ms, "plain_ms": plain_ms,
        "shape": f"T=2 m={len(pair[0][1])} d={pair[0][3]},{pair[1][3]} "
                 f"m_pad={m_pad} w_pad={w_pad}",
        "host_equal_tasks": len(tasks),
        "batch_s": batch_s, "host_pool_s": host_pool_s,
    }


def script_arrays(num_text):
    """The scripts' seeded inputs at num_text columns, as their entry points
    make them (numpy): K5's operands, the texts of K6-K8, K8's jstar."""
    from floxer_tpu_torch.scripts import ablate_banded_kernel as k5
    from floxer_tpu_torch.scripts import microbench_carry_scaling as k78
    from floxer_tpu_torch.scripts import microbench_column_loop as k6

    return (k5.script_inputs(num_text), k6.script_texts(num_text),
            k78.script_jstar(num_text))


def script_cases(device, arrays):
    """(kernel, label, launch, plain) for every variant of K5-K8 on
    `arrays` (script_arrays) as tensors on `device`."""
    import torch

    from floxer_tpu_torch.scripts import ablate_banded_kernel as k5
    from floxer_tpu_torch.scripts import microbench_carry_scaling as k78
    from floxer_tpu_torch.scripts import microbench_column_loop as k6

    inputs, texts, jstar = arrays
    operands = k5.device_operands(inputs, device)
    texts = torch.from_numpy(texts).to(device)
    jstar = torch.from_numpy(jstar).to(device)
    P = functools.partial
    return (
        [("K5", v, P(k5.ablate_banded, *operands, v),
          P(k5.ablate_banded_plain, *operands, v)) for v in k5.VARIANTS]
        + [("K6", v, P(k6.column_loop, texts, v),
            P(k6.column_loop_plain, texts, v)) for v in k6.VARIANTS]
        + [("K7", "carry={} ops={} rolls={}".format(*c),
            P(k78.carry_scaling, texts, *c),
            P(k78.carry_scaling_plain, texts, *c)) for c in k78.CONFIGS]
        + [("K8", f"bcast={b}", P(k78.bcast, texts, jstar, b),
            P(k78.bcast_plain, texts, jstar, b)) for b in k78.BCASTS]
    )


def host_arrays(result):
    """A kernel's output tensor or (dist, end) pair as int64 arrays."""
    tensors = result if isinstance(result, tuple) else (result,)
    return [t.cpu().numpy().astype("int64") for t in tensors]


# the plain versions' cases in a worker process (set by _plain_init)
_PLAIN_CASES = None


def _plain_init(arrays):
    global _PLAIN_CASES
    import torch

    torch.set_num_threads(1)
    _PLAIN_CASES = script_cases(torch.device("cpu"), arrays)


def _plain_run(index):
    """One variant's plain version on the CPU: (outputs, seconds)."""
    plain = _PLAIN_CASES[index][3]
    started = time.monotonic()
    outputs = host_arrays(plain())
    return outputs, time.monotonic() - started


def start_full_width_plain(arrays):
    """The plain versions of every K5-K8 case on CPU copies of `arrays`, in
    PLAIN_WORKERS spawned processes (no CUDA), while the card runs on:
    (pool, async result of [(outputs, seconds)] in script_cases' order).
    The caller terminates the pool."""
    import multiprocessing

    from floxer_tpu_torch.scripts import ablate_banded_kernel as k5
    from floxer_tpu_torch.scripts import microbench_carry_scaling as k78
    from floxer_tpu_torch.scripts import microbench_column_loop as k6

    count = (len(k5.VARIANTS) + len(k6.VARIANTS) + len(k78.CONFIGS)
             + len(k78.BCASTS))
    pool = multiprocessing.get_context("spawn").Pool(
        min(PLAIN_WORKERS, os.cpu_count() or 1), _plain_init, (arrays,)
    )
    return pool, pool.map_async(_plain_run, range(count), chunksize=1)


def run_scripts_phase(device, scripts_build, k1_row, k1_ends, full_arrays,
                      full_plain):
    """K5-K8: every variant against its plain version at COMPARE_TEXT
    columns on the card; K5 `full` at K1's end columns on K1's operands;
    every variant timed at the scripts' full width on `full_arrays`, its
    output held against `full_plain` (the plain versions on CPU copies of
    the same arrays); then the three entry points' main() with the launch
    counts set to 0 just before. Returns (phase fields, table rows)."""
    import numpy as np
    import torch

    from floxer_tpu_torch.ops import _build
    from floxer_tpu_torch.scripts import NUM_TEXT
    from floxer_tpu_torch.scripts import ablate_banded_kernel as k5
    from floxer_tpu_torch.scripts import microbench_carry_scaling as k78
    from floxer_tpu_torch.scripts import microbench_column_loop as k6

    scripts_build.result()  # re-raises a failed build
    variants = {}
    for kernel, label, launch, plain in script_cases(
        device, script_arrays(COMPARE_TEXT)
    ):
        got = host_arrays(launch())
        torch.cuda.synchronize()
        started = time.monotonic()
        want = host_arrays(plain())
        plain_ms = (time.monotonic() - started) * 1000
        err = max(int(np.max(np.abs(g - w))) for g, w in zip(got, want))
        check(err == 0, f"{kernel} {label} differs from its plain version "
              f"({err})")
        variants[(kernel, label)] = {
            "max_abs_err": err, f"ms_{COMPARE_TEXT}": cuda_ms(launch, 5),
            f"plain_ms_{COMPARE_TEXT}": plain_ms,
        }
    for operands, k1_end in k1_ends:
        _, end = k5.ablate_banded(*k5.from_banded_operands(*operands), "full")
        check(np.array_equal(end.cpu().numpy(), k1_end),
              f"K5 full and K1 end columns differ on {len(k1_end)} tasks")
    full_outputs = []
    for kernel, label, launch, _ in script_cases(device, full_arrays):
        ms = cuda_ms(launch, 3)
        full_outputs.append(host_arrays(launch()))
        variants[(kernel, label)].update(
            {f"ms_{NUM_TEXT}": ms, "us_per_col": ms * 1000 / NUM_TEXT}
        )
    full, r4 = (full_outputs[k5.VARIANTS.index(v)] for v in ("full", "r4"))
    check(all(np.array_equal(a, b) for a, b in zip(full, r4)),
          "K5 full and r4 differ")
    started = time.monotonic()
    plain_results = full_plain.get(timeout=PLAIN_TIMEOUT)
    plain_wait_s = time.monotonic() - started
    for (kernel, label), got, (want, seconds) in zip(
        list(variants), full_outputs, plain_results
    ):
        err = max(int(np.max(np.abs(g - w))) for g, w in zip(got, want))
        check(err == 0, f"{kernel} {label} differs from its plain version at "
              f"{NUM_TEXT} columns ({err})")
        variants[(kernel, label)].update({
            f"max_abs_err_{NUM_TEXT}": err, f"plain_cpu_s_{NUM_TEXT}": seconds,
        })

    # the entry points as a user runs them
    reset_launches()
    printed = {}
    for module in (k5, k6, k78):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = module.main()
        lines = out.getvalue().splitlines()
        check(code == 0, f"{module.__name__} exited {code}")
        printed[module.__name__.rsplit(".", 1)[1]] = lines
    launches = {"K5": k5.LAUNCHES, "K6": k6.LAUNCHES,
                "K7": k78.CARRY_LAUNCHES, "K8": k78.BCAST_LAUNCHES}
    for name, count in launches.items():
        check(count > 0, f"{name} was never launched by its entry point")
    check(all(len(lines) == 1 + n for lines, n in zip(
        printed.values(), (len(k5.VARIANTS), len(k6.VARIANTS),
                           len(k78.CONFIGS) + len(k78.BCASTS)))),
        f"unexpected entry point output: {printed}")

    table = {}
    for kernel, name, module, replaces, representative in (
        ("K5", "ablate_banded", k5, k5.REPLACES, "full"),
        ("K6", "column_loop", k6, k6.REPLACES, "elementwise"),
        ("K7", "carry_scaling", k78, k78.REPLACES, "carry=10 ops=80 rolls=12"),
        ("K8", "bcast", k78, k78.BCAST_REPLACES, "bcast=18"),
    ):
        rows = [v for (k, _), v in variants.items() if k == kernel]
        rep = variants[(kernel, representative)]
        table[kernel] = {
            "name": name, "route": "cuda", "source": module.SOURCE,
            "replaces": replaces, "launches": launches[kernel],
            "max_abs_err": max(
                max(r["max_abs_err"], r[f"max_abs_err_{NUM_TEXT}"])
                for r in rows
            ),
            "ms": rep[f"ms_{COMPARE_TEXT}"],
            "plain_ms": rep[f"plain_ms_{COMPARE_TEXT}"],
        }
    fields = {
        "nvcc_seconds": _build.SCRIPTS.last_build_seconds,
        "library": str(_build.SCRIPTS.path().relative_to(ROOT)),
        "shape": f"rows=32 BW=256 compare on the card at n={COMPARE_TEXT}, "
                 f"timed and compared with the plain versions on the CPU "
                 f"at n={NUM_TEXT}",
        "plain_wait_s": plain_wait_s,
        "k5_full_at_k1_end_tasks": sum(len(end) for _, end in k1_ends),
        "k1_us_per_col": k1_row["us_per_col"],
        "k5_full_us_per_col": variants[("K5", "full")]["us_per_col"],
        "variants": {f"{k} {label}": v for (k, label), v in variants.items()},
        "launches": launches, "entry_points": printed,
    }
    return fields, table


def load_e2e_checks():
    spec = importlib.util.spec_from_file_location(
        "floxer_e2e_checks", ROOT / "tests" / "test_e2e.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_toy_e2e(workdir: Path) -> None:
    data = ROOT / "tests" / "data"
    output = workdir / "toy.sam"
    proc = subprocess.run(
        [
            sys.executable, "-m", "floxer_tpu_torch",
            "--reference", str(data / "reference.fasta"),
            "--queries", str(data / "queries.fastq"),
            "--output", str(output),
            "--query-errors", "2", "--seed-errors", "1",
            "--extra-verification-ratio", "2", "--interval-optimization",
            "--stats", "terminal", "--engine", "device",
        ],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
    )
    check(proc.returncode == 0, f"toy e2e exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    check(proc.stdout == "", "toy e2e wrote to stdout")
    checks = load_e2e_checks()
    checks.check_output_records(checks.parse_sam(output))


def align_seconds(logfile: Path) -> tuple[float, str]:
    """(align seconds, stage split line) from a run's log file."""
    seconds, split = None, ""
    for line in logfile.read_text().splitlines():
        if "finished aligning successfully in" in line:
            seconds = float(line.split(" in ")[1].split()[0])
        if "stage split:" in line:
            split = line.split("stage split:")[1].strip()
    check(seconds is not None, f"no align time in {logfile}")
    return seconds, split


def reset_launches() -> None:
    from floxer_tpu_torch.ops import (
        cuda_myers,
        cuda_myers_banded,
        cuda_myers_large,
        traceback_device,
    )
    from floxer_tpu_torch.scripts import (
        ablate_banded_kernel,
        microbench_carry_scaling,
        microbench_column_loop,
    )

    for module in (cuda_myers_banded, cuda_myers, cuda_myers_large,
                   traceback_device, ablate_banded_kernel,
                   microbench_column_loop):
        module.LAUNCHES = 0
    microbench_carry_scaling.CARRY_LAUNCHES = 0
    microbench_carry_scaling.BCAST_LAUNCHES = 0


def run_logged_launches(logfile: Path) -> dict:
    """Kernel launches of one run, from its stage split line."""
    _, split = align_seconds(logfile)
    check("launches=" in split, f"no launch counts in {logfile}")
    field = split.split("launches=")[1].split()[0]
    return {k: int(v) for k, v in (item.split(":") for item in field.split(","))}


class E2E:
    """The simulated 20 kb workload and its runs; pass B (native host
    engine only) is the oracle every other pass is held to."""

    def __init__(self, workdir: Path, num_reads: int):
        from floxer_tpu.tools.simulated_dataset import main as simulate

        self.workdir = workdir
        self.num_reads = num_reads
        self.genome = workdir / "genome.fasta"
        self.reads = workdir / "reads.fastq"
        check(simulate([
            "create", "-g", str(self.genome), "-r", str(self.reads),
            "-c", "4600000", "-n", "1", "-l", "20000",
            "-m", str(num_reads), "-e", "0.07", "-s", str(SEED),
        ]) == 0, "simulated_dataset create failed")

    def argv(self, name, extra=()):
        return [
            "--reference", str(self.genome), "--queries", str(self.reads),
            "--index", str(self.workdir / "index.npz"),
            "--output", str(self.workdir / f"{name}.sam"),
            "--logfile", str(self.workdir / f"{name}.log"),
            "-p", "0.08", "--interval-optimization", "--threads", "4",
            "--batch-size", "100", *extra,
        ]

    def sam(self, name) -> bytes:
        return (self.workdir / f"{name}.sam").read_bytes()

    def seconds(self, name) -> float:
        return align_seconds(self.workdir / f"{name}.log")[0]

    def run_device_pass(self, name, extra=(), env=None):
        """One --engine device run in this process with the launch counts
        set to 0 just before it; (launches, fused dispatches)."""
        from floxer_tpu_torch import pipeline, verify_batch
        from floxer_tpu_torch.__main__ import main

        env = env or {}
        os.environ.update(env)
        try:
            fused_before = verify_batch._BATCH_TIMERS["fused"]
            reset_launches()
            code = main(self.argv(name, ["--engine", "device", *extra]))
            launches = pipeline.kernel_launches()
        finally:
            for key in env:
                del os.environ[key]
        check(code == 0, f"{name} failed")
        check(self.sam(name) == self.sam("pass_b"),
              f"{name} and pass B SAM files differ")
        return launches, verify_batch._BATCH_TIMERS["fused"] - fused_before


def run_e2e(device, e2e: E2E):
    import torch

    from floxer_tpu.cli import parse_and_validate
    from floxer_tpu_torch import pipeline, verify_batch

    # pass B first: the native host engine only (no torch kernel); it also
    # builds and saves the index every pass loads
    cli = parse_and_validate(e2e.argv("pass_b"))
    check(pipeline.run(cli, use_device=False) == 0, "pass B failed")

    # pass A: every wave fused on the card. The warmup (kernel build and
    # one tiny launch per kernel) runs first, so the counts below are the
    # alignment's own launches.
    pipeline.start_device_warmup(device)
    pipeline.join_device_warmup()
    torch.cuda.synchronize()
    kernel_before = verify_batch._BATCH_TIMERS["kernel"]
    launches, fused = e2e.run_device_pass("pass_a")
    device_kernel_s = verify_batch._BATCH_TIMERS["kernel"] - kernel_before

    sam_a = e2e.sam("pass_a")
    mapped = sum(
        1 for line in sam_a.decode().splitlines()
        if line and not line.startswith("@") and not int(line.split("\t")[1]) & 4
    )
    seconds_a, split_a = align_seconds(e2e.workdir / "pass_a.log")
    seconds_b, split_b = align_seconds(e2e.workdir / "pass_b.log")
    result = {
        "reads": e2e.num_reads, "genome_bp": 4_600_000, "read_len": 20_000,
        "sam_identical": True, "sam_bytes": len(sam_a),
        "mapped_records": mapped,
        "pass_a_align_s": seconds_a, "pass_b_align_s": seconds_b,
        "pass_a_stage_split": split_a, "pass_b_stage_split": split_b,
        "fused_dispatches": fused, "device_kernel_s": device_kernel_s,
        "launches": launches,
    }
    check(fused > 0, "pass A made no fused dispatch")
    for name in ("K1", "K2", "K3"):
        check(launches[name] > 0, f"{name} was never launched in pass A")
    check(mapped > 0, "no read mapped")
    return result, launches


def run_traceback_pass(e2e: E2E):
    """Pass C: root CIGARs by K4 (FLOXER_TPU_DEVICE_TRACEBACK=1)."""
    launches, fused = e2e.run_device_pass(
        "pass_c", env={"FLOXER_TPU_DEVICE_TRACEBACK": "1"}
    )
    check(launches["K4"] > 0, "K4 was never launched in pass C")
    return {
        "align_s": e2e.seconds("pass_c"),
        "pass_b_align_s": e2e.seconds("pass_b"),
        "launches": launches, "fused_dispatches": fused,
        "sam_identical": True,
    }, launches


def run_legacy_pass(e2e: E2E):
    """Pass D: the legacy object path (FLOXER_TPU_LEGACY_VERIFY=1): the
    bucketed batcher, resident buckets through _try_resident and the
    reversed without-CIGAR batch through host slices; no fused wave."""
    launches, fused = e2e.run_device_pass(
        "pass_d", env={"FLOXER_TPU_LEGACY_VERIFY": "1"}
    )
    check(fused == 0, "the legacy path made a fused dispatch")
    check(launches["K1"] > 0, "K1 was never launched in pass D")
    check(launches["K2"] + launches["K3"] > 0,
          "neither K2 nor K3 was launched in pass D")
    return {
        "reads": e2e.num_reads, "align_s": e2e.seconds("pass_d"),
        "stage_split": align_seconds(e2e.workdir / "pass_d.log")[1],
        "launches": launches, "sam_identical": True,
    }


def run_server_pass(e2e: E2E):
    """A --serve daemon (jax blocked) and two --server jobs."""
    sock = e2e.workdir / "floxer.sock"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    started = time.monotonic()
    daemon = subprocess.Popen(
        [sys.executable, "-c", JAX_BLOCKED, "--serve", str(sock)],
        stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env,
    )
    lines = []
    ready = threading.Event()

    def read_stderr():
        for line in daemon.stderr:
            lines.append(line.rstrip())
            if "warm replay done" in line:
                ready.set()

    reader = threading.Thread(target=read_stderr, daemon=True)
    reader.start()
    try:
        check(ready.wait(timeout=300),
              "server not ready: " + " | ".join(lines[-10:]))
        ready_s = time.monotonic() - started
        kernels_ready = [l for l in lines if "kernels ready" in l]
        check(len(kernels_ready) == 1, "no kernels-ready line: "
              + " | ".join(lines[-10:]))
        jobs = []
        for job in (1, 2):
            name = f"server_{job}"
            proc = subprocess.run(
                [sys.executable, "-m", "floxer_tpu_torch", "--server",
                 str(sock), *e2e.argv(name, ["--engine", "device"])],
                capture_output=True, text=True, cwd=ROOT, env=env,
                timeout=900,
            )
            check(proc.returncode == 0,
                  f"server job {job} exited {proc.returncode}: "
                  f"{proc.stderr[-2000:]}")
            check(e2e.sam(name) == e2e.sam("pass_b"),
                  f"server job {job} and pass B SAM files differ")
            log = (e2e.workdir / f"{name}.log").read_text()
            launches = run_logged_launches(e2e.workdir / f"{name}.log")
            check(launches["K1"] > 0, f"server job {job} launched no K1")
            jobs.append({
                "align_s": e2e.seconds(name), "launches": launches,
                "bank_cache_hit": "resident reference bank: cache hit" in log,
            })
        check(not jobs[0]["bank_cache_hit"], "server job 1 hit the bank cache")
        check(jobs[1]["bank_cache_hit"], "server job 2 missed the bank cache")
        proc = subprocess.run(
            [sys.executable, "-m", "floxer_tpu_torch", "--shutdown-server",
             str(sock)],
            capture_output=True, text=True, cwd=ROOT, env=env, timeout=60,
        )
        check(proc.returncode == 0, f"--shutdown-server exited "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        code = daemon.wait(timeout=120)
        check(code == 0, f"the daemon exited {code}")
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait()
        reader.join(timeout=10)
    return {
        "ready_s": ready_s, "kernels_ready": " | ".join(kernels_ready),
        "job1": jobs[0], "job2": jobs[1],
        "pass_b_align_s": e2e.seconds("pass_b"), "sam_identical": True,
    }


def run_profile_pass(e2e: E2E):
    """--profile: a torch.profiler trace of the alignment phase that names
    K1's kernel; the SAM is unchanged."""
    trace_dir = e2e.workdir / "trace"
    launches, _ = e2e.run_device_pass(
        "pass_p", extra=["--profile", str(trace_dir)]
    )
    traces = list(trace_dir.glob("*.json"))
    check(len(traces) == 1, f"expected one trace in {trace_dir}: {traces}")
    text = traces[0].read_text()
    check("myers_banded_kernel" in text, "the trace does not name K1")
    return {
        "align_s": e2e.seconds("pass_p"), "trace_bytes": len(text),
        "k1_events": text.count("myers_banded_kernel"),
        "launches": launches, "sam_identical": True,
    }


def main() -> int:
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    sys.path.insert(0, str(ROOT))
    from floxer_tpu_torch.backend import accelerator_device

    device = accelerator_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    phase("env", torch=torch.__version__, cuda=torch.version.cuda,
          capability=list(torch.cuda.get_device_capability(0)))
    print(card, flush=True)

    from floxer_tpu_torch.ops import _build

    # the research scripts' library builds beside the aligner's: every
    # nvcc starts now
    builder = ThreadPoolExecutor(max_workers=1)
    scripts_build = builder.submit(_build.SCRIPTS.load)
    builder.shutdown(wait=False)
    started = time.monotonic()
    _build.ALIGNER.load()
    phase("build", seconds=time.monotonic() - started,
          nvcc_seconds=_build.ALIGNER.last_build_seconds,
          library=str(_build.ALIGNER.path().relative_to(ROOT)))

    import numpy as np

    rng = np.random.default_rng(SEED)
    rows, k1_ends = run_kernel_phase(device, rng)
    rows["K4"] = run_traceback_phase(device, rng)
    phase("kernels", **{name: {k: v for k, v in row.items()
                               if k not in ("name", "route", "source",
                                            "replaces")}
                        for name, row in rows.items()})

    # the plain versions of K5-K8 at full width start on the CPU once
    # K1-K4 are timed, and are read at the end of the scripts phase
    from floxer_tpu_torch.scripts import NUM_TEXT

    full_arrays = script_arrays(NUM_TEXT)
    pool, full_plain = start_full_width_plain(full_arrays)
    try:
        fields, script_rows = run_scripts_phase(
            device, scripts_build, rows["K1"], k1_ends, full_arrays,
            full_plain,
        )
    finally:
        pool.terminate()
        pool.join()
    phase("scripts", **fields)

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        workdir = Path(tmp)
        run_toy_e2e(workdir)
        phase("toy_e2e", ok=True)
        e2e = E2E(workdir, E2E_READS)
        result, launches = run_e2e(device, e2e)
        phase("e2e", **result)
        result, launches_c = run_traceback_pass(e2e)
        phase("traceback", **result)
        phase("legacy", **run_legacy_pass(e2e))
        phase("server", **run_server_pass(e2e))
        phase("profile", **run_profile_pass(e2e))

    for name in ("K1", "K2", "K3"):
        rows[name]["launches"] = launches[name]
    rows["K4"]["launches"] = launches_c["K4"]
    rows.update(script_rows)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms")
    print(json.dumps({"kernels": [
        {k: rows[name][k] for k in keys}
        for name in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8")
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
