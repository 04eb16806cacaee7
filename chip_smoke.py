#!/usr/bin/env python3
"""Smoke run of floxer_tpu_torch, the PyTorch/CUDA port, on one NVIDIA
Hopper GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one line each on stdout, any failure exits non-zero:
  env      a CUDA device of capability >= 9.0; the card's name and power
           limit as nvidia-smi reports them
  build    nvcc builds csrc/*.cu for sm_90a (seconds); the research
           scripts' library (scripts/csrc/*.cu) builds beside it
  ptxas    what nvcc -Xptxas -v reported, in the aligner's own build, for
           every instance of the register kernels: K1's
           myers_banded_reg_kernel<R> and multi-warp
           myers_banded_wide_kernel and cluster
           myers_banded_cluster_kernel<Q> (Q = 1, 2, 4), K3's
           myers_large_reg_kernel<R> and cluster
           myers_large_cluster_kernel, and K2's
           myers_small_kernel<G>, and of the device search's kernels
           (K9, K9x, K9l, K10, K11, K12):
           registers, stack and spill bytes (a spill or a stack frame
           fails the run); and from the library's SASS (cuobjdump) the
           instructions of each register instance's column loops (K1
           sliding and frozen, K3 one per group count, K2 one)
  kernels  K1/K2/K3 against their plain PyTorch versions on the card on
           seeded cases (exact (dist, end) equality). K1 has three
           kernels: the register kernel at every instantiated width, the
           multi-warp kernel at the SWEEP_WIDE_BANDS widths and the
           shared-memory kernel at those and at a
           2176-word band (past the multi-warp kernel's widest, beside the
           cluster kernel), each
           against the plain version (run on CPU copies of the operands in
           worker processes that start before the build), and each width
           past the register kernel's driven once through myers_banded
           with the counts at 0 (it must take the multi-warp kernel, at
           2176 words the cluster one). K1 at the 20 kb root shape, on the 256
           band words its tasks need and on the 384 the fused wave runs its
           root level at: the register kernel against the plain version
           (run on the CPU in workers), the native host engine, the
           numpy band mirror and the
           shared-memory kernel, and both kernels timed in turns (shared,
           register, register, shared). K2 at every W = 1..8 (its
           instances of G = 1, 2, 4, 8 lanes per task), tasks of 1..W
           words, garbage chars, tlen 0 and 1 and m == 0 in each launch,
           and timed at 2048 tasks of 172 chars. K3 has three kernels:
           the register kernel at every instance (Wp = 32..512 words,
           tasks of 1 to Wp/32 groups in one launch), the cluster kernel
           (which takes every Wp past 512 words) at 544, 1280, 2048 and
           2080 words (tasks spread up to the width's last group) and the
           shared-memory kernel at those,
           each against the plain version, each width past the register
           kernel's driven once through myers_large with the counts at 0,
           and the register and shared-memory kernels timed in turns at
           256 tasks of 1376 chars on 128 words; K4 (banded
           traceback, one kernel whose blocks each run their task's
           layout; its plain versions run on the CPU in workers): every
           accepted root of a seeded batch of 20 kb roots
           (tools/k4_bench.py's root20k) in exactly one launch, equal to
           the host traceback (dp_reference, native) and timed against
           the 8-thread host pool (batch_s, host_pool_s); the kernel
           against its plain version on 2 root-shape tasks; its ms on
           those 2 and on the batch, each with its bound and its time
           without the walk; the mixed batch (one 40 kb root at -p 0.15
           among them) in one launch, each task in its own layout, equal
           to the host traceback; ptxas -v of the kernel (a spill or a
           stack frame fails the run); then each wider layout (K4_WIDE:
           16 and 32 register cells a lane, 64 shared-row cells) against
           the plain version on one task of its width and on the tool's
           30, 40 or 80 kb roots against the host traceback, timed with
           its bound; kernel and plain-version times, and each kernel's
           bound (see `bound`)
  long_shapes  the routed kernels at pass E's shapes, in turns with the
           shared-memory kernels on the same operands and held to them and
           to the native host engine: K1's multi-warp kernel at 64 roots
           of 40 kb reads (k = 6000) on 1024 and 640 band words (pass E's)
           and on 2048 (its widest); K3u at 64 overhanging roots on 1280
           pattern words (2 blocks a task); each width driven once through
           the routing
           entry with the counts at 0; each with its bound; and the plain
           versions once on the CPU in workers, on K1's 1024 words and
           on K3's shape, every kernel equal to them; and the cluster
           kernels at theirs, in turns with the shared-memory kernels
           (cluster, shared, cluster; one launch a turn) and held to them and to the native host engine:
           K1u at 8 roots of 200 kb reads (k = 30000) on 3200 band words,
           K3u at 8 roots of 100 kb reads with 60 kb on the chromosome on
           3200 pattern words; each with its bound, the share's ceiling
           (the SMs its clusters hold) and the clusters the card holds
  cluster_sweep  K1u and K3u at CLUSTER_SWEEP_WIDTHS (2176 to the widest,
           16384 words; F3's 6528 among them) on tasks of at most 2000
           columns (K1u's on deep bands whose rows reach every warp, tlen
           0 and 1 among them; K3u's spread to the width's last group),
           each against its plain version run in the sweep workers, each
           width once through the routing entry with the counts at 0
  scripts  the research scripts' kernels K5-K8 (floxer_tpu_torch.scripts):
           every variant against its plain version on the card at
           COMPARE_TEXT columns (exact); K5 full at K1's end columns on
           K1's operands of the kernels phase; every variant timed at the
           scripts' 23040 columns on the entry points' inputs (us/col
           beside K1's at the root shape), K5 full = r4 there, and each
           output there equal to its plain version, run on CPU copies of
           the same inputs in worker processes since the kernels phase
           ended; the ptxas report and the column loops of K5-K8's
           instances (no spill; K6 and K8 with no shared memory and
           loops that hold the work their functions name); then the
           three entry points' main() as a user runs them
           (python -m floxer_tpu_torch.scripts.<name>)
  toy_e2e  python -m floxer_tpu_torch --engine device on tests/data: the
           reference's expected records, empty stdout
  e2e      a simulated E. coli-sized genome (4.6 Mb) with 200 reads of
           20 kb at 7% error: pass A --engine device (every wave fused on
           the CUDA kernels), pass B on the native host engine only; SAM
           files byte-identical, K1-K3 launched in pass A, and every K1
           and K3 launch of pass A on its register kernel. Pass B is the
           oracle of every pass below.
  search_kernels  the device search's kernels on pass A's index: K9 (rank),
           K9x (both extensions, on random cursors and on the cursors the
           first chunk's seeds meet when extended backwards on the host
           index, with each set's share of intervals inside one block) and
           K9l (locate) against their plain
           versions on the card at RANK_QUERIES queries, in the combined
           rank-row layout and with the planes layout forced; K10 (the
           work-queue search) on pass A's first chunk of seeds against
           workqueue_search_plain on the card (sorted rows and node count
           equal), one search (a launch a generation) through the runner;
           each timed (CUDA events) with its bound; K10's nodes, reports,
           largest tree, spilled entries and generations, its search
           timed whole and its generations alone on buffers allocated
           once, at its budget and at K10_BUDGETS (each held to the
           first run), and the chunk's largest root alone; K11 (the
           frontier search) on the first read's largest per-query bucket
           and on the legacy loop's first 256-seed block of the first
           chunk (2^15 states), at the wrapper's pick of the cluster and
           at every FRONTIER_CLUSTERS size (each held to the pick), K12
           (device select) on the
           first chunk's groups after the dedup and cap replay under the
           CLI's defaults, with full_groups and with first_reported (the
           histogram of each seed's valid emissions beside each): each
           one launch, timed
           with its bound, equal to its plain version (run on the CPU in
           a worker), K11's reports in order, overflow, iterations and
           expanded states included
  sharded_kernels  the row-sharded index on pass A's index cut into 2
           and 4 shards (SHARD_COUNTS): K13 (rank, both directions) at
           RANK_QUERIES positions, K13l (locate) at RANK_QUERIES SA rows
           and K11 over the shard tables on the legacy loop's first
           256-seed block and on the per-query bucket: each exact against
           its plain version on the card and against the unsharded K9,
           K9l and K11 (reports in order, overflow, iterations, expanded
           states), timed with its bound (K13's and K11's a rank's ops
           times the shards, K13l's the owner's one rank a step), K13l in
           turns with K9l on the same rows (K9l, K13l, K9l) and its ratio
           to K9l, K11's at every cluster size too
  device_select  pass G2: pass G with FLOXER_TPU_DEVICE_SELECT=1: SAM =
           pass B, one K12 launch a chunk, no K9l or K11 launch; its
           search stage seconds (the device select and its host group
           order)
  device_search_blocks  pass G3: pass G with
           FLOXER_TPU_SEARCH_NO_CHUNK_FUSE=1 (the legacy block loop on
           K11): SAM = pass B, K11 launched, no K10 launch; the seeds
           redone after an overflow
  frontier_search  pass H: the first PASS_H_READS reads with pass A's
           arguments and --engine reference --device-search (the
           per-query frontier on K11): SAM = their own host pass, K11
           launched, no K10 launch; align seconds beside the host pass
  device_search  pass G: pass A's arguments with --device-search (the
           seed search by K10 on the card; the search warmup joined
           before the counts are set to 0); SAM = pass B, one K10 search
           a chunk (two for a chunk that overflows and is retried), a
           launch a generation (K10's SPILL_LAUNCHES count the later
           ones); its
           search= seconds beside pass A's and pass B's, and the seeds the
           host redid (long, overflowed)
  sharded_search  pass I: pass A's arguments with --device-search
           --index-shards 2 (the sharded searcher: the legacy block loop
           on K11 over the shard tables): SAM = pass B, K11 launched over
           the shards only, no K10; its search= seconds and stage split
  sharded_frontier  pass H2: the first PASS_H2_READS reads with --engine
           reference --device-search --index-shards 2 (the per-query
           frontier over the shards): SAM = their own host pass
  dryrun   floxer_tpu_torch.graft_entry on cuda:0: entry()'s step, then
           dryrun_multichip(2) and (8) on cuda:0 repeated (the 2-D
           step's sharded ranks equal to K9's, the sharded search and
           locate, the sharded CLI's SAM equal to the unsharded run's);
           K2, K9l, K11 over the shards, K13 and K13l launched
  platform_cpu  pass F2: --engine batched with FLOXER_TPU_PLATFORM=cpu:
           no kernel launch, no fused dispatch, SAM = pass B
  traceback  pass C: --engine device with FLOXER_TPU_DEVICE_TRACEBACK=1
           (root CIGARs by K4); SAM = pass B, K4 launched; its K4
           launches and align seconds beside pass A's
  process_set  pass F: pass A's arguments in two processes on the one
           card, joined as the reference's process set
           (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID; gloo
           on the host): each process's stage split shows K1 launches,
           stdout stays empty, process 0's merged SAM = pass B; each
           process's align seconds and the merge line
  legacy   pass D: --engine device with FLOXER_TPU_LEGACY_VERIFY=1 (the
           legacy object path: the bucketed batcher through resident banks
           and host slices); SAM = pass B, K1 and K2/K3 launched
  server   python -m floxer_tpu_torch --serve (jax blocked) and two
           --server --engine device jobs: SAM = pass B, the second job hits
           the resident bank cache; --shutdown-server and the daemon exit 0
  profile  --engine device --profile DIR: a torch.profiler trace naming
           K1's register kernel, SAM = pass B; device time by kernel
  long_reads  pass E: 6 reads of 40 kb at 12% error on a 1 Mb genome with
           -p 0.15 (LONG_READS) and 2 reads that run off the chromosome's
           end (OVERHANG_READS), --engine device against its own pass B:
           the roots' bands are wider than 512 words, so the multi-warp K1
           runs, and the overhanging reads' roots, cut short by the
           chromosome's end, run full on K3u (no launch of either
           shared-memory kernel); SAM identical; its device kernel
           seconds, and the tasks of each launch of the multi-warp K1 and
           of K3u at 544-2048 words; then pass E again under --profile
           and with the
           roots' CIGARs by K4 (FLOXER_TPU_DEVICE_TRACEBACK=1, its 16- or
           32-cell layout), its device time by kernel from the trace
  ultra_reads  pass J: on pass E's genome at its -p, one read of 100 kb
           at 12% error (the longest the aligner takes), one of 100 kb
           that runs off the chromosome's end with 60 kb on it and one of
           200 kb (ULTRA_READ, ULTRA_OVERHANG, ULTRA_SKIPPED), --engine
           device against its own pass B: the overhanging read's root runs
           full past 2048 pattern words (K3u) and its merged root windows
           take bands past 2048 words (K1u), no shared-memory launch; the
           200 kb read skipped by both passes; SAM identical; the widths
           the cluster kernels ran, the launches by kernel and
           device_kernel_s beside pass E's
Each path is driven with the launch counts set to 0 just before it and
read just after (server jobs report theirs in their stage split line). The
line before the last is the kernel table as JSON (K1 at the 384-word
root band, K1w and K1s at pass E's 1024-word root shape, K3s at its
1280-word overhang shape, K1u and K3u at their 200 kb and 100 kb
shapes with their plain ms at the sweep's 3200 words; K1-K3 launches of
pass A, the multi-warp K1's of pass E, K1u's of pass J, K3u's of passes E
and J, the shared-memory ones of passes E and J, K4 of pass C, its wider
layouts' of passes C and E under --profile, K5-K8 of the entry points'
run, K9, K9x, K9l and K10 of pass G: K10 a launch a generation of each
chunk's search, and K9, K9x and
K9l none, because their rank, extension and locate run inside K10, K11
and K12 as device functions; K11 of pass H, K12 of pass G2; K11s, K11
over the shard tables, of pass I; K13 and K13l of the dryrun phase: in
pass I K13's rank runs inside K11s and the locate stays on the host),
each kernel with its bound; before it the script's total seconds;
before it, the cpu_plain line: the CPU seconds of every plain version
run in the workers (each compared exactly with its kernel's output as it
arrives); the last line is {"ok": true, "device": {...}}.
"""

import contextlib
import functools
import importlib.util
import io
import json
import multiprocessing
import os
import re
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
# root tasks K1 is also held to the numpy band mirror on (~30 s a task on
# one core, in a sweep worker)
ROOT_MIRROR_TASKS = 2
# K4 at the same root shape: tools/k4_bench.py's "root20k" batch (128
# seeded 20 kb roots), then its "mixed" batch (one 40 kb root at -p 0.15
# in place of the last). K4's wider layouts: (row key, kernel name,
# layout, the tool's timed shape, and the plain version's task: pattern
# length, error rate, budget, a band about as wide as the timed shape's
# on fewer rows, since the plain version takes ~1 ms a row)
K4_WIDE = (
    ("K4r16", "traceback_banded_reg16", "reg16", "root30k",
     (12_000, 0.35, 4_500)),
    ("K4r32", "traceback_banded_reg32", "reg32", "root40k",
     (16_000, 0.45, 6_000)),
    ("K4s", "traceback_banded_shared64", "shared64", "root80k",
     (24_000, 0.6, 12_000)),
)
E2E_READS = 200
# text columns at which K5-K8 are held against their plain versions (the
# plain versions loop over columns in Python, so the scripts' 23040 would
# take minutes); rows and band words are the scripts' own
COMPARE_TEXT = 1280
# K5's band widths beside the script's 256 words (it is built at 128, 256
# and 384, K1's register widths): every variant is held to its plain
# version there too, on the script's inputs at that width and COMPARE_TEXT
# columns (the plain versions run in the workers below)
K5_OTHER_BAND_WORDS = (128, 384)
# launches a turn when K5's variants are timed with K1's register kernel
# on K1's root operands (the column decomposition)
K5_ROOT_REPEATS = 5
# processes that run K5-K8's plain versions at the scripts' 23040 columns
# (and K5's at K5_OTHER_BAND_WORDS) on the CPU while the card runs on, and
# how long the scripts phase waits for them at its end
PLAIN_WORKERS = 4
PLAIN_TIMEOUT = 600
# SM clock cycles the card spins before a timed run of launches (~10 ms at
# 1.98 GHz), longer than the host takes to enqueue them
ENQUEUE_CYCLES = 20_000_000
# K1's exactness sweep: seeded cases per band width (every width of the
# register kernel; SWEEP_WIDE_CASES at SWEEP_WIDE_BANDS for the
# multi-warp kernel's instances, then at WIDE_BAND_WORDS, wider than its
# widest, for the shared-memory kernel and the cluster kernel), and the
# processes that run the plain versions (K1's, and K3's past the register
# kernel's widest)
SWEEP_CASES = 48
SWEEP_WIDE_CASES = 16
SWEEP_WIDE_BANDS = (640, 1024, 2048)
WIDE_BAND_WORDS = 2176
SWEEP_WORKERS = 3
# K3's exactness sweep: seeded tasks per width (every instance of the
# register kernel; SWEEP_WIDE_LARGE (words, longest pattern) for the
# cluster kernel at the long reads' widths, its tasks spread up to that
# pattern's group; then WIDE_LARGE_WORDS, past 2048, for the shared-memory
# kernel and the cluster kernel, on patterns of up to WIDE_LARGE_CHARS
# chars);
# K2's takes 75 tasks at every W
LARGE_CASES = 12
SWEEP_WIDE_LARGE = ((544, None), (1280, 20_480), (2048, 16_384))
WIDE_LARGE_WORDS = 2080
WIDE_LARGE_CHARS = 3000
# pass E's shapes, where the routed kernels are timed in turns with the
# shared-memory ones: K1 at the long reads' roots (tasks, pattern
# length, budget, window chars past m, band widths: the root bands pass E
# runs, the first the table's and the plain version's, then the multi-warp
# kernel's widest on the same roots) and K3 at the overhanging reads'
# (tasks, pattern length, chars of it from the window's end, window
# length, pattern words)
LONG_ROOT_SHAPE = (64, 40_000, 6_000, 7_800, (1024, 640, 2048))
OVERHANG_SHAPE = (64, 40_000, 25_000, 30_000, 1280)
# the cluster kernels' shapes (K1u, K3u), timed in turns with the
# shared-memory kernels on the same operands and held to the native host
# engine: K1u at the roots of 200 kb reads at -p 0.15 (tasks, pattern
# length, budget, window chars past m, band words) and K3u at 100 kb
# reads that run off a chromosome's end with 60 kb on it (tasks, pattern
# length, chars of it from the window's end, window length, pattern words)
ULTRA_ROOT_SHAPE = (8, 200_000, 30_000, 39_000, 3200)
ULTRA_OVERHANG_SHAPE = (8, 100_000, 60_000, 60_000, 3200)
# timed launches a turn of the shared-memory kernels at those shapes
# (~0.2 s each at pass E's, seconds at the cluster kernels')
LONG_SHARED_REPEATS = 1
# the cluster kernels' exactness sweep: every width (band words for K1u,
# pattern words for K3u; F3's 6528 and the widest among them), on
# deep_band_cases / full_myers_operands tasks of at most
# CLUSTER_SWEEP_COLUMNS text columns (two more of tlen 0 and 1 at K1u's),
# each against its plain version in a sweep worker
CLUSTER_SWEEP_WIDTHS = (2176, 3200, 4096, 6528, 8192, 16384)
CLUSTER_SWEEP_TASKS = 4
CLUSTER_SWEEP_COLUMNS = 2000
# K1's plain versions and K3's at pass E's overhang shape, the longest of
# the CPU plain versions, run in this many workers each (at the root shape
# on each band, at pass E's long root shape and its overhang shape), each
# worker on its share of the tasks, the longest parts submitted first
K1_PLAIN_PARTS = 4
# the card's memory rate for the bounds (NVIDIA's H100 SXM data sheet) and
# its int32 issue rate per SM and clock: four sub-partitions, each
# dispatching one 32-lane warp instruction per clock, to the integer pipe
# (LOP3, IADD3, SHF, ISETP, SEL) or to the FMA pipe (IMAD); together the
# pipes that run these instructions issue at most that
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_CLOCK_PER_SM = 128
# int32 ops the functions need, counted as sm_90 runs them: LOP3 is any
# function of three registers, IADD3 a three-term add with carry in and
# out, SHF a funnel shift; loads, shuffles and work that is the same for
# every word of a task (warp-uniform) are not counted.
# K1, K5 per band word and text column: Eq 2 (a LOP3 of the three char
# planes on the column char's truth table, then OR the all-match plane),
# Eq & Vp 1, the add with its carry 1, Xh 1, Ph 1, Mh 1, Xv 1, the two
# one-bit shifts 2, Vp 1, Vn 1; plus one funnel shift per array of the six
# while the band slides
BANDED_OPS, SLIDE_OPS = 12, 6
# full Myers (K2, K3) per pattern word: the same step with Eq a Peq load
FULL_OPS = 10
# K4 per band cell: the substitution compare, the diagonal and vertical
# adds (2), their min, the running min-plus (2), the cell's value (2), the
# direction code (two compares and a select), its packing
TRACEBACK_OPS = 12
# K1 at the root shape's tasks on the band the fused wave gives the root
# level: its windows reach past 256 words, and a segment runs at its
# widest task's band (27 of pass A's 59 K1 launches ran at 384 words)
ROOT_WAVE_BAND_WORDS = 384
# pass E: a few long reads at a high error rate, whose PEX roots need
# bands wider than the register kernel's widest (512 words), so the
# fused wave runs them on the shared-memory K1: genome bp, reads, read
# length, read error rate, the aligner's -p
LONG_READS = (1_000_000, 6, 40_000, 0.12, 0.15)
# pass E also maps reads that run off the chromosome's end: how many, and
# how many of their chars come from the chromosome (the rest is random)
OVERHANG_READS = (2, 25_000)
# pass J, on pass E's genome at its -p: one read of ULTRA_READ[0] chars at
# ULTRA_READ[1] error, the longest the aligner takes (floxer, and both
# packages after it, skip a query past 100,000 chars:
# io/sequence_io.py's MAX_ALLOWED_QUERY_LENGTH); one of ULTRA_OVERHANG[0]
# chars that runs off the chromosome's end with ULTRA_OVERHANG[1] of them
# on it, whose root runs full on more than 2048 pattern words (K3u) and
# whose merged root windows take bands past 2048 words (K1u); and one of
# ULTRA_SKIPPED chars at ULTRA_READ[1] error, which both passes skip
ULTRA_READ = (100_000, 0.12)
ULTRA_OVERHANG = (100_000, 60_000)
ULTRA_SKIPPED = 200_000
# pass F: processes joined in one process set on the one card, and how
# long each may take
PROCESS_SET = 2
PROCESS_SET_TIMEOUT = 300
# the device search: queries of K9, K9x and K9l in the kernel checks, and
# the int32 ops the bounds count, as sm_90 runs them. A rank: per plane
# word its mask (a clamp, a shift, a select: 3 x 4), per symbol and word
# an AND, a popcount and an add (3 x 24), the block and offset (2). An
# extension: two ranks, then per symbol the count, its prefix, C and the
# two selects (5 x 6). A locate (K9l, K12's locates): per LF step a rank,
# the symbol and C (3); per step and at the end a lookup in the
# sampled-row plane (the range test, the block and offset, the word's
# three selects, the bit's shift and test: 8), and on the one hit a row
# makes its index (the four masks 12, per word an AND, a popcount and an
# add 12); then a binary search over the sequence starts (4 ops a probe).
# K10 per expanded node: two ranks, the counts and children's primaries
# (12), the pattern symbol and the 13 kinds' tests (30), the first
# child's interval and key nibble (14), the frame of a branching node
# (20). Over S row shards a rank (K13, K11 over the shards) is the
# owner's: one rank, S - 1 owner tests (a compare, the owner's add, the
# start's select: 3 each), the clamp (2) and the six adds of the earlier
# shards' totals; a locate step (K13l) likewise needs only the owner's:
# one rank, the symbol, C and the earlier shards' total (3), S owner tests
# and S sample-chunk tests, and one binary search of one chunk of the SA
# samples, not S of each.
RANK_QUERIES = 1 << 20
RANK_OPS = 86
EXTEND_OPS = 2 * RANK_OPS + 30
PROBE_OPS = 4
PLANE_LOOKUP_OPS = 8
PLANE_INDEX_OPS = 24
SEARCH_OPS_PER_NODE = 2 * RANK_OPS + 76


def sharded_rank_ops(shards: int) -> int:
    """int32 ops of one rank over `shards` row shards (the owner's)."""
    return RANK_OPS + 3 * (shards - 1) + 2 + 6


def locate_ops(steps: int, rows: int, seq_probes: int) -> int:
    """int32 ops of `rows` locates that take `steps` LF steps in all."""
    return (steps * (RANK_OPS + 3) + (steps + rows) * PLANE_LOOKUP_OPS
            + rows * (PLANE_INDEX_OPS + seq_probes))
# K10's searches timed back to back (each zeroes its counters and root
# counts on the stream, then launches its generations; see k10_times),
# and the budgets it is also timed at (nodes a unit expands before it
# spills; the last never spills on these seeds)
K10_REPEATS = 10
K10_BUDGETS = (32, 64, 256, 1 << 20)
# each work list's entries a root in that sweep (the wrapper's default
# lists at its own budget)
K10_SWEEP_LIST = 4
# K11 per expanded state: as K10's node, the two ranks, the 13 kinds'
# tests and the children's intervals, with the frame's 20 taken by the
# children's 10-field writes; K12 per emitted anchor beside its locate:
# its round or group and row (8), its key rank and sweep step (30), its
# output (6), and per seed the status and the caps (16)
FRONTIER_OPS_PER_STATE = 2 * RANK_OPS + 76
# the cluster sizes K11 is timed at (blocks a frontier)
FRONTIER_CLUSTERS = (1, 2, 4, 8, 16)
SELECT_OPS_PER_ANCHOR = 44
SELECT_OPS_PER_SEED = 16
# the plain versions that take minutes (K1 at the root shape on both
# bands and K1w at pass E's 1024 words, each in K1_PLAIN_PARTS workers,
# K3 at its overhang shape, K4's four layouts) and the search kernels'
# (K11, K12) run on
# the CPU in these spawned worker processes (no CUDA), started before the
# build, each with this many torch threads; the script waits this long
# at its end for the last of them
CPU_PLAIN_WORKERS = 4
CPU_PLAIN_THREADS = 2
CPU_PLAIN_TIMEOUT = 900
# the search kernels' plain versions (K11, K12: seconds each) run in a
# pool of their own, so they need not wait behind those; every worker
# runs at a lower priority than the process that drives the card
SEARCH_PLAIN_WORKERS = 2
CPU_PLAIN_NICE = 10
# pass H (--engine reference --device-search, the per-query frontier):
# the first reads of the 20 kb workload, held to their own host pass (the
# reference engine verifies one query at a time on the host, several
# seconds a 20 kb read, so all 200 would not fit the script's time)
PASS_H_READS = 8
# the row-sharded index: the shard counts of the kernel checks (the first
# is the table row's and pass I's), and pass H2's reads (the first of the
# workload, --engine reference --device-search --index-shards 2, held to
# their own host pass)
SHARD_COUNTS = (2, 4)
PASS_H2_READS = 2
# runs the port's CLI with jax unimportable, as on a machine without jax
JAX_BLOCKED = (
    "import runpy, sys; sys.modules['jax'] = None; "
    "sys.argv = ['floxer_tpu_torch'] + sys.argv[1:]; "
    "runpy.run_module('floxer_tpu_torch', run_name='__main__')"
)


STARTED = time.monotonic()
# the CPU plain versions' pool and its pending checks (set by main)
CPU_PLAIN = None


def phase(name: str, **fields) -> None:
    """One phase's line, with the script's seconds so far."""
    print(json.dumps({"phase": name, "at_s": time.monotonic() - STARTED,
                      **fields}), flush=True)


def check(condition: bool, message: str) -> None:
    if not condition:
        raise SystemExit(f"chip_smoke: FAILED: {message}")


def cuda_ms(fn, repeats: int) -> float:
    """Mean milliseconds of fn() on the card (CUDA events, after one warm
    call). The card spins for ENQUEUE_CYCLES first, so the host has
    enqueued every timed launch before the first runs: the events time
    the launches back to back, not the host's per-call overhead, which
    is longer than a K2 or K3 launch."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(ENQUEUE_CYCLES)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def mutate(rng, seq, rate):
    """Substitutions, insertions and deletions at `rate` per char
    (tools/k4_bench.py's, imported at the first call: the script alone,
    without the port, still starts and fails cleanly)."""
    from floxer_tpu_torch.tools.k4_bench import mutate as mutate_chars

    return mutate_chars(rng, seq, rate)


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


def k1_sweep_cases(seed):
    """[(band_words, operands as numpy arrays, num_text)]: SWEEP_CASES
    seeded tasks at every width of the register kernel, at
    SWEEP_WIDE_BANDS, then at WIDE_BAND_WORDS."""
    import numpy as np
    import torch

    from floxer_tpu_torch.ops.cuda_myers_banded import (
        REGISTER_BAND_WORDS,
        band_cases,
        banded_operands,
    )

    rng = np.random.default_rng(seed)
    cases = []
    for band_words in (*REGISTER_BAND_WORDS, *SWEEP_WIDE_BANDS,
                       WIDE_BAND_WORDS):
        count = (SWEEP_CASES if band_words in REGISTER_BAND_WORDS
                 else SWEEP_WIDE_CASES)
        patterns, texts, budgets = band_cases(rng, count, band_words)
        texts_u8, lens = pad(texts)
        operands, num_text = banded_operands(
            patterns, texts_u8, lens, budgets, band_words, torch.device("cpu")
        )
        cases.append((band_words, [t.numpy() for t in operands], num_text))
    return cases


def k3_sweep_cases(seed):
    """[(words, operands as numpy arrays)]: LARGE_CASES seeded tasks
    (full_myers_operands) at each of SWEEP_WIDE_LARGE, spread up to its
    longest pattern, then at WIDE_LARGE_WORDS on patterns of up to
    WIDE_LARGE_CHARS chars."""
    import numpy as np
    import torch

    from floxer_tpu_torch.ops.myers import full_myers_operands

    rng = np.random.default_rng(seed)
    cases = []
    for words, max_chars in (*SWEEP_WIDE_LARGE,
                             (WIDE_LARGE_WORDS, WIDE_LARGE_CHARS)):
        args = full_myers_operands(
            rng, LARGE_CASES, words, False, torch.device("cpu"),
            max_chars=max_chars, spread=words != WIDE_LARGE_WORDS,
        )
        cases.append((words, [t.numpy() for t in args]))
    return cases


def cluster_sweep_cases(seed):
    """The cluster kernels' sweep, at every CLUSTER_SWEEP_WIDTHS width:
    ([(band_words, K1 operands as numpy arrays, num_text)], [(words, K3
    operands as numpy arrays)]). K1u's: CLUSTER_SWEEP_TASKS deep bands
    (deep_band_cases: pattern rows in every warp from the first column,
    chars 6..15 in some texts) and two band_cases tasks whose tlen is set
    to 0 and 1; K3u's: full_myers_operands' tasks spread from one group to
    the width's last (m == 0, tlen 0 and 1 among them), each text cut to
    CLUSTER_SWEEP_COLUMNS columns."""
    import numpy as np
    import torch

    from floxer_tpu_torch.ops.cuda_myers_banded import (
        band_cases,
        banded_operands,
        deep_band_cases,
    )
    from floxer_tpu_torch.ops.myers import full_myers_operands

    rng = np.random.default_rng(seed)
    cpu = torch.device("cpu")
    k1_cases, k3_cases = [], []
    for width in CLUSTER_SWEEP_WIDTHS:
        patterns, texts, budgets = deep_band_cases(
            rng, CLUSTER_SWEEP_TASKS, width, CLUSTER_SWEEP_COLUMNS)
        more = band_cases(rng, 2, width)
        texts_u8, lens = pad(texts + more[1])
        lens[-2:] = (0, 1)
        operands, num_text = banded_operands(
            patterns + more[0], texts_u8, lens,
            np.concatenate([budgets, more[2]]), width, cpu,
        )
        k1_cases.append((width, [t.numpy() for t in operands], num_text))
        args = full_myers_operands(
            rng, CLUSTER_SWEEP_TASKS + 2, width, False, cpu, spread=True,
            max_columns=CLUSTER_SWEEP_COLUMNS,
        )
        k3_cases.append((width, [t.numpy() for t in args]))
    return k1_cases, k3_cases


def _k3_plain(case):
    """K3's plain version on one sweep case, on the CPU (worker process)."""
    import torch

    from floxer_tpu_torch.ops.cuda_myers_large import myers_large_plain

    torch.set_num_threads(1)
    _, arrays = case
    started = time.monotonic()
    out = myers_large_plain(*(torch.from_numpy(a) for a in arrays))
    return [t.numpy() for t in out], time.monotonic() - started


def _k1_plain(case):
    """K1's plain version on one sweep case, on the CPU (worker process)."""
    import torch

    from floxer_tpu_torch.ops.cuda_myers_banded import myers_banded_plain

    torch.set_num_threads(1)
    band_words, arrays, num_text = case
    started = time.monotonic()
    out = myers_banded_plain(
        *(torch.from_numpy(a) for a in arrays), band_words, num_text
    )
    return [t.numpy() for t in out], time.monotonic() - started


def k1_phase_inputs(rng):
    """The kernels phase's K1 tasks, drawn from `rng` in the phase's order:
    64 small seeded cases (patterns, texts, budgets), then ROOT_SHAPE's
    tasks on a 400 kb genome (patterns, texts)."""
    import numpy as np

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
    T, m_root, k_root, _ = ROOT_SHAPE
    genome = rng.integers(1, 5, size=400_000).astype(np.uint8)
    root_patterns, root_texts = [], []
    for _ in range(T):
        n = m_root + 2 * k_root + 1 + int(rng.integers(0, 1200))
        start = int(rng.integers(0, len(genome) - n))
        window = genome[start : start + n]
        offset = int(rng.integers(0, n - m_root - k_root))
        root_patterns.append(
            mutate(rng, window[offset : offset + m_root], 0.05)[:m_root]
        )
        root_texts.append(window)
    return (patterns, texts, budgets), (root_patterns, root_texts)


def long_shape_inputs():
    """run_long_shapes' tasks from their seed (SEED + 2): K1's long roots
    (patterns, texts) and K3's overhanging roots (patterns, texts)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 2)
    genome = rng.integers(1, 5, size=2_000_000).astype(np.uint8)
    T, m, k, extra, widths = LONG_ROOT_SHAPE
    patterns, texts = [], []
    for _ in range(T):
        n = m + extra + int(rng.integers(0, 400))
        start = int(rng.integers(0, len(genome) - n))
        window = genome[start : start + n]
        offset = int(rng.integers(0, extra // 2))
        patterns.append(mutate(rng, window[offset : offset + m], 0.12)[:m])
        texts.append(window)
    B, m3, inside, n3, words = OVERHANG_SHAPE
    patterns3, texts3 = [], []
    for _ in range(B):
        start = int(rng.integers(0, len(genome) - n3))
        window = genome[start : start + n3]
        read = mutate(rng, window[n3 - inside :], 0.12)
        tail = rng.integers(1, 5, size=max(0, m3 - len(read)))
        patterns3.append(np.concatenate([read, tail]).astype(np.uint8)[:m3])
        texts3.append(window)
    return (patterns, texts), (patterns3, texts3)


def ultra_shape_inputs():
    """The cluster kernels' long shapes from their seed (SEED + 4): K1u's
    roots of 200 kb reads (patterns, texts) and K3u's overhanging roots
    (patterns, texts), as long_shape_inputs makes pass E's."""
    import numpy as np

    rng = np.random.default_rng(SEED + 4)
    genome = rng.integers(1, 5, size=2_000_000).astype(np.uint8)
    T, m, k, extra, _ = ULTRA_ROOT_SHAPE
    patterns, texts = [], []
    for _ in range(T):
        n = m + extra + int(rng.integers(0, 400))
        start = int(rng.integers(0, len(genome) - n))
        window = genome[start : start + n]
        offset = int(rng.integers(0, extra // 2))
        patterns.append(mutate(rng, window[offset : offset + m], 0.12)[:m])
        texts.append(window)
    B, m3, inside, n3, _ = ULTRA_OVERHANG_SHAPE
    patterns3, texts3 = [], []
    for _ in range(B):
        start = int(rng.integers(0, len(genome) - n3))
        window = genome[start : start + n3]
        read = mutate(rng, window[n3 - inside :], 0.12)
        tail = rng.integers(1, 5, size=max(0, m3 - len(read)))
        patterns3.append(np.concatenate([read, tail]).astype(np.uint8)[:m3])
        texts3.append(window)
    return (patterns, texts), (patterns3, texts3)


def k3_overhang_operands(patterns3, texts3, words):
    """K3's operands of the overhanging roots as numpy arrays: (peq uint32
    [chars, SIGMA, words] zero padded, plen, texts int32, tlen)."""
    import numpy as np

    from floxer_tpu_torch.ops.myers import build_peq_vectorized

    pat, plen = pad(patterns3)
    txt, tlen = pad(texts3)
    peq = build_peq_vectorized(pat, plen)
    check(peq.shape[2] <= words, "an overhang root exceeds its width")
    padded = np.zeros(peq.shape[:2] + (words,), dtype=np.uint32)
    padded[:, :, : peq.shape[2]] = peq
    return padded, plen, txt.astype(np.int32), tlen


def _cpu_plain_init():
    import torch

    os.nice(CPU_PLAIN_NICE)
    torch.set_num_threads(CPU_PLAIN_THREADS)


def _timed_outputs(fn):
    """(the outputs of fn() as numpy arrays, its seconds)."""
    started = time.monotonic()
    out = fn()
    seconds = time.monotonic() - started
    if not isinstance(out, (list, tuple)):
        out = (out,)
    return [t.numpy() if hasattr(t, "numpy") else t for t in out], seconds


def _k1_root_plain(band_words, part):
    """K1's plain version at the root shape on `band_words` words, its
    tasks drawn from SEED as the kernels phase draws them, on part `part`
    of K1_PLAIN_PARTS equal parts of the tasks (CPU worker)."""
    import numpy as np
    import torch

    from floxer_tpu_torch.ops.cuda_myers_banded import (
        banded_operands,
        myers_banded_plain,
    )

    _, (patterns, texts) = k1_phase_inputs(np.random.default_rng(SEED))
    size = ROOT_SHAPE[0] // K1_PLAIN_PARTS
    tasks = slice(part * size, (part + 1) * size)
    texts_u8, lens = pad(texts[tasks])
    operands, num_text = banded_operands(
        patterns[tasks], texts_u8, lens, np.full(size, ROOT_SHAPE[2]),
        band_words, torch.device("cpu"),
    )
    return _timed_outputs(
        lambda: myers_banded_plain(*operands, band_words, num_text))


def _k1_root_mirror(task):
    """The numpy band mirror (myers_banded_np) on root task `task` of the
    kernels phase, its tasks drawn from SEED as that phase draws them
    (sweep worker): ([distance], [end column]) and its seconds."""
    import numpy as np

    from floxer_tpu_torch.ops.myers_banded import myers_banded_np

    _, (patterns, texts) = k1_phase_inputs(np.random.default_rng(SEED))
    return _timed_outputs(lambda: [
        np.asarray([value]) for value in
        myers_banded_np(patterns[task], texts[task], ROOT_SHAPE[2])])


def _long_k1_plain(part):
    """K1's plain version at pass E's long roots on the first band width,
    on part `part` of K1_PLAIN_PARTS equal parts of the tasks (CPU
    worker; each task's output is its own, so the parts' outputs joined
    are the whole batch's)."""
    import numpy as np
    import torch

    from floxer_tpu_torch.ops.cuda_myers_banded import (
        banded_operands,
        myers_banded_plain,
    )

    (patterns, texts), _ = long_shape_inputs()
    T, _, k, _, widths = LONG_ROOT_SHAPE
    size = T // K1_PLAIN_PARTS
    tasks = slice(part * size, (part + 1) * size)
    texts_u8, lens = pad(texts[tasks])
    operands, num_text = banded_operands(
        patterns[tasks], texts_u8, lens, np.full(size, k), widths[0],
        torch.device("cpu"),
    )
    return _timed_outputs(
        lambda: myers_banded_plain(*operands, widths[0], num_text))


class JoinedResult:
    """The parts of one plain version run in several workers, read as one
    result: get() joins the parts' outputs along their first axis, in
    order, and sums their CPU seconds."""

    def __init__(self, parts):
        self.parts = parts

    def get(self, timeout):
        import numpy as np

        deadline = time.monotonic() + timeout
        results = [part.get(timeout=max(1.0, deadline - time.monotonic()))
                   for part in self.parts]
        outputs = [np.concatenate(arrays)
                   for arrays in zip(*(out for out, _ in results))]
        return outputs, sum(seconds for _, seconds in results)


def _long_k3_plain(part):
    """K3's plain version at pass E's overhang shape, on part `part` of
    K1_PLAIN_PARTS equal parts of the tasks (CPU worker)."""
    import torch

    from floxer_tpu_torch.ops.cuda_myers_large import myers_large_plain
    from floxer_tpu_torch.ops.myers import u32_tensor

    _, (patterns3, texts3) = long_shape_inputs()
    size = OVERHANG_SHAPE[0] // K1_PLAIN_PARTS
    tasks = slice(part * size, (part + 1) * size)
    peq, plen, txt, tlen = k3_overhang_operands(
        patterns3[tasks], texts3[tasks], OVERHANG_SHAPE[4])
    cpu = torch.device("cpu")
    args = (u32_tensor(peq, cpu), torch.from_numpy(plen),
            torch.from_numpy(txt), torch.from_numpy(tlen))
    return _timed_outputs(lambda: myers_large_plain(*args))


def k4_plain_tasks(key):
    """K4's tasks of one plain-version check: the first 2 of the root20k
    batch ("K4"), or the one task of a wider layout (a K4_WIDE key)."""
    import numpy as np

    from floxer_tpu_torch.tools import k4_bench

    if key == "K4":
        return k4_bench.shape_tasks("root20k", SEED)[:2]
    for wide_key, _, _, _, (m, rate, budget) in K4_WIDE:
        if wide_key == key:
            return k4_bench.root_tasks(np.random.default_rng(SEED), 1, m,
                                       rate, budget)
    raise KeyError(key)


def _k4_plain(key):
    """K4's plain version on one check's tasks (CPU worker)."""
    import torch

    from floxer_tpu_torch.ops import traceback_device as td

    batch = td.pack_batch(k4_plain_tasks(key))
    args = [torch.from_numpy(a)
            for a in (batch.windows, batch.patterns, batch.table)]
    return _timed_outputs(
        lambda: td.banded_traceback_plain(*args, batch.ops_total))


def _cpu_index(index_path):
    import torch

    from floxer_tpu_torch.index.device_index import DeviceIndex
    from floxer_tpu_torch.index.fmindex import FmIndex

    return DeviceIndex.from_host(FmIndex.load(index_path),
                                 torch.device("cpu"))


def _frontier_plain(index_path, padded, seed_class, fused, num_searches,
                    num_parts, capacity, reports, max_iterations):
    """K11's plain version on one frontier (CPU worker): (reports, count,
    overflow, iterations, expanded)."""
    import torch

    from floxer_tpu_torch.ops.frontier import frontier_search_plain

    index = _cpu_index(index_path)
    stats = {}

    def run():
        out = frontier_search_plain(
            index, torch.from_numpy(padded), torch.from_numpy(seed_class),
            torch.from_numpy(fused), num_searches, num_parts, capacity,
            reports, max_iterations, stats,
        )
        return out[0], torch.tensor([out[1]]), out[2]

    outputs, seconds = _timed_outputs(run)
    return outputs + [stats["iterations"], stats["expanded"]], seconds


def _select_plain(index_path, arrays, caps):
    """K12's plain version on one chunk's groups (CPU worker): arrays are
    select_plain's int32 operands (lb, cnt, err, gid, perm, group_starts,
    totals, statuses), caps its scalars."""
    import torch

    from floxer_tpu_torch.search_select_device import select_plain

    index = _cpu_index(index_path)
    tensors = [torch.from_numpy(a) for a in arrays]
    return _timed_outputs(lambda: select_plain(index, *tensors, *caps))


class CpuPlain:
    """The plain versions that run on the CPU in worker processes beside
    the card: submit() starts one, expect() holds a kernel's outputs for
    it, and settle() compares each pair exactly (a difference fails the
    run) as its result arrives, then records the plain version's CPU
    seconds with `record(seconds)`."""

    def __init__(self, pool, search_pool):
        self.pool = pool
        self.search_pool = search_pool
        self.pending = []
        self.seconds = {}
        # the runs started at launch, by key (K1's root shape by its band
        # words, "long_k1", "long_k3", and K4's checks by row key)
        self.results = {}

    def submit(self, fn, *args):
        pool = (self.search_pool if fn in (_frontier_plain, _select_plain)
                else self.pool)
        return pool.apply_async(fn, args)

    def expect(self, label, result, kernel_outputs, record=None):
        self.pending.append((label, result, kernel_outputs, record))

    def settle(self) -> dict:
        """{label: CPU seconds} of every check, once all have passed."""
        import numpy as np

        deadline = time.monotonic() + CPU_PLAIN_TIMEOUT
        for label, result, kernel_outputs, record in self.pending:
            want, seconds = result.get(
                timeout=max(1.0, deadline - time.monotonic())
            )
            for got in kernel_outputs:
                err = max((int(np.max(np.abs(np.asarray(g, np.int64)
                                             - np.asarray(w, np.int64))))
                           if np.size(g) else 0)
                          for g, w in zip(got, want))
                check(all(np.shape(g) == np.shape(w)
                          for g, w in zip(got, want)) and err == 0,
                      f"{label} differs from its plain version on the CPU "
                      f"({err})")
            self.seconds[label] = seconds
            if record is not None:
                record(seconds)
        self.pending = []
        return self.seconds


def card_peaks(device) -> dict:
    """The rates the bounds divide by: int32 ops/s =
    INT32_OPS_PER_CLOCK_PER_SM x the SMs x the max SM clock nvidia-smi
    reads; the memory rate of the data sheet."""
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return {
        "sm_count": sms, "max_sm_clock_mhz": mhz,
        "int32_ops_per_s": INT32_OPS_PER_CLOCK_PER_SM * sms * mhz * 1e6,
        "bytes_per_s": HBM_BYTES_PER_S,
    }


def bound(ops, nbytes, peaks) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the ops over the int32 issue
    rate and the bytes (each input read once, each output written once)
    over the memory rate."""
    ops_ms = ops / peaks["int32_ops_per_s"] * 1e3
    bytes_ms = nbytes / peaks["bytes_per_s"] * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def bound_fields(bound_and_by) -> dict:
    """A table row's bound keys; no PyTorch call computes a Myers
    distance or a traceback, so no library time."""
    bound_ms, bound_by = bound_and_by
    return {"bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def banded_ops(band_words, tlen, jstar, num_text) -> int:
    """K1's int32 ops on these tasks: every task runs its own columns
    1..min(tlen - 1, num_text) and slides on the first min(j*, that)."""
    import numpy as np

    tlen = np.asarray(tlen, dtype=np.int64)
    columns = np.clip(np.minimum(tlen - 1, num_text), 0, None)
    sliding = np.clip(np.minimum(np.asarray(jstar, np.int64), columns), 0, None)
    return int(band_words * (BANDED_OPS * columns + SLIDE_OPS * sliding).sum())


def k1_bound(args, peaks) -> tuple[float, str]:
    """K1's bound on its operands (vp0, planes0, texts, stream, scalars,
    band_words, num_text)."""
    from floxer_tpu_torch.ops import cuda_myers_banded as k1

    scalars = args[4].cpu().numpy()
    ops = banded_ops(args[5], scalars[:, k1.COL_TLEN],
                     scalars[:, k1.COL_JSTAR], args[6])
    return bound(ops, tensor_bytes(*args[:5]) + 8 * args[0].shape[0], peaks)


def full_bound(args, peaks) -> tuple[float, str]:
    """K2's or K3's bound on (peq, plen, texts, tlen): FULL_OPS per pattern
    word each task needs per column of its text."""
    import numpy as np

    plen = args[1].cpu().numpy().astype(np.int64)
    tlen = args[3].cpu().numpy().astype(np.int64)
    ops = FULL_OPS * int((-(-plen // 32) * tlen).sum())
    return bound(ops, tensor_bytes(*args) + 8 * len(plen), peaks)


def run_kernel_phase(device, rng, peaks, sweep, sweep_plain, large_sweep,
                     large_plain):
    """Each kernel against its plain version on identical card tensors;
    K1 at the root shape, on 256 band words and on ROOT_WAVE_BAND_WORDS,
    against the plain version, the native engine, the numpy mirror and its
    other kernel, both kernels timed in turns; K1's sweep (`sweep`,
    k1_sweep_cases) against the plain versions' results (`sweep_plain`, an
    async result of _k1_plain per case), and K3's past the register
    kernel's widest (`large_sweep`, k3_sweep_cases, against `large_plain`,
    of _k3_plain) likewise. Returns the table rows K1, K2, K3 (launch
    counts filled in later), K1's (arguments, end columns) by case (the
    small cases, the root shape on both bands), the sweep's fields, and the plain versions' times at the
    sweeps' widths (run_long_shapes' rows carry them)."""
    import numpy as np
    import torch

    from floxer_tpu_torch.native import native_myers_distance_batch
    from floxer_tpu_torch.ops import cuda_myers, cuda_myers_banded, cuda_myers_large
    from floxer_tpu_torch.ops.cuda_myers_banded import banded_operands
    from floxer_tpu_torch.ops.myers import (
        build_peq_vectorized,
        full_myers_operands,
        u32_tensor,
    )

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
    # K1's arguments and end columns, which K5 `full` must reproduce, by
    # case: the small cases on 128 band words, the root shape on both bands
    k1_ends = {}
    # K1 seeded small cases (test_pallas_myers_banded.py's generator), then
    # the 20 kb root shape: T=256, m ~ 20.6k, k = 1442, on the 256-word
    # band the tasks need and on the fused wave's root band
    (patterns, texts, budgets), (root_patterns, root_texts) = (
        k1_phase_inputs(rng)
    )
    args = banded_args(patterns, texts, budgets, 128)
    got, _, err_small = compare(
        cuda_myers_banded.myers_banded, cuda_myers_banded.myers_banded_plain, args
    )
    check(err_small == 0, f"K1 differs from its plain version ({err_small})")
    k1_ends["small BW=128"] = (args, got[1])

    T, m_root, k_root, bw_root = ROOT_SHAPE
    patterns, texts = root_patterns, root_texts
    budgets = [k_root] * T
    native_dist, native_end = native_myers_distance_batch(
        texts, patterns, num_threads=min(8, os.cpu_count() or 1),
        budgets=budgets,
    )
    check(bool((native_dist <= k_root).all()),
          "root-shape cases must all be within budget")
    # the numpy band mirror is slow: a subset, run in a sweep worker since
    # the start (_k1_root_mirror) and compared when the CPU checks settle
    mirror = CPU_PLAIN.results["root_mirror"]
    # the launch lasts as long as its longest task: tlen - 1 columns
    k1_columns = max(len(t) for t in texts) - 1
    k1_root = {}
    for band_words in (bw_root, ROOT_WAVE_BAND_WORDS):
        check(band_words in cuda_myers_banded.REGISTER_BAND_WORDS,
              f"{band_words} words is not a register kernel width")
        args = banded_args(patterns, texts, budgets, band_words)
        got = [t.cpu().numpy() for t in
               cuda_myers_banded.myers_banded_register(*args)]
        shared = [t.cpu().numpy() for t in
                  cuda_myers_banded.myers_banded_shared(*args)]
        at = f"at the root shape on {band_words} band words"
        err = 0
        case = {}

        def record(seconds, case=case):
            case["plain_ms"] = seconds * 1000
            case["plain_on"] = "cpu"

        # the plain version runs on the CPU in workers since the start
        CPU_PLAIN.expect(f"K1 {at}", CPU_PLAIN.results[band_words], [got],
                         record)
        check(all(np.array_equal(g, h) for g, h in zip(got, shared)),
              f"K1's register and shared-memory kernels differ {at}")
        check(np.array_equal(got[0], native_dist)
              and np.array_equal(got[1], native_end),
              f"K1 differs from the native engine {at}")
        CPU_PLAIN.expect(f"K1's numpy mirror {at}", mirror,
                         [[g[:ROOT_MIRROR_TASKS] for g in got]])
        k1_ends[f"root BW={band_words}"] = (args, got[1])
        # both kernels on the same operands, in turns: shared, register,
        # register, shared
        turns = {"register": [], "shared": []}
        for name in ("shared", "register", "register", "shared"):
            kernel = getattr(cuda_myers_banded, f"myers_banded_{name}")
            turns[name].append(cuda_ms(lambda: kernel(*args), 5))
        bound_ms, bound_by = k1_bound(args, peaks)
        case.update({"max_abs_err": err,
                     "bound_ms": bound_ms, "bound_by": bound_by,
                     "shape": f"T={T} m={m_root} k={k_root} BW={band_words} "
                              f"n~{m_root + 2 * k_root + 600}",
                     "columns": k1_columns})
        for name, turn in turns.items():
            ms = sum(turn) / len(turn)
            case[name] = {"ms": ms, "turns_ms": turn,
                          "us_per_col": ms * 1000 / k1_columns,
                          "bound_share": bound_ms / ms}
        k1_root[band_words] = case
    # the table's K1 row: the register kernel on the fused wave's root
    # band (the shared-memory kernel's turns beside it, under "root")
    wave = k1_root[ROOT_WAVE_BAND_WORDS]
    rows["K1"] = {
        "name": "myers_banded_reg", "route": "cuda",
        "source": cuda_myers_banded.SOURCE,
        "replaces": cuda_myers_banded.REPLACES,
        "max_abs_err": max(err_small, *(c["max_abs_err"]
                                        for c in k1_root.values())),
        "ms": wave["register"]["ms"], "plain_ms": None, "plain_on": "cpu",
        "bound_ms": wave["bound_ms"], "bound_by": wave["bound_by"],
        "library_ms": None, "shape": wave["shape"],
        "us_per_col": wave["register"]["us_per_col"],
        "root": {f"BW={bw}": case for bw, case in k1_root.items()},
    }
    # the row's plain ms: the CPU worker's at the wave's root band
    CPU_PLAIN.expect(
        "K1 row", CPU_PLAIN.results[ROOT_WAVE_BAND_WORDS], [],
        lambda seconds: rows["K1"].update(plain_ms=seconds * 1000),
    )

    # ---- K1's sweep: the register kernel at every width, the multi-warp
    # kernel at SWEEP_WIDE_BANDS and the shared-memory kernel at those and
    # at WIDE_BAND_WORDS, each against the plain version on CPU copies of
    # the same operands
    sweep_errors = {}
    waited = time.monotonic()
    plain_results = sweep_plain.get(timeout=600)
    sweep_wait_s = time.monotonic() - waited
    for (band_words, arrays, num_text), (want, plain_s) in zip(
        sweep, plain_results
    ):
        sweep_args = (*(to_dev(a) for a in arrays), band_words, num_text)
        if band_words in cuda_myers_banded.REGISTER_BAND_WORDS:
            kernels = [("register", cuda_myers_banded.myers_banded_register),
                       ("shared", cuda_myers_banded.myers_banded_shared)]
        else:
            wide = band_words in cuda_myers_banded.WIDE_BAND_WORDS
            kernels = [("wide", cuda_myers_banded.myers_banded_wide) if wide
                       else ("cluster",
                             cuda_myers_banded.myers_banded_cluster),
                       ("shared", cuda_myers_banded.myers_banded_shared)]
            # the band through the routing entry, counted alone: it must
            # take the multi-warp kernel, past its widest the cluster one
            reset_launches()
            cuda_myers_banded.myers_banded(*sweep_args)
            torch.cuda.synchronize()
            routed = launch_split(cuda_myers_banded)
            expected = (0, 1, 0, 0) if wide else (0, 0, 1, 0)
            check(routed == expected, f"a {band_words}-word band took the "
                  f"kernels {K1_SPLIT} {routed} times")
        for name, kernel in kernels:
            got = [t.cpu().numpy() for t in kernel(*sweep_args)]
            err = max(int(np.max(np.abs(g.astype(np.int64) - w)))
                      for g, w in zip(got, want))
            check(err == 0, f"K1's {name} kernel differs from its plain "
                  f"version at {band_words} band words ({err})")
            sweep_errors[f"{name} BW={band_words}"] = err
        sweep_errors[f"plain_cpu_s BW={band_words}"] = plain_s
    sweep_fields = {
        "tasks_per_width": SWEEP_CASES, "max_abs_err": sweep_errors,
        "routed_past_register": "multi-warp at SWEEP_WIDE_BANDS, cluster "
                                f"at {WIDE_BAND_WORDS}",
        "plain_wait_s": sweep_wait_s,
    }

    # ---- K2 (test_pallas_myers.py's generator, then every instance of
    # G lanes per task at W = 1..8 on full_myers_operands, then a timing
    # shape of 2048 inner nodes of 172 chars)
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
    k2_instances = {}
    for words, lanes in sorted(cuda_myers.LANES_FOR_WORDS.items()):
        args = full_myers_operands(rng, 75, words, True, device)
        _, _, err = compare(cuda_myers.myers_small_cuda,
                            cuda_myers.myers_small_plain, args)
        check(err == 0, f"K2 at W={words} (G={lanes}) differs from its "
              f"plain version ({err})")
        k2_instances[f"W={words} G={lanes}"] = err
    patterns, texts = small_cases(rng, 2048, 172, 173)
    args2 = small_args(patterns, texts)
    _, _, err2t = compare(cuda_myers.myers_small, cuda_myers.myers_small_plain,
                          args2)
    check(err2t == 0, f"K2 differs from its plain version ({err2t})")
    k2_ms = cuda_ms(lambda: cuda_myers.myers_small(*args2), 20)
    t0 = time.monotonic()
    cuda_myers.myers_small_plain(*args2)
    torch.cuda.synchronize()
    k2_bound = full_bound(args2, peaks)
    # the launch lasts as long as its longest task: tlen - 1 columns
    k2_columns = int(args2[3].max()) - 1
    rows["K2"] = {
        "name": "myers_small", "route": "cuda",
        "source": cuda_myers.SOURCE, "replaces": cuda_myers.REPLACES,
        "max_abs_err": max(err2, err2t, *k2_instances.values()),
        "ms": k2_ms, "plain_ms": (time.monotonic() - t0) * 1000,
        **bound_fields(k2_bound), "bound_share": k2_bound[0] / k2_ms,
        "shape": "B=2048 m=172 n=172..231 W=6 G=8", "columns": k2_columns,
        "us_per_col": k2_ms * 1000 / k2_columns,
        "instances_max_abs_err": k2_instances,
    }

    # ---- K3 (test_pallas_myers_large.py's generator at Wp = 128; the
    # register kernel at every instance on full_myers_operands, tasks of
    # 1 to R groups in one launch, and the shared-memory kernel at
    # WIDE_LARGE_WORDS; then both kernels timed in turns at a timing shape
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
    k3_instances = {}
    # the widths past the register kernel's: their cases and plain
    # versions come from the sweep's worker processes
    waited = time.monotonic()
    large_results = dict(zip((words for words, _ in large_sweep),
                             large_plain.get(timeout=600)))
    large_wait_s = time.monotonic() - waited
    wide_arrays = dict(large_sweep)
    for words in (*cuda_myers_large.REGISTER_WORDS,
                  *(words for words, _ in large_sweep)):
        if words in cuda_myers_large.REGISTER_WORDS:
            args = full_myers_operands(rng, LARGE_CASES, words, False, device)
            kernels = ("register", "shared")
            want = [t.cpu().numpy() for t in
                    cuda_myers_large.myers_large_plain(*args)]
        else:
            args = tuple(to_dev(a) for a in wide_arrays[words])
            kernels = ("cluster", "shared")
            want, _ = large_results[words]
            # the pattern state through the routing entry, counted alone:
            # it must take the cluster kernel
            reset_launches()
            cuda_myers_large.myers_large(*args)
            torch.cuda.synchronize()
            routed = launch_split(cuda_myers_large)
            check(routed == (0, 1, 0), f"{words} pattern words took the K3 "
                  f"kernels {K3_SPLIT} {routed} times")
        for name in kernels:
            kernel = getattr(cuda_myers_large, f"myers_large_{name}")
            got = [t.cpu().numpy() for t in kernel(*args)]
            err = max(int(np.max(np.abs(g.astype(np.int64) - w)))
                      for g, w in zip(got, want))
            check(err == 0, f"K3's {name} kernel differs from its plain "
                  f"version at Wp={words} ({err})")
            k3_instances[f"{name} Wp={words}"] = err
    patterns, texts = small_cases(rng, 256, 1376, 1377)
    args3 = large_args(patterns, texts, 128)
    want = [t.cpu().numpy()
            for t in cuda_myers_large.myers_large_plain(*args3)]
    err3t = 0
    for name in ("register", "shared"):
        kernel = getattr(cuda_myers_large, f"myers_large_{name}")
        got = [t.cpu().numpy() for t in kernel(*args3)]
        err3t = max(err3t, *(int(np.max(np.abs(g.astype(np.int64) - w)))
                             for g, w in zip(got, want)))
    check(err3t == 0, f"K3 differs from its plain version ({err3t})")
    # both kernels on the same operands, in turns: shared, register,
    # register, shared
    turns = {"register": [], "shared": []}
    for name in ("shared", "register", "register", "shared"):
        kernel = getattr(cuda_myers_large, f"myers_large_{name}")
        turns[name].append(cuda_ms(lambda: kernel(*args3), 10))
    t0 = time.monotonic()
    cuda_myers_large.myers_large_plain(*args3)
    torch.cuda.synchronize()
    plain3_ms = (time.monotonic() - t0) * 1000
    k3_bound = full_bound(args3, peaks)
    k3_columns = int(args3[3].max()) - 1
    # the table's K3 row: the register kernel, the shared-memory kernel's
    # turns beside it
    ms = sum(turns["register"]) / 2
    rows["K3"] = {
        "name": "myers_large_reg", "route": "cuda",
        "source": cuda_myers_large.SOURCE,
        "replaces": cuda_myers_large.REPLACES,
        "max_abs_err": max(err3, err3t, *k3_instances.values()),
        "ms": ms, "turns_ms": turns["register"], "plain_ms": plain3_ms,
        **bound_fields(k3_bound), "bound_share": k3_bound[0] / ms,
        "shape": "B=256 m=1376 n=1376..1435 Wp=128 (R=4, 2 groups)",
        "columns": k3_columns, "us_per_col": ms * 1000 / k3_columns,
        "shared_turns_ms": turns["shared"],
        "instances_max_abs_err": k3_instances,
        "sweep_plain_wait_s": large_wait_s,
    }
    return rows, k1_ends, sweep_fields


def run_long_shapes(device, peaks):
    """The routed kernels at pass E's shapes, each timed in turns with the
    shared-memory kernel on the same operands (shared, routed, routed,
    shared) and held to it and to the native host engine: K1's multi-warp
    kernel at LONG_ROOT_SHAPE on each of its band widths and K3's cluster
    kernel (K3u, on its pick of blocks for the shape's tasks) at
    OVERHANG_SHAPE; each width once through the routing entry with the
    counts at 0. The plain versions run once on the CPU in workers, on
    K1's first width and on K3's shape, and every kernel there equals
    them. Returns the table rows K1w, K1s, K3s and the phase's fields
    (K3u's time at this shape among them; its row is its 100 kb
    shape's)."""
    import numpy as np
    import torch

    from floxer_tpu_torch.native import native_myers_distance_batch
    from floxer_tpu_torch.ops import cuda_myers_banded as k1
    from floxer_tpu_torch.ops import cuda_myers_large as k3
    from floxer_tpu_torch.ops.myers import u32_tensor

    threads = min(8, os.cpu_count() or 1)
    (patterns, texts), (patterns3, texts3) = long_shape_inputs()

    def turns_of(kernels, repeats):
        """{name: [ms per turn]}: the first kernel, the second twice, the
        first again."""
        first, second = kernels
        turns = {first: [], second: []}
        for name in (first, second, second, first):
            turns[name].append(cuda_ms(kernels[name], repeats[name]))
        return turns

    def mean(values):
        return sum(values) / len(values)

    def max_err(got, want):
        return max(int(np.max(np.abs(g.astype(np.int64) - w)))
                   for g, w in zip(got, want))

    errors = {"K1w": 0, "K1s": 0, "K3u": 0, "K3s": 0}
    rows = {}

    def record_plain(keys, field_row):
        """The CPU plain version's ms into the rows `keys` and the phase's
        fields."""
        def record(seconds):
            for key in keys:
                rows[key]["plain_ms"] = seconds * 1000
                rows[key]["plain_on"] = "cpu"
            field_row["plain_ms"] = seconds * 1000
            field_row["plain_on"] = "cpu"
        return record

    # ---- K1: the long reads' roots, on each band width
    T, m, k, extra, widths = LONG_ROOT_SHAPE
    check(all(len(t) - len(p) + 2 * k + 1 <= 32 * min(widths)
              for p, t in zip(patterns, texts)),
          "a long root's band does not fit its width")
    native = native_myers_distance_batch(
        texts, patterns, num_threads=threads, budgets=[k] * T
    )
    check(bool((native[0] <= k).all()), "long roots must be within budget")
    texts_u8, lens = pad(texts)
    k1_fields = {}
    for band_words in widths:
        operands, num_text = k1.banded_operands(
            patterns, texts_u8, lens, np.full(T, k), band_words, device
        )
        args = (*operands, band_words, num_text)
        reset_launches()
        routed = [t.cpu().numpy() for t in k1.myers_banded(*args)]
        check(launch_split(k1) == (0, 1, 0, 0), f"a {band_words}-word long "
              f"root took the K1 kernels {launch_split(k1)}")
        references = [native, routed]
        kernels = {"shared": functools.partial(k1.myers_banded_shared, *args),
                   "wide": functools.partial(k1.myers_banded_wide, *args)}
        outputs = []
        for name, kernel in kernels.items():
            got = [t.cpu().numpy() for t in kernel()]
            outputs.append(got)
            err = max(max_err(got, want) for want in references)
            check(err == 0, f"K1 {name} differs from the native engine at "
                  f"the long root shape on {band_words} words ({err})")
            key = "K1s" if name == "shared" else "K1w"
            errors[key] = max(errors[key], err)
        if band_words == widths[0]:
            # the plain version runs on the CPU in a worker since the start
            long_k1_outputs = outputs
        turns = turns_of(kernels, {"shared": LONG_SHARED_REPEATS, "wide": 5})
        bound_ms, bound_by = k1_bound(args, peaks)
        columns = max(len(t) for t in texts) - 1
        k1_fields[f"BW={band_words}"] = {
            "bound_ms": bound_ms, "bound_by": bound_by, "columns": columns,
            **{name: {"ms": mean(turn), "turns_ms": turn,
                      "us_per_col": mean(turn) * 1000 / columns,
                      "bound_share": bound_ms / mean(turn)}
               for name, turn in turns.items()},
        }
    shape = (f"T={T} m={m} k={k} n~{m + extra + 200} "
             f"BW={widths[0]} (pass E's long roots)")
    first = k1_fields[f"BW={widths[0]}"]
    for key, name, label in (("K1w", "myers_banded_wide", "wide"),
                             ("K1s", "myers_banded_shared", "shared")):
        rows[key] = {
            "name": name, "route": "cuda",
            "source": k1.WIDE_SOURCE if key == "K1w" else k1.SOURCE,
            "replaces": k1.REPLACES, "max_abs_err": errors[key],
            "ms": first[label]["ms"], "plain_ms": None,
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": None, "shape": shape,
            "us_per_col": first[label]["us_per_col"],
        }
    CPU_PLAIN.expect("K1w and K1s at the long root shape",
                     CPU_PLAIN.results["long_k1"], long_k1_outputs,
                     record_plain(("K1w", "K1s"), first))

    # ---- K3: the overhanging reads' roots: the window's last `inside`
    # chars, mutated, then random chars up to m
    B, m3, inside, n3, words = OVERHANG_SHAPE
    padded, plen, txt, tlen = k3_overhang_operands(patterns3, texts3, words)
    args3 = (
        u32_tensor(padded, device),
        torch.from_numpy(plen).to(device),
        torch.from_numpy(txt).to(device),
        torch.from_numpy(tlen).to(device),
    )
    native3 = native_myers_distance_batch(texts3, patterns3,
                                          num_threads=threads)
    reset_launches()
    routed3 = [t.cpu().numpy() for t in k3.myers_large(*args3)]
    check(launch_split(k3) == (0, 1, 0), f"the {words}-word overhang roots "
          f"took the K3 kernels {launch_split(k3)}")
    blocks3 = k3.cluster_blocks(words, B, peaks["sm_count"])
    kernels3 = {"shared": functools.partial(k3.myers_large_shared, *args3),
                "cluster": functools.partial(k3.myers_large_cluster, *args3)}
    outputs3 = []
    for name, kernel in kernels3.items():
        got = [t.cpu().numpy() for t in kernel()]
        outputs3.append(got)
        err = max(max_err(got, want) for want in (native3, routed3))
        check(err == 0, f"K3 {name} differs from the native engine at the "
              f"overhang shape ({err})")
        errors["K3s" if name == "shared" else "K3u"] = err
    turns3 = turns_of(kernels3, {"shared": LONG_SHARED_REPEATS,
                                 "cluster": 5})
    bound3 = full_bound(args3, peaks)
    columns3 = int(tlen.max()) - 1
    k3_fields = {
        "bound_ms": bound3[0], "bound_by": bound3[1], "columns": columns3,
        "blocks_a_task": blocks3,
        "max_clusters": k3.cluster_max_clusters(device, words, blocks3),
        **{name: {"ms": mean(turn), "turns_ms": turn,
                  "us_per_col": mean(turn) * 1000 / columns3,
                  "bound_share": bound3[0] / mean(turn)}
           for name, turn in turns3.items()},
    }
    shape3 = (f"B={B} m={m3} n={n3} Wp={words} (pass E's overhanging "
              f"roots, {blocks3} blocks a task)")
    rows["K3s"] = {
        "name": "myers_large_shared", "route": "cuda", "source": k3.SOURCE,
        "replaces": k3.REPLACES, "max_abs_err": errors["K3s"],
        "ms": k3_fields["shared"]["ms"], "plain_ms": None,
        **bound_fields(bound3), "shape": shape3,
        "us_per_col": k3_fields["shared"]["us_per_col"],
    }
    CPU_PLAIN.expect("K3u and K3s at the overhang shape",
                     CPU_PLAIN.results["long_k3"], outputs3,
                     record_plain(("K3s",), k3_fields))
    fields = {"k1": {"shape": shape, **k1_fields},
              "k3": {"shape": shape3, **k3_fields}}
    return rows, fields


def array_error(got, want) -> int:
    """Largest absolute difference of two tuples of numpy arrays (a shape
    mismatch fails)."""
    import numpy as np

    err = 0
    for g, w in zip(got, want):
        check(np.shape(g) == np.shape(w),
              f"shapes {np.shape(g)} and {np.shape(w)} differ")
        if np.size(g):
            err = max(err, int(np.max(np.abs(np.asarray(g, np.int64)
                                             - np.asarray(w, np.int64)))))
    return err


def run_ultra_shapes(device, peaks):
    """The cluster kernels at their long shapes, each timed in turns with
    the shared-memory kernel on the same operands (cluster, shared,
    cluster; the shared kernel LONG_SHARED_REPEATS launches a turn) and
    held to it and to the native host engine: K1u at
    ULTRA_ROOT_SHAPE, K3u at ULTRA_OVERHANG_SHAPE; each once through the
    routing entry with the counts at 0. Returns the table rows K1u and K3u
    (their plain ms come from the sweep) and the phase's fields, each with
    its bound, its share and the share's ceiling (the SMs the launch's
    clusters hold)."""
    import numpy as np
    import torch

    from floxer_tpu_torch.native import native_myers_distance_batch
    from floxer_tpu_torch.ops import cuda_myers_banded as k1
    from floxer_tpu_torch.ops import cuda_myers_large as k3
    from floxer_tpu_torch.ops.myers import u32_tensor

    threads = min(8, os.cpu_count() or 1)
    (patterns, texts), (patterns3, texts3) = ultra_shape_inputs()

    def timed(kernels, columns, bound_and_by, blocks, tasks):
        """{kernel: {ms, turns_ms, us_per_col, bound_share}} in turns
        (cluster, shared, cluster: the shared kernel takes seconds a launch
        at these shapes, so it is timed once) and the bound's fields."""
        turns = {"shared": [], "cluster": []}
        repeats = {"shared": LONG_SHARED_REPEATS, "cluster": 5}
        for name in ("cluster", "shared", "cluster"):
            turns[name].append(cuda_ms(kernels[name], repeats[name]))
        bound_ms, bound_by = bound_and_by
        fields = {"bound_ms": bound_ms, "bound_by": bound_by,
                  "columns": columns, "blocks_a_task": blocks,
                  "share_ceiling": min(1.0, tasks * blocks
                                       / peaks["sm_count"])}
        for name, turn in turns.items():
            ms = sum(turn) / len(turn)
            fields[name] = {"ms": ms, "turns_ms": turn,
                            "us_per_col": ms * 1000 / columns,
                            "bound_share": bound_ms / ms}
        fields["speedup"] = fields["shared"]["ms"] / fields["cluster"]["ms"]
        return fields

    def held(kernels, references, label):
        err = 0
        for name, kernel in kernels.items():
            got = [t.cpu().numpy() for t in kernel()]
            err = max(err, *(array_error(got, want) for want in references))
        check(err == 0, f"{label} differs from the native engine ({err})")
        return err

    # ---- K1u: 200 kb reads' roots
    T, m, k, extra, band_words = ULTRA_ROOT_SHAPE
    check(all(len(t) - len(p) + 2 * k + 1 <= 32 * band_words
              and 32 * (band_words - 128) < len(t) - len(p) + 2 * k + 1
              for p, t in zip(patterns, texts)),
          "a 200 kb root's band does not take its width")
    native = native_myers_distance_batch(texts, patterns,
                                         num_threads=threads,
                                         budgets=[k] * T)
    check(bool((native[0] <= k).all()), "200 kb roots must be within budget")
    texts_u8, lens = pad(texts)
    operands, num_text = k1.banded_operands(
        patterns, texts_u8, lens, np.full(T, k), band_words, device
    )
    args = (*operands, band_words, num_text)
    reset_launches()
    routed = [t.cpu().numpy() for t in k1.myers_banded(*args)]
    check(launch_split(k1) == (0, 0, 1, 0), f"a {band_words}-word 200 kb "
          f"root took the K1 kernels {launch_split(k1)}")
    kernels = {"shared": functools.partial(k1.myers_banded_shared, *args),
               "cluster": functools.partial(k1.myers_banded_cluster, *args)}
    err1 = held(kernels, [native, routed], "K1u or K1 shared at the 200 kb "
                                           "root shape")
    blocks = k1.cluster_blocks(band_words)
    k1_fields = timed(kernels, max(len(t) for t in texts) - 1,
                      k1_bound(args, peaks), blocks, T)
    k1_fields["max_clusters"] = k1.cluster_max_clusters(device, band_words,
                                                        blocks)
    shape = (f"T={T} m={m} k={k} n~{m + extra + 200} BW={band_words} "
             f"(200 kb roots, {k1_fields['blocks_a_task']} blocks a task)")

    # ---- K3u: 100 kb reads overhanging a chromosome's end
    B, m3, inside, n3, words = ULTRA_OVERHANG_SHAPE
    padded, plen, txt, tlen = k3_overhang_operands(patterns3, texts3, words)
    check(padded.shape[2] == words and -(-int(plen.max()) // 32) > 2048,
          "a 100 kb overhang root does not take its width")
    args3 = (
        u32_tensor(padded, device),
        torch.from_numpy(plen).to(device),
        torch.from_numpy(txt).to(device),
        torch.from_numpy(tlen).to(device),
    )
    native3 = native_myers_distance_batch(texts3, patterns3,
                                          num_threads=threads)
    reset_launches()
    routed3 = [t.cpu().numpy() for t in k3.myers_large(*args3)]
    check(launch_split(k3) == (0, 1, 0), f"the {words}-word 100 kb "
          f"overhang roots took the K3 kernels {launch_split(k3)}")
    kernels3 = {"shared": functools.partial(k3.myers_large_shared, *args3),
                "cluster": functools.partial(k3.myers_large_cluster, *args3)}
    err3 = held(kernels3, [native3, routed3], "K3u or K3 shared at the "
                                              "100 kb overhang shape")
    blocks3 = k3.cluster_blocks(words, B, peaks["sm_count"])
    k3_fields = timed(kernels3, int(tlen.max()) - 1, full_bound(args3, peaks),
                      blocks3, B)
    k3_fields["max_clusters"] = k3.cluster_max_clusters(device, words,
                                                        blocks3)
    shape3 = (f"B={B} m={m3} n={n3} Wp={words} (100 kb reads, {inside} "
              f"chars on the chromosome, {k3_fields['blocks_a_task']} "
              f"blocks a task)")
    rows = {}
    for key, module, name, fields, bound_of, err, at in (
        ("K1u", k1, "myers_banded_cluster", k1_fields, k1_fields, err1,
         shape),
        ("K3u", k3, "myers_large_cluster", k3_fields, k3_fields, err3,
         shape3),
    ):
        rows[key] = {
            "name": name, "route": "cuda", "source": module.CLUSTER_SOURCE,
            "replaces": module.REPLACES, "max_abs_err": err,
            "ms": fields["cluster"]["ms"], "plain_ms": None,
            "plain_on": "cpu", "bound_ms": bound_of["bound_ms"],
            "bound_by": bound_of["bound_by"], "library_ms": None,
            "shape": at, "us_per_col": fields["cluster"]["us_per_col"],
        }
    return rows, {"k1u": {"shape": shape, **k1_fields},
                  "k3u": {"shape": shape3, **k3_fields}}


def run_cluster_sweep(device, rows, cases, plain):
    """K1u and K3u at every CLUSTER_SWEEP_WIDTHS width against their plain
    versions, run on CPU copies of the same operands in the sweep workers
    (`plain`: the async results of _k1_plain and _k3_plain over `cases`);
    each width once through the routing entry with the counts at 0. The
    rows' plain ms and plain shape are the workers' at 3200 words; their
    max_abs_err takes the sweep's."""
    import numpy as np
    import torch

    from floxer_tpu_torch.ops import cuda_myers_banded as k1
    from floxer_tpu_torch.ops import cuda_myers_large as k3

    waited = time.monotonic()
    k1_plain, k3_plain = (result.get(timeout=900) for result in plain)
    fields = {"plain_wait_s": time.monotonic() - waited}
    for key, module, kernel, entry, case_list, results in (
        ("K1u", k1, k1.myers_banded_cluster, k1.myers_banded, cases[0],
         k1_plain),
        ("K3u", k3, k3.myers_large_cluster, k3.myers_large, cases[1],
         k3_plain),
    ):
        errors = {}
        for case, (want, plain_s) in zip(case_list, results):
            width, arrays = case[0], case[1]
            args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in arrays]
            args = (*args, width, case[2]) if key == "K1u" else tuple(args)
            reset_launches()
            routed = [t.cpu().numpy() for t in entry(*args)]
            torch.cuda.synchronize()
            check(launch_split(module) == tuple(
                      int(name == "cluster") for name in split_kernels(module)),
                  f"{width} words took the {key[:2]} kernels "
                  f"{launch_split(module)}")
            got = [t.cpu().numpy() for t in kernel(*args)]
            err = max(array_error(got, want), array_error(routed, want))
            check(err == 0, f"{key} differs from its plain version at "
                  f"{width} words ({err})")
            errors[f"{width}"] = {"max_abs_err": err, "plain_cpu_s": plain_s,
                                  "tasks": len(want[0])}
            if width == 3200:
                rows[key]["plain_ms"] = plain_s * 1000
                rows[key]["plain_shape"] = (
                    f"{len(want[0])} tasks of at most "
                    f"{CLUSTER_SWEEP_COLUMNS} columns at 3200 words")
        rows[key]["max_abs_err"] = max(
            rows[key]["max_abs_err"],
            *(e["max_abs_err"] for e in errors.values()))
        fields[key] = errors
    return fields


def traceback_bound(batch, peaks) -> tuple[float, str]:
    """K4's bound on a packed batch: TRACEBACK_OPS per band cell of every
    task's rows; bytes: its inputs (chars, table) read once, its outputs
    (ops, num_ops, begin_cols) written once."""
    from floxer_tpu_torch.ops import traceback_device as td

    table = batch.table
    widths = 2 * table[:, td.DISTANCE].clip(min=0) + 1
    cells = int((table[:, td.M_LEN] * widths).sum())
    nbytes = (batch.windows.nbytes + batch.patterns.nbytes + table.nbytes
              + batch.ops_total + 8 * table.shape[0])
    return bound(TRACEBACK_OPS * cells, nbytes, peaks)


def k4_ptxas() -> dict:
    """ptxas -v of K4's kernel in the aligner's build (one kernel, every
    layout a branch of it); a spill or a stack frame fails the run."""
    from floxer_tpu_torch.ops import _build

    usage = _build.ALIGNER.ptxas_usage()
    names = [name for name in usage if "traceback_kernel" in name]
    check(len(names) == 1, f"K4's kernel is compiled as {names}")
    found = usage[names[0]]
    check(found.get("spill_stores", 1) == 0
          and found.get("spill_loads", 1) == 0
          and found.get("stack", 1) == 0,
          f"traceback_kernel spills or keeps a stack frame: {found}")
    return {"traceback_kernel": found}


def k4_packed(device, tasks):
    """A packed batch of tasks and the wrapper's arguments on the card."""
    import torch

    from floxer_tpu_torch.ops import traceback_device as td

    batch = td.pack_batch(tasks)
    return batch, tuple(torch.from_numpy(a).to(device)
                        for a in (batch.windows, batch.patterns,
                                  batch.table)) + (batch,)


def k4_against_plain(args, key, row):
    """K4's outputs on the card, held for its plain version, which runs on
    the CPU in a worker since the start on the same tasks (k4_plain_tasks
    of `key`); settle() compares them and puts the CPU ms in `row`."""
    from floxer_tpu_torch.ops import traceback_device as td

    kernel_out = [t.cpu().numpy() for t in td.banded_traceback(*args)]

    def record(seconds):
        row["plain_ms"] = seconds * 1000
        row["plain_on"] = "cpu"

    CPU_PLAIN.expect(f"{key} (K4)", CPU_PLAIN.results[key], [kernel_out],
                     record)


def k4_timed(args, batch, peaks, repeats=3) -> dict:
    """K4's ms on a packed batch, with the walk and without it (the rows
    alone), its bound and its tasks by layout."""
    from floxer_tpu_torch.ops import traceback_device as td

    ms = cuda_ms(lambda: td.banded_traceback(*args), repeats)
    rows_ms = cuda_ms(lambda: td.banded_traceback(*args, walk=False), repeats)
    bound_ms, bound_by = traceback_bound(batch, peaks)
    return {"ms": ms, "rows_ms": rows_ms, "walk_share": (ms - rows_ms) / ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "tasks": int(batch.table.shape[0]), "layouts": batch.layouts(),
            "threads": batch.threads,
            "widths": [int(2 * max(d, 0) + 1)
                       for d in batch.table[:, td.DISTANCE]]}


def host_tracebacks(tasks):
    """The 8-thread host pool's tracebacks of tasks and its seconds."""
    from floxer_tpu_torch.ops import dp_reference

    started = time.monotonic()
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        host = list(pool.map(
            lambda task: dp_reference.banded_cigar_traceback(*task), tasks
        ))
    return host, time.monotonic() - started


def entry_batch(device, tasks):
    """The batched entry on tasks: (results, its seconds, its launches)."""
    import torch

    from floxer_tpu_torch.ops import traceback_device as td

    torch.cuda.synchronize()
    td.LAUNCHES = 0
    started = time.monotonic()
    got = td.banded_cigar_traceback_device_batch(tasks, device)
    return got, time.monotonic() - started, td.LAUNCHES


def run_traceback_phase(device, peaks):
    """K4 at the 20 kb root shape: the whole seeded batch of accepted roots
    in exactly one launch, equal to the host traceback (native/traceback.cpp
    through dp_reference) on every task, timed against the 8-thread host
    pool; the kernel equal to its plain version on two tasks; its ms on
    those two and on the batch, each with its bound and its rows' time
    without the walk; the mixed batch (one 40 kb root at -p 0.15 among
    the 20 kb ones) in one launch, each task in its own layout. Then K4's
    wider layouts (K4_WIDE): each against its plain version on one task
    of about its timed band width, then on the tool's shape of 40 kb or
    80 kb roots at -p 0.15, equal to the host traceback there, timed with
    its bound. Returns the table rows."""
    from floxer_tpu_torch.ops import traceback_device as td
    from floxer_tpu_torch.tools import k4_bench

    tasks = k4_bench.shape_tasks("root20k", SEED)
    wanted = k4_bench.SHAPES["root20k"][0]
    check(len(tasks) >= wanted // 2,
          f"only {len(tasks)} root tasks within the budget")
    got, batch_s, batch_launches = entry_batch(device, tasks)
    check(batch_launches == 1,
          f"K4 took {batch_launches} launches for one batch, not 1")
    host, host_pool_s = host_tracebacks(tasks)
    mismatches = sum(g != h for g, h in zip(got, host))
    check(mismatches == 0, f"K4 differs from the host traceback on "
          f"{mismatches} of {len(tasks)} root tasks")

    # K4 against its plain version on two root-shape tasks (same inputs)
    pair, args = k4_packed(device, tasks[:2])
    err = 0
    two = k4_timed(args, pair, peaks)
    whole, whole_args = k4_packed(device, tasks)
    batch = k4_timed(whole_args, whole, peaks)

    # the mixed batch: one launch, every task in its own layout
    mixed_tasks = k4_bench.shape_tasks(k4_bench.MIXED, SEED)
    mixed_got, mixed_s, mixed_launches = entry_batch(device, mixed_tasks)
    check(mixed_launches == 1,
          f"K4 took {mixed_launches} launches for the mixed batch, not 1")
    mixed_host, mixed_pool_s = host_tracebacks(mixed_tasks)
    check(mixed_got == mixed_host,
          "K4 differs from the host traceback on the mixed batch")
    mixed_batch, mixed_args = k4_packed(device, mixed_tasks)
    mixed = k4_timed(mixed_args, mixed_batch, peaks)
    check(set(mixed["layouts"]) == {"reg8", "reg32"},
          f"the mixed batch ran in {mixed['layouts']}")
    rows = {"K4": {
        "name": "traceback_banded", "route": "cuda",
        "source": td.SOURCE, "replaces": td.REPLACES,
        "max_abs_err": err, "ms": two["ms"], "plain_ms": None,
        "bound_ms": two["bound_ms"], "bound_by": two["bound_by"],
        "library_ms": None,
        "shape": f"T=2 m={len(tasks[0][1])},{len(tasks[1][1])} "
                 f"d={tasks[0][3]},{tasks[1][3]}",
        "two": two, "batch": batch, "batch_launches": batch_launches,
        "host_equal_tasks": len(tasks),
        "batch_s": batch_s, "host_pool_s": host_pool_s,
        "mixed": {**mixed, "batch_s": mixed_s, "host_pool_s": mixed_pool_s,
                  "launches": mixed_launches},
        "ptxas": k4_ptxas(),
    }}
    k4_against_plain(args, "K4", rows["K4"])

    for key, name, layout, shape, (m, rate, budget) in K4_WIDE:
        plain_task = k4_plain_tasks(key)
        check(len(plain_task) == 1, f"{name}: no task within {budget}")
        one, one_args = k4_packed(device, plain_task)
        check(one.layouts() == {layout: 1},
              f"{name}'s plain task runs in {one.layouts()}")
        alone = k4_timed(one_args, one, peaks)
        shape_tasks = k4_bench.shape_tasks(shape, SEED)
        shape_got, shape_s, shape_launches = entry_batch(device, shape_tasks)
        check(shape_launches == 1,
              f"{name}: {shape_launches} launches for {shape}, not 1")
        check(shape_got == host_tracebacks(shape_tasks)[0],
              f"{name} differs from the host traceback on {shape}")
        timed_batch, timed_args = k4_packed(device, shape_tasks)
        timed = k4_timed(timed_args, timed_batch, peaks)
        check(timed["layouts"] == {layout: len(shape_tasks)},
              f"{shape} ran in {timed['layouts']}")
        rows[key] = {
            "name": name, "route": "cuda", "source": td.SOURCE,
            "replaces": td.REPLACES, "max_abs_err": 0,
            "ms": alone["ms"], "plain_ms": None,
            "bound_ms": alone["bound_ms"], "bound_by": alone["bound_by"],
            "library_ms": None,
            "shape": f"T=1 m={len(plain_task[0][1])} "
                     f"d={plain_task[0][3]}",
            "alone": alone, shape: {**timed, "batch_s": shape_s},
        }
        k4_against_plain(one_args, key, rows[key])
    return rows


def script_arrays(num_text):
    """The scripts' seeded inputs at num_text columns, as their entry points
    make them (numpy): K5's operands, the texts of K6-K8, K8's jstar."""
    from floxer_tpu_torch.scripts import ablate_banded_kernel as k5
    from floxer_tpu_torch.scripts import microbench_carry_scaling as k78
    from floxer_tpu_torch.scripts import microbench_column_loop as k6

    return (k5.script_inputs(num_text), k6.script_texts(num_text),
            k78.script_jstar(num_text))


def script_bounds(arrays, peaks) -> dict:
    """K5-K8's bound fields for their representative variants on
    script_arrays' `arrays`, per band word and column, counted as the
    constants above count: K5 `full` runs K1's column on every row's
    columns; K6 `elementwise` 20 x (xor, or, add, v1's add) plus the
    accumulating IADD3 (v1 is an array of 256 words; it was counted once a
    row until the kernel loaded its start values from a table); K7
    carry=10 ops=80 rolls=12 the char's xor and the carried sum's add (the
    carried arrays but the first are the same in every word), 80 x (shift,
    LOP3) and 12 xors; K8 bcast=18 one predicated xor per condition plus
    the char's add and y's add (y an array too), and each condition's
    compare once a row. K6 and K8 also read their start tables."""
    import numpy as np

    inputs, texts, jstar = arrays
    rows, num_text = texts.shape
    band_words = inputs[0].shape[1]
    word_cols = rows * band_words * num_text
    out_bytes = rows * band_words * 4
    table_bytes = band_words * 4  # a start table's row
    k5_ops = banded_ops(band_words, np.full(rows, num_text + 1),
                        inputs[4][:, 1], num_text)
    k5_bytes = sum(a.nbytes for a in inputs) + 8 * rows
    return {
        "K5": bound_fields(bound(k5_ops, k5_bytes, peaks)),
        "K6": bound_fields(bound((20 * 4 + 1) * word_cols,
                                 texts.nbytes + 3 * table_bytes + out_bytes,
                                 peaks)),
        "K7": bound_fields(bound((2 + 80 * 2 + 12) * word_cols,
                                 texts.nbytes + out_bytes, peaks)),
        "K8": bound_fields(bound((18 + 2) * word_cols + 18 * rows * num_text,
                                 texts.nbytes + jstar.nbytes
                                 + 2 * table_bytes + out_bytes, peaks)),
    }


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


def k5_width_cases(device):
    """(kernel, label, launch, plain) for every K5 variant at
    K5_OTHER_BAND_WORDS, on the script's inputs at that width and
    COMPARE_TEXT columns as tensors on `device`."""
    from floxer_tpu_torch.scripts import ablate_banded_kernel as k5

    cases = []
    for band_words in K5_OTHER_BAND_WORDS:
        operands = k5.device_operands(
            k5.script_inputs(COMPARE_TEXT, band_words), device
        )
        cases += [
            ("K5", f"{v} BW={band_words}",
             functools.partial(k5.ablate_banded, *operands, v),
             functools.partial(k5.ablate_banded_plain, *operands, v))
            for v in k5.VARIANTS
        ]
    return cases


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
    cpu = torch.device("cpu")
    _PLAIN_CASES = script_cases(cpu, arrays) + k5_width_cases(cpu)


def _plain_run(index):
    """One variant's plain version on the CPU: (outputs, seconds)."""
    plain = _PLAIN_CASES[index][3]
    started = time.monotonic()
    outputs = host_arrays(plain())
    return outputs, time.monotonic() - started


def start_full_width_plain(arrays):
    """The plain versions of every K5-K8 case on CPU copies of `arrays`,
    then of k5_width_cases, in PLAIN_WORKERS spawned processes (no CUDA),
    while the card runs on: (pool, async result of [(outputs, seconds)] in
    script_cases' order, then k5_width_cases'). The caller terminates the
    pool."""
    import multiprocessing

    from floxer_tpu_torch.scripts import ablate_banded_kernel as k5
    from floxer_tpu_torch.scripts import microbench_carry_scaling as k78
    from floxer_tpu_torch.scripts import microbench_column_loop as k6

    count = (len(k5.VARIANTS) * (1 + len(K5_OTHER_BAND_WORDS))
             + len(k6.VARIANTS) + len(k78.CONFIGS) + len(k78.BCASTS))
    pool = multiprocessing.get_context("spawn").Pool(
        min(PLAIN_WORKERS, os.cpu_count() or 1), _plain_init, (arrays,)
    )
    return pool, pool.map_async(_plain_run, range(count), chunksize=1)


def scripts_loop_floors() -> dict:
    """{(kernel, label): the fewest column-loop instructions} of K6's 3
    and K8's 4 instances: the work the function names on a lane's 8 words
    (a loop that folds words, as the shared-memory kernels' did, falls
    below): K6 `empty` an add a word, `elementwise` 20 x 3 a word (xor,
    or, add), `rolls` its 12 shuffles and an add a word (nvcc merges the
    ors of the loop-invariant v2 across rolls); K8 an add for each of x's
    and y's words and a predicated xor a word for each condition."""
    from floxer_tpu_torch.scripts import microbench_carry_scaling as k78

    floors = {("K6", "empty"): 8, ("K6", "elementwise"): 8 * 20 * 3,
              ("K6", "rolls"): 12 + 8}
    floors.update({("K8", f"bcast={b}"): 2 * 8 + 8 * b for b in k78.BCASTS})
    return floors


def scripts_ptxas() -> dict:
    """What ptxas -v reported in the scripts' build for K5's 27 instances
    (ablate_banded_kernel<R, F>: R = 4, 8, 12 words a lane, F each variant's
    sections), K6's 3 (column_loop_kernel<V>), K7's 8
    (carry_scaling_kernel<n_carry, n_ops, n_rolls>) and K8's 4
    (bcast_kernel<n_bcast>), with the instructions of their column loops
    (cuobjdump -sass). Fails on a missing instance, a spill or a stack
    frame; unless K7 holds its carried arrays in registers: carry=14 (ops
    and rolls 0) at least 80 registers above carry=3 and its column loop at
    least 2 instructions above for each of the 11 x 8 array words a lane it
    adds; and unless K6 and K8 keep no static shared memory and each holds
    one column loop of at least scripts_loop_floors' instructions."""
    from floxer_tpu_torch.ops import _build
    from floxer_tpu_torch.scripts import ablate_banded_kernel as k5
    from floxer_tpu_torch.scripts import microbench_carry_scaling as k78
    from floxer_tpu_torch.scripts import microbench_column_loop as k6

    usage = _build.SCRIPTS.ptxas_usage()
    loops = _build.sass_loops(_build.SCRIPTS.sass())
    flags = {sum(k5._FLAGS[s] for s in k5._sections_off(v)): v
             for v in k5.VARIANTS}
    report = {"K5": {}, "K6": {}, "K7": {}, "K8": {}}
    for name, found in usage.items():
        k5_match = re.search(r"ablate_banded_kernelILi(\d+)ELi(\d+)E", name)
        k6_match = re.search(r"column_loop_kernelILi(\d+)E", name)
        k7_match = re.search(
            r"carry_scaling_kernelILi(\d+)ELi(\d+)ELi(\d+)E", name)
        k8_match = re.search(r"bcast_kernelILi(\d+)E", name)
        if k5_match:
            r, f = map(int, k5_match.groups())
            key, kernel = f"BW={32 * r} {flags.get(f, f)}", "K5"
        elif k6_match:
            key, kernel = k6.VARIANTS[int(k6_match.group(1))], "K6"
        elif k7_match:
            key, kernel = "carry={} ops={} rolls={}".format(
                *k7_match.groups()), "K7"
        elif k8_match:
            key, kernel = f"bcast={k8_match.group(1)}", "K8"
        else:
            continue
        check(found.get("spill_stores", 1) == 0
              and found.get("spill_loads", 1) == 0
              and found.get("stack", 1) == 0,
              f"{kernel} {key} spills or keeps a stack frame: {found}")
        report[kernel][key] = {**found, "sass_loop_instructions": loops[name]}
    want_k5 = {f"BW={w} {v}" for w in k5.CUDA_BAND_WORDS for v in k5.VARIANTS}
    want_k7 = {"carry={} ops={} rolls={}".format(*c) for c in k78.CONFIGS}
    check(set(report["K5"]) == want_k5,
          f"K5's instances are {sorted(report['K5'])}")
    check(set(report["K7"]) == want_k7,
          f"K7's instances are {sorted(report['K7'])}")
    few, many = (report["K7"][f"carry={c} ops=0 rolls=0"] for c in (3, 14))
    check(many["registers"] - few["registers"] >= 80,
          f"K7 at carry=14 takes {many['registers']} registers, carry=3 "
          f"{few['registers']}: the carried arrays are not in registers")
    check(len(few["sass_loop_instructions"]) == 1
          and len(many["sass_loop_instructions"]) == 1
          and many["sass_loop_instructions"][0]
          - few["sass_loop_instructions"][0] >= 2 * 11 * 8,
          f"K7's column loops at carry=3 and 14: "
          f"{few['sass_loop_instructions']}, "
          f"{many['sass_loop_instructions']}")
    floors = scripts_loop_floors()
    for kernel in ("K6", "K8"):
        check(set(report[kernel]) == {k for c, k in floors if c == kernel},
              f"{kernel}'s instances are {sorted(report[kernel])}")
    for (kernel, key), floor in floors.items():
        entry = report[kernel][key]
        check(entry.get("shared", 0) == 0,
              f"{kernel} {key} keeps {entry.get('shared')} bytes of shared "
              f"memory")
        check(len(entry["sass_loop_instructions"]) == 1
              and entry["sass_loop_instructions"][0] >= floor,
              f"{kernel} {key}'s column loops hold "
              f"{entry['sass_loop_instructions']} instructions, not one "
              f"loop of at least {floor}")
    return report


def k1_column_decomposition(k1_ends) -> dict:
    """K5's nine variants on K1's root operands (from_banded_operands, at
    each root band of `k1_ends`), timed in turns with K1's register kernel
    on the same tasks: K1, the variants, the variants reversed, K1
    (K5_ROOT_REPEATS launches a turn). Each variant's ms and us per column
    (K5 runs all of every row's num_text columns) and its difference from
    `full`: that section's cost in the column K1 runs."""
    from floxer_tpu_torch.ops import cuda_myers_banded
    from floxer_tpu_torch.scripts import ablate_banded_kernel as k5

    out = {}
    for key, (args, _) in k1_ends.items():
        if not key.startswith("root"):
            continue
        operands = k5.from_banded_operands(*args[:5])
        num_text = operands[2].shape[1]
        runs = {"K1": functools.partial(
            cuda_myers_banded.myers_banded_register, *args)}
        for v in k5.VARIANTS:
            runs[v] = functools.partial(k5.ablate_banded, *operands, v)
        turns = {name: [] for name in runs}
        for name in ["K1", *k5.VARIANTS, *reversed(k5.VARIANTS), "K1"]:
            turns[name].append(cuda_ms(runs[name], K5_ROOT_REPEATS))
        ms = {name: sum(turn) / len(turn) for name, turn in turns.items()}
        scalars = args[4].cpu().numpy()
        k1_columns = int(
            scalars[:, cuda_myers_banded.COL_TLEN].max()) - 1
        out[key] = {
            "tasks": int(args[0].shape[0]), "k5_columns": num_text,
            "k1_columns": k1_columns,
            "K1": {"ms": ms["K1"], "turns_ms": turns["K1"],
                   "us_per_col": ms["K1"] * 1000 / k1_columns},
            "full_over_K1": ms["full"] / ms["K1"],
            "variants": {
                v: {"ms": ms[v], "turns_ms": turns[v],
                    "us_per_col": ms[v] * 1000 / num_text,
                    "minus_full_ms": ms[v] - ms["full"],
                    "minus_full_us_per_col":
                        (ms[v] - ms["full"]) * 1000 / num_text}
                for v in k5.VARIANTS
            },
        }
    return out


def run_scripts_phase(device, scripts_build, k1_row, k1_ends, full_arrays,
                      full_plain, peaks):
    """K5-K8: every variant against its plain version at COMPARE_TEXT
    columns on the card (K5 at 256 band words there, and at
    K5_OTHER_BAND_WORDS against the plain versions in the CPU workers);
    K5 `full` at K1's end columns on K1's operands (128 words, and the
    root shape on 256 and 384); K5's variants on K1's root operands timed
    in turns with K1's register kernel (k1_column_decomposition); every
    variant timed at the scripts' full width on `full_arrays`, its output
    held against `full_plain` (the plain versions on CPU copies of the
    same arrays); K5-K8's ptxas and column loops (scripts_ptxas);
    then the three entry points' main() with the launch counts set to 0
    just before. Returns (phase fields, table rows)."""
    import numpy as np
    import torch

    from floxer_tpu_torch.ops import _build
    from floxer_tpu_torch.scripts import NUM_TEXT
    from floxer_tpu_torch.scripts import ablate_banded_kernel as k5
    from floxer_tpu_torch.scripts import microbench_carry_scaling as k78
    from floxer_tpu_torch.scripts import microbench_column_loop as k6

    scripts_build.result()  # re-raises a failed build
    ptxas = scripts_ptxas()
    variants = {}
    compare_arrays = script_arrays(COMPARE_TEXT)
    for kernel, label, launch, plain in script_cases(device, compare_arrays):
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
    for key, (args, k1_end) in k1_ends.items():
        _, end = k5.ablate_banded(*k5.from_banded_operands(*args[:5]), "full")
        check(np.array_equal(end.cpu().numpy(), k1_end),
              f"K5 full and K1 end columns differ ({key}, "
              f"{len(k1_end)} tasks)")
    decomposition = k1_column_decomposition(k1_ends)
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
    width_cases = k5_width_cases(device)
    width_outputs = [host_arrays(launch()) for _, _, launch, _ in width_cases]
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
    k5_widths = {}
    for (_, label, launch, _), got, (want, seconds) in zip(
        width_cases, width_outputs, plain_results[len(full_outputs):]
    ):
        err = max(int(np.max(np.abs(g - w))) for g, w in zip(got, want))
        check(err == 0, f"K5 {label} differs from its plain version ({err})")
        k5_widths[label] = {
            "max_abs_err": err, f"ms_{COMPARE_TEXT}": cuda_ms(launch, 5),
            f"plain_cpu_s_{COMPARE_TEXT}": seconds,
        }
    for band_words in K5_OTHER_BAND_WORDS:
        full_w, r4_w = (width_outputs[[c[1] for c in width_cases].index(
            f"{v} BW={band_words}")] for v in ("full", "r4"))
        check(all(np.array_equal(a, b) for a, b in zip(full_w, r4_w)),
              f"K5 full and r4 differ at {band_words} band words")

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
    bounds = script_bounds(compare_arrays, peaks)
    for kernel, name, module, replaces, representative in (
        ("K5", "ablate_banded", k5, k5.REPLACES, "full"),
        ("K6", "column_loop", k6, k6.REPLACES, "elementwise"),
        ("K7", "carry_scaling", k78, k78.REPLACES, "carry=10 ops=80 rolls=12"),
        ("K8", "bcast", k78, k78.BCAST_REPLACES, "bcast=18"),
    ):
        rows = [v for (k, _), v in variants.items() if k == kernel]
        rep = variants[(kernel, representative)]
        errors = [max(r["max_abs_err"], r[f"max_abs_err_{NUM_TEXT}"])
                  for r in rows]
        if kernel == "K5":
            errors += [r["max_abs_err"] for r in k5_widths.values()]
        table[kernel] = {
            "name": name, "route": "cuda", "source": module.SOURCE,
            "replaces": replaces, "launches": launches[kernel],
            "max_abs_err": max(errors),
            "ms": rep[f"ms_{COMPARE_TEXT}"],
            "plain_ms": rep[f"plain_ms_{COMPARE_TEXT}"],
            **bounds[kernel],
        }
    def build_rows(kernel):
        return {
            label: {"us_per_col": variants[(kernel, label)]["us_per_col"],
                    "registers": entry["registers"],
                    "sass_loop_instructions":
                        entry["sass_loop_instructions"]}
            for label, entry in ptxas[kernel].items()
        }

    k7_build = build_rows("K7")
    k6_k8_build = {"K6": build_rows("K6"), "K8": build_rows("K8")}
    fields = {
        "nvcc_seconds": _build.SCRIPTS.last_build_seconds,
        "library": str(_build.SCRIPTS.path().relative_to(ROOT)),
        "shape": f"rows=32 BW=256 compare on the card at n={COMPARE_TEXT}, "
                 f"timed and compared with the plain versions on the CPU "
                 f"at n={NUM_TEXT}; K5 also at BW={K5_OTHER_BAND_WORDS} "
                 f"n={COMPARE_TEXT} against the plain versions on the CPU",
        "plain_wait_s": plain_wait_s,
        "k5_full_at_k1_end_tasks": {
            key: len(end) for key, (_, end) in k1_ends.items()
        },
        "k1_us_per_col_bw256": {
            name: k1_row["root"]["BW=256"][name]["us_per_col"]
            for name in ("register", "shared")
        },
        "k5_full_us_per_col": variants[("K5", "full")]["us_per_col"],
        "k1_column_decomposition": decomposition,
        "k5_widths": k5_widths,
        "k7_build": k7_build,
        "k6_k8_build": k6_k8_build,
        "ptxas": ptxas,
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
        cuda_fm_index,
        cuda_frontier,
        cuda_myers,
        cuda_myers_banded,
        cuda_myers_large,
        cuda_search_queue,
        cuda_select,
        cuda_sharded,
        traceback_device,
    )
    from floxer_tpu_torch.scripts import (
        ablate_banded_kernel,
        microbench_carry_scaling,
        microbench_column_loop,
    )

    for module in (cuda_myers, traceback_device, ablate_banded_kernel,
                   microbench_column_loop, cuda_search_queue, cuda_frontier,
                   cuda_select):
        module.LAUNCHES = 0
    cuda_frontier.SHARDED_LAUNCHES = 0
    cuda_search_queue.SPILL_LAUNCHES = 0
    for module in (cuda_fm_index, cuda_sharded):
        module.RANK_LAUNCHES = 0
        module.LOCATE_LAUNCHES = 0
    cuda_fm_index.EXTEND_LAUNCHES = 0
    traceback_device.LAYOUT_LAUNCHES.clear()
    for module in (cuda_myers_banded, cuda_myers_large):
        for name in split_kernels(module):
            setattr(module, f"{name.upper()}_LAUNCHES", 0)
        module.CLUSTER_WIDTHS.clear()
        module.LONG_TASKS.clear()
    microbench_carry_scaling.CARRY_LAUNCHES = 0
    microbench_carry_scaling.BCAST_LAUNCHES = 0


# K1's and K3's kernels, in launch_split's order (K3 has no one-block
# multi-warp kernel: its cluster kernel takes every width past the
# register kernel's)
K1_SPLIT = ("register", "wide", "cluster", "shared")
K3_SPLIT = ("register", "cluster", "shared")


def split_kernels(module) -> tuple[str, ...]:
    """K1's or K3's kernels, by the wrapper module."""
    return K1_SPLIT if module.__name__.endswith("banded") else K3_SPLIT


def launch_split(module) -> tuple[int, ...]:
    """K1's or K3's launches by kernel, in split_kernels' order."""
    return tuple(getattr(module, f"{name.upper()}_LAUNCHES")
                 for name in split_kernels(module))


def run_logged_launches(logfile: Path) -> dict:
    """Kernel launches of one run, from its stage split line."""
    _, split = align_seconds(logfile)
    check("launches=" in split, f"no launch counts in {logfile}")
    field = split.split("launches=")[1].split()[0]
    return {k: int(v) for k, v in (item.split(":") for item in field.split(","))}


class E2E:
    """A simulated workload and its runs (by default the 20 kb one); pass
    B (native host engine only) is the oracle every other pass is held
    to."""

    def __init__(self, workdir: Path, num_reads: int, genome_bp=4_600_000,
                 read_len=20_000, read_error=0.07, query_error=0.08):
        from floxer_tpu_torch.tools.simulated_dataset import main as simulate

        workdir.mkdir(exist_ok=True)
        self.workdir = workdir
        self.num_reads = num_reads
        self.read_len = read_len
        self.read_error = read_error
        self.query_error = query_error
        self.genome = workdir / "genome.fasta"
        self.reads = workdir / "reads.fastq"
        check(simulate([
            "create", "-g", str(self.genome), "-r", str(self.reads),
            "-c", str(genome_bp), "-n", "1", "-l", str(read_len),
            "-m", str(num_reads), "-e", str(read_error), "-s", str(SEED),
        ]) == 0, "simulated_dataset create failed")

    def argv(self, name, extra=()):
        return [
            "--reference", str(self.genome), "--queries", str(self.reads),
            "--index", str(self.workdir / "index.npz"),
            "--output", str(self.workdir / f"{name}.sam"),
            "--logfile", str(self.workdir / f"{name}.log"),
            "-p", str(self.query_error), "--interval-optimization",
            "--threads", "4", "--batch-size", "100", *extra,
        ]

    def run_host_pass(self) -> None:
        """Pass B: the native host engine only (no torch kernel); it also
        builds and saves the index every pass loads."""
        from floxer_tpu_torch import pipeline
        from floxer_tpu_torch.cli import parse_and_validate

        cli = parse_and_validate(self.argv("pass_b"))
        check(pipeline.run(cli, use_device=False) == 0,
              f"pass B in {self.workdir.name} failed")

    def sam(self, name) -> bytes:
        return (self.workdir / f"{name}.sam").read_bytes()

    def seconds(self, name) -> float:
        return align_seconds(self.workdir / f"{name}.log")[0]

    def run_device_pass(self, name, extra=(), env=None, engine="device",
                        oracle="pass_b"):
        """One --engine `engine` (device by default) run in this process
        with the launch counts set to 0 just before it, its SAM held to
        `oracle`'s; (launches, fused dispatches). The launches
        also hold K1's and K3's split by kernel (K1_register, K1_wide,
        K1_cluster, K1_shared, and K3's likewise) and K4's launches by
        the layouts their blocks ran in (K4_reg8, K4_reg16, ...)."""
        from floxer_tpu_torch import pipeline, tracing
        from floxer_tpu_torch.__main__ import main
        from floxer_tpu_torch.ops import (
            cuda_myers_banded,
            cuda_myers_large,
            traceback_device,
        )

        env = env or {}
        os.environ.update(env)
        try:
            reset_launches()
            code = main(self.argv(name, ["--engine", engine, *extra]))
            launches = pipeline.kernel_launches()
            for kernel, module in (("K1", cuda_myers_banded),
                                   ("K3", cuda_myers_large)):
                for split, count in zip(split_kernels(module),
                                        launch_split(module)):
                    launches[f"{kernel}_{split}"] = count
            for layout, count in traceback_device.LAYOUT_LAUNCHES.items():
                launches[f"K4_{layout}"] = count
        finally:
            for key in env:
                del os.environ[key]
        check(code == 0, f"{name} failed")
        check(self.sam(name) == self.sam(oracle),
              f"{name} and {oracle} SAM files differ")
        return launches, tracing.last_job().counter(
            "verify.fused_dispatches")


def run_e2e(device, e2e: E2E):
    import torch

    from floxer_tpu_torch import pipeline, tracing

    e2e.run_host_pass()

    # pass A: every wave fused on the card. The warmup (kernel build and
    # one tiny launch per kernel) runs first, so the counts below are the
    # alignment's own launches.
    pipeline.start_device_warmup(device)
    pipeline.join_device_warmup()
    torch.cuda.synchronize()
    launches, fused = e2e.run_device_pass("pass_a")
    device_kernel_s = tracing.last_job().seconds("verify.device_wait")

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
    for name in ("K1", "K3"):
        check(launches[f"{name}_register"] == launches[name]
              and launches[f"{name}_shared"] == 0,
              f"pass A's {name} launches did not all take the register "
              f"kernel: {launches}")
    check(mapped > 0, "no read mapped")
    return result, launches


def max_error(got, want) -> int:
    """Largest absolute difference of two tensors or tuples of them (a
    shape mismatch fails)."""
    import torch

    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = 0
    for g, w in zip(got, want):
        check(g.shape == w.shape, f"shapes {g.shape} and {w.shape} differ")
        if g.numel():
            err = max(err, int((g.long() - w.long()).abs().max()))
    return err


def plain_seconds(fn):
    """(result, seconds) of one synchronized call of a plain version."""
    import torch

    torch.cuda.synchronize()
    started = time.monotonic()
    result = fn()
    torch.cuda.synchronize()
    return result, time.monotonic() - started


def events_ms(fn, repeats: int) -> float:
    """Mean milliseconds of fn() between CUDA events, each call timed
    alone (for a call that synchronizes itself, after one warm call)."""
    import torch

    fn()
    total = 0.0
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / repeats


def read_jobs(e2e: E2E, start: int, count: int | None = None):
    """The jobs (seeds, strand) of reads [start, start + count) of pass A's
    workload (count: --batch-size), both strands, as the searcher gets
    them."""
    import itertools

    from floxer_tpu_torch.cli import parse_and_validate
    from floxer_tpu_torch.io.sequence_io import Queries
    from floxer_tpu_torch.pipeline_host import prepare_query_tree

    cli = parse_and_validate(e2e.argv("chunk"))
    queries = Queries(cli.queries_path, cli.query_num_errors,
                      cli.query_error_probability, cli.pex_seed_num_errors)
    count = cli.batch_size if count is None else count
    jobs = []
    for query in itertools.islice(queries, start, start + count):
        _, seeds = prepare_query_tree(query, cli)
        jobs.append((seeds, query.rank_sequence))
        jobs.append((seeds, query.reverse_complement_rank_sequence))
    return jobs


def first_chunk(e2e: E2E, start: int = 0):
    """Pass A's first chunk of seeds (its first --batch-size reads, both
    strands; or the chunk of reads from `start`), as the searcher hands it
    to the work queue: (patterns of the
    seeds the card searches, their classes, SchemeTables, report
    capacity, largest error count, the chunk's seeds, their global ids,
    the chunk's ChunkSeedArrays, its jobs (seeds, strand) in order)."""
    import numpy as np

    from floxer_tpu_torch.search_device import chunk_operands, report_capacity
    from floxer_tpu_torch.search_host import assemble_chunk_seed_arrays

    jobs = read_jobs(e2e, start)
    arrays = assemble_chunk_seed_arrays(jobs)
    patterns, class_of, gids, tables, max_errors = chunk_operands(arrays)
    return (patterns, class_of.astype(np.int32), tables,
            report_capacity(patterns.shape[0]), max_errors,
            arrays.total_seeds, gids, arrays, jobs)


def frontier_inputs(arrays, jobs):
    """K11's two inputs from pass A's first chunk, as the port's paths
    build them: the largest per-query bucket of the first read's forward
    seeds (search_seeds: one (length, errors) class, the seed count padded
    to a power of two; frontier 2^14 states, 2^12 reports) and the first
    256-seed block of the legacy loop (2^15 states, 2^13 reports):
    {name: (padded [1, S, L], seed classes [1, S], tables, capacity,
    reports, max_iterations)}."""
    from floxer_tpu_torch.schemes import expand_scheme
    from floxer_tpu_torch import search_device as sd

    seeds, query = jobs[0]
    buckets = {}
    for seed in seeds:
        if seed.length <= sd._MAX_DEVICE_PATTERN:
            buckets.setdefault((seed.length, seed.num_errors), []).append(
                query[seed.query_position:seed.query_position + seed.length]
            )
    (length, errors), patterns = max(buckets.items(),
                                     key=lambda item: len(item[1]))
    padded, seed_class, tables, max_iterations = sd.frontier_operands(
        patterns, expand_scheme(errors, length), errors
    )
    blocks, block_classes, block_tables, block_iterations, _ = next(
        sd.legacy_blocks(arrays)
    )
    return {
        "per_query": (padded[None], seed_class[None], tables, 1 << 14,
                      1 << 12, max_iterations),
        "block": (blocks[:1], block_classes[:1], block_tables,
                  sd._BLOCK_FRONTIER, sd._BLOCK_REPORTS, block_iterations),
    }


def search_bodies(e2e: E2E, index, first_nodes: int) -> dict:
    """How often K9's and K9x's functions run inside other kernels on the
    CLI's passes, by running their searches again here: pass G's K10
    searches (one a chunk of --batch-size reads; the first chunk's nodes
    given), each expanded node two ranks (one interval rank), and pass
    H's K11 launches (the first PASS_H_READS reads, a launch a (length,
    errors) bucket of each strand's seeds, as search_seeds makes them),
    each expanded state one extension; and the seconds this replay
    takes."""
    import torch

    from floxer_tpu_torch import search_device as sd
    from floxer_tpu_torch import search_queue
    from floxer_tpu_torch.ops import cuda_search_queue as k10
    from floxer_tpu_torch.schemes import expand_scheme

    from floxer_tpu_torch.cli import parse_and_validate

    started = time.monotonic()
    nodes, generations = first_nodes, 0
    batch = parse_and_validate(e2e.argv("chunk")).batch_size
    for start in range(batch, e2e.num_reads, batch):
        padded, classes, tables, report_cap, max_errors = first_chunk(
            e2e, start)[:5]
        before = k10.LAUNCHES
        run = k10.workqueue_search_cuda(
            index, *(torch.from_numpy(a).to(index.device)
                     for a in (padded, classes, tables.fused())),
            tables.num_searches, tables.num_parts, report_cap,
            search_queue.key_words_needed(padded.shape[1], max_errors),
            search_queue.frames_needed(padded.shape[1], max_errors))
        check(not run.overflow, f"pass G's chunk at read {start} overflowed")
        nodes += run.nodes
        generations += k10.LAUNCHES - before
    states = launches = 0
    for seeds, query in read_jobs(e2e, 0, PASS_H_READS):
        buckets = {}
        for seed in seeds:
            buckets.setdefault((seed.length, seed.num_errors), []).append(
                query[seed.query_position:seed.query_position + seed.length])
        for (length, errors), patterns in buckets.items():
            if length > sd._MAX_DEVICE_PATTERN:
                continue
            padded, seed_class, tables, iterations = sd.frontier_operands(
                patterns, expand_scheme(errors, length), errors)
            out = sd.block_search(index, padded[None], seed_class[None],
                                  tables, 1 << 14, 1 << 12, iterations)
            states += int(out.expanded.sum())
            launches += 1
    return {"pass_g_k10_nodes": nodes, "pass_g_interval_ranks": nodes,
            "pass_g_later_chunks_generations": generations,
            "pass_h_k11_launches": launches,
            "pass_h_k11_expanded_states": states,
            "seconds": time.monotonic() - started}


def run_search_kernels(device, e2e: E2E, peaks):
    """K9, K9x and K9l against their plain versions on pass A's index at
    RANK_QUERIES queries (combined and planes layouts; K9x on random
    cursors and on the first chunk's search cursors, each set's share of
    one-block intervals printed, and timed on both), K10 against
    workqueue_search_plain on pass A's first chunk, K11 and K12 on it;
    each timed with its bound. Returns (table rows K9-K12, the phase's
    fields, K11's inputs (frontier_inputs) for run_sharded_kernels)."""
    import numpy as np
    import torch

    from floxer_tpu_torch import search_queue
    from floxer_tpu_torch.index.device_index import DeviceIndex
    from floxer_tpu_torch.index.fmindex import FmIndex
    from floxer_tpu_torch.ops import cuda_fm_index as k9
    from floxer_tpu_torch.ops import cuda_search_queue as k10
    from floxer_tpu_torch.search_device import _MAX_DEVICE_PATTERN
    from floxer_tpu_torch.tools.fm_bench import (
        same_block_share,
        search_cursors,
        seed_patterns,
    )

    host = FmIndex.load(e2e.workdir / "index.npz")
    n = host.n
    rng = np.random.default_rng(SEED + 9)
    B = RANK_QUERIES

    def to_dev(array):
        return torch.from_numpy(array.astype(np.int32)).to(device)

    positions = to_dev(rng.integers(0, n + 1, size=B))
    lb = rng.integers(0, n, size=B)
    lb_rev = rng.integers(0, n, size=B)
    length = np.minimum(rng.integers(0, 1 << 12, size=B),
                        n - np.maximum(lb, lb_rev))
    cursors = [to_dev(a) for a in (lb, lb_rev, length)]
    sa_rows = to_dev(rng.integers(0, n, size=B))
    fields, rows = {"genome_n": n, "queries": B}, {}
    # K9x's second cursor set: the cursors the first chunk's seeds meet
    # when each is extended backwards on the host index (fm_bench's
    # search_cursors), up to RANK_QUERIES of them
    chunk = first_chunk(e2e)
    started = time.monotonic()
    search = [to_dev(a) for a in search_cursors(host, seed_patterns(
        chunk[-1]), limit=B, seed=SEED + 9)]
    fields["search_cursors"] = {
        "count": int(search[0].shape[0]),
        "seconds": time.monotonic() - started,
        "same_block_share": same_block_share(*search),
        "random_same_block_share": same_block_share(*cursors)}
    for layout in ("combined", "planes"):
        index = DeviceIndex.from_host(host, device,
                                      force_planes=layout == "planes")
        fwd = index.fwd
        operands = (fwd.rank_rows, fwd.block_offset, fwd.occ, fwd.planes)
        table_bytes = (tensor_bytes(fwd.occ, fwd.planes)
                       if fwd.rank_rows is None
                       else 128 * (fwd.planes.shape[0]))
        errs = {}
        for single in (index.fwd, index.rev):
            args = (single.rank_rows, single.block_offset, single.occ,
                    single.planes)
            errs["K9"] = max(errs.get("K9", 0), max_error(
                k9.fm_rank_cuda(positions, *args),
                k9.fm_rank_plain(positions, *args)))
        for left in (True, False):
            for kind in (cursors, search):
                errs["K9x"] = max(errs.get("K9x", 0), max_error(
                    k9.fm_extend_cuda(index, *kind, left=left),
                    k9.fm_extend_plain(index, *kind, left=left)))
        located = k9.fm_locate_cuda(index, sa_rows, index.sampling_rate)
        errs["K9l"] = max_error(
            located, k9.fm_locate_plain(index, sa_rows, index.sampling_rate))
        for name, err in errs.items():
            check(err == 0, f"{name} differs from its plain version in the "
                            f"{layout} layout ({err})")
        fields[layout] = {"max_abs_err": errs}
        if layout != "combined":
            continue
        # the table rows: forward rank and left extension, locate
        seq_ids, offsets = (t.long() for t in located)
        text_positions = index.seq_starts.long()[seq_ids] + offsets
        steps = int((text_positions % index.sampling_rate).sum())
        seq_probes = PROBE_OPS * int(np.ceil(np.log2(
            index.seq_starts.shape[0] + 1)))
        kernels = {
            "K9": ("fm_rank", lambda: k9.fm_rank_cuda(positions, *operands),
                   lambda: k9.fm_rank_plain(positions, *operands),
                   RANK_OPS * B, 4 * B + 24 * B + table_bytes),
            "K9x": ("fm_extend",
                    lambda: k9.fm_extend_cuda(index, *cursors, left=True),
                    lambda: k9.fm_extend_plain(index, *cursors, left=True),
                    EXTEND_OPS * B, 12 * B + 72 * B + table_bytes),
            "K9l": ("fm_locate",
                    lambda: k9.fm_locate_cuda(index, sa_rows,
                                              index.sampling_rate),
                    lambda: k9.fm_locate_plain(index, sa_rows,
                                               index.sampling_rate),
                    locate_ops(steps, B, seq_probes),
                    4 * B + 8 * B + table_bytes
                    + tensor_bytes(fwd.bwt, index.sample_plane,
                                   index.sampled_values, index.seq_starts)),
        }
        Bs = search[0].shape[0]
        ms = cuda_ms(lambda: k9.fm_extend_cuda(index, *search, left=True),
                     20)
        fields["K9x_search"] = {
            "ms": ms, "queries": Bs,
            **bound_fields(bound(EXTEND_OPS * Bs,
                                 12 * Bs + 72 * Bs + table_bytes, peaks))}
        for key, (name, kernel, plain, ops, nbytes) in kernels.items():
            ms = cuda_ms(kernel, 20)
            _, plain_s = plain_seconds(plain)
            rows[key] = {
                "name": name, "route": "cuda", "source": k9.SOURCE,
                "replaces": k9.REPLACES[key], "max_abs_err": errs[key],
                "ms": ms, "plain_ms": plain_s * 1e3,
                **bound_fields(bound(ops, nbytes, peaks)),
                "shape": f"B={B} n={n} combined",
            }
        fields["K9l_lf_steps"] = steps

    # K10 on pass A's first chunk, the combined layout (the main path's)
    index = DeviceIndex.from_host(host, device)
    (padded, classes, tables, report_cap, max_errors, seeds, gids, arrays,
     jobs) = chunk
    eligible = padded.shape[0]
    before, spills_before = k10.LAUNCHES, k10.SPILL_LAUNCHES
    sorted_rows, overflow = search_queue.workqueue_runner(
        index, padded, classes, tables, report_cap, padded.shape[1],
        max_errors,
    )
    generations = k10.LAUNCHES - before
    check(generations == 1 + k10.SPILL_LAUNCHES - spills_before
          and not overflow,
          f"the runner made {generations} K10 launches, "
          f"{k10.SPILL_LAUNCHES - spills_before} of them later "
          f"generations, overflow {overflow}")
    operands = [torch.from_numpy(a).to(device)
                for a in (padded, classes, tables.fused())]
    kw = search_queue.key_words_needed(padded.shape[1], max_errors)
    frames = search_queue.frames_needed(padded.shape[1], max_errors)

    def kernel():
        return k10.workqueue_search_cuda(
            index, *operands, tables.num_searches, tables.num_parts,
            report_cap, kw, frames)

    run = kernel()
    got = search_queue.sort_reports(run.reports[:run.num_reports].cpu().numpy())
    init = padded.shape[0] * tables.num_searches
    # the wrapper whole (its allocations and its counter read included),
    # then the search on buffers allocated once (k10_times), at the wrapper's
    # budget and at each of K10_BUDGETS (the last spills nothing: each
    # root's tree on one thread), each held to the first run
    wrapper_ms = events_ms(kernel, 3)
    budgets = {}
    for budget in (k10.BUDGET, *K10_BUDGETS):
        prepared = k10.WorkqueueLaunch(
            index, *operands, tables.num_searches, tables.num_parts,
            report_cap, kw, frames, budget,
            None if budget == k10.BUDGET else K10_SWEEP_LIST * init)
        search_ms, budget_ms = k10_times(prepared)
        last = prepared.result()
        rows_of = search_queue.sort_reports(
            last.reports[:last.num_reports].cpu().numpy())
        check((last.overflow, last.nodes, last.largest_tree)
              == (run.overflow, run.nodes, run.largest_tree)
              and np.array_equal(rows_of, got),
              f"K10 at a budget of {budget} nodes differs from its run at "
              f"{k10.BUDGET}")
        budgets[budget] = {"ms": budget_ms, "search_ms": search_ms,
                           "spilled": last.spilled,
                           "launches": last.launches,
                           "list_peak": last.list_peak}
    ms = budgets[k10.BUDGET]["ms"]
    tail = k10_largest_root(k10, index, padded, classes, tables, report_cap,
                            kw, frames, run.largest_tree)
    quantum = search_queue.QUANTUM
    push = search_queue.PUSH_FACTOR * quantum
    plain, plain_s = plain_seconds(lambda: search_queue.workqueue_search_plain(
        index, *operands, tables.num_searches, tables.num_parts, quantum,
        push, 2 * init + push + quantum, report_cap, kw,
        search_queue.MAX_ITERATIONS,
    ))
    check(not run.overflow and not plain.overflow, "K10 or its plain "
          "version overflowed on pass A's first chunk")
    want = search_queue.sort_reports(
        plain.reports[:plain.num_reports].cpu().numpy())
    check(got.shape == want.shape and sorted_rows.shape == want.shape,
          f"K10 gave {got.shape[0]} rows ({sorted_rows.shape[0]} through "
          f"the runner), its plain version {want.shape[0]}")
    k10_err = max(max_error(torch.from_numpy(got), torch.from_numpy(want)),
                  max_error(torch.from_numpy(sorted_rows),
                            torch.from_numpy(want)))
    check(k10_err == 0, f"K10's sorted rows differ from its plain "
                        f"version's ({k10_err})")
    check(run.nodes == plain.nodes,
          f"K10 expanded {run.nodes} nodes, its plain version {plain.nodes}")
    nbytes = (tensor_bytes(index.rank_rows, *operands)
              + run.num_reports * (6 + kw) * 4)
    rows["K10"] = {
        "name": "workqueue_search", "route": "cuda", "source": k10.SOURCE,
        "replaces": k10.REPLACES, "max_abs_err": k10_err, "ms": ms,
        "plain_ms": plain_s * 1e3,
        **bound_fields(bound(SEARCH_OPS_PER_NODE * run.nodes, nbytes,
                             peaks)),
        "shape": f"pass A's first chunk: {eligible} seeds, "
                 f"{init} roots, pad {padded.shape[1]}",
    }
    fields["K10"] = {
        "chunk_seeds": seeds, "device_seeds": eligible,
        "long_seeds": seeds - eligible,
        "roots": init, "pad_len": padded.shape[1], "key_words": kw,
        "frames": frames, "nodes": run.nodes, "reports": run.num_reports,
        "largest_tree": run.largest_tree, "ms": ms,
        "wrapper_ms": wrapper_ms, "largest_root": tail,
        "budget": k10.BUDGET, "by_budget": budgets,
        "bound_ms": rows["K10"]["bound_ms"],
        "bound_by": rows["K10"]["bound_by"], "plain_ms": plain_s * 1e3,
        "grid_blocks": k10.resident_blocks(device),
    }
    fields["bodies"] = search_bodies(e2e, index, run.nodes)
    fields["bodies"]["pass_g_k10_launches"] = (
        generations + fields["bodies"].pop("pass_g_later_chunks_generations"))
    for key in ("K9", "K9x", "K9l"):
        fields[key] = {k: rows[key][k] for k in
                       ("ms", "plain_ms", "bound_ms", "bound_by")}

    index_path = str(e2e.workdir / "index.npz")
    inputs = frontier_inputs(arrays, jobs)
    rows["K11"], fields["K11"] = frontier_kernel_checks(
        index, index_path, inputs, peaks
    )
    # K12 on the groups the dedup and cap replay leave of the work queue's
    # reports (the long seeds are the native redo's)
    rep = np.empty((sorted_rows.shape[0], 5), dtype=np.int64)
    rep[:, 0] = gids[sorted_rows[:, 4]]
    rep[:, 1:] = sorted_rows[:, :4]
    redo = arrays.length_g > _MAX_DEVICE_PATTERN
    rows["K12"], fields["K12"] = select_kernel_checks(
        index, index_path, rep, redo, peaks
    )
    return rows, fields, inputs


def run_sharded_kernels(device, e2e: E2E, peaks, inputs):
    """K13 (both directions) at RANK_QUERIES positions, K13l at
    RANK_QUERIES SA rows and K11 over the shard tables on the legacy
    loop's first 256-seed block of pass A's first chunk, on pass A's index
    cut into each of SHARD_COUNTS shards: each one launch held exactly to
    its plain version on the same card tensors and to the unsharded
    kernel's output (K9, K9l, K11: K11's reports in order, count,
    overflow, iterations and expanded states), then timed (CUDA events)
    with its bound, K13l in turns with K9l on the same rows; K11 over the
    shards also on the per-query bucket (held to K11), and both inputs at
    every cluster size. Returns (table
    rows K13, K13l, K11s at SHARD_COUNTS[0] shards, the phase's
    fields)."""
    import numpy as np
    import torch

    from floxer_tpu_torch.index.device_index import (
        DeviceIndex,
        ShardedDeviceIndex,
    )
    from floxer_tpu_torch.index.fmindex import FmIndex
    from floxer_tpu_torch.ops import cuda_fm_index as k9
    from floxer_tpu_torch.ops import cuda_frontier as k11
    from floxer_tpu_torch.ops import cuda_sharded as k13
    from floxer_tpu_torch.ops.frontier import frontier_search_plain

    host = FmIndex.load(e2e.workdir / "index.npz")
    n = host.n
    rng = np.random.default_rng(SEED + 13)
    B = RANK_QUERIES

    def to_dev(array):
        return torch.from_numpy(array.astype(np.int32)).to(device)

    positions = to_dev(rng.integers(0, n + 1, size=B))
    sa_rows = to_dev(rng.integers(0, n, size=B))
    flat = DeviceIndex.from_host(host, device)
    want_rank = [k9.fm_rank_cuda(positions, s.rank_rows, s.block_offset,
                                 s.occ, s.planes)
                 for s in (flat.fwd, flat.rev)]
    want_located = k9.fm_locate_cuda(flat, sa_rows, flat.sampling_rate)
    padded, seed_class, tables, capacity, reports, max_iterations = (
        inputs["block"])
    operands = [torch.from_numpy(a).to(device)
                for a in (padded, seed_class, tables.fused())]
    search_args = (tables.num_searches, tables.num_parts, capacity, reports,
                   max_iterations)
    want_k11 = k11.frontier_search_cuda(flat, *operands, *search_args)
    # the per-query bucket (pass H2's shape) beside the block
    q_padded, q_classes, q_tables, q_capacity, q_reports, q_iterations = (
        inputs["per_query"])
    q_operands = [torch.from_numpy(a).to(device)
                  for a in (q_padded, q_classes, q_tables.fused())]
    q_args = (q_tables.num_searches, q_tables.num_parts, q_capacity,
              q_reports, q_iterations)
    want_q = k11.frontier_search_cuda(flat, *q_operands, *q_args)
    def k9l():
        return k9.fm_locate_cuda(flat, sa_rows, flat.sampling_rate)

    seq_ids, offsets = (t.long() for t in want_located)
    text_positions = flat.seq_starts.long()[seq_ids] + offsets
    steps = int((text_positions % flat.sampling_rate).sum())
    seq_probes = PROBE_OPS * int(np.ceil(np.log2(
        flat.seq_starts.shape[0] + 1)))
    fields, rows = {"genome_n": n, "queries": B, "lf_steps": steps}, {}
    for S in SHARD_COUNTS:
        index = ShardedDeviceIndex.from_host(host, S, device)
        fwd = index.fwd
        rank_args = (fwd.rank_rows, fwd.block_offset, fwd.shard_starts,
                     fwd.shard_lengths)
        errs = {"K13": 0}
        for single, want in zip((index.fwd, index.rev), want_rank):
            args = (single.rank_rows, single.block_offset,
                    single.shard_starts, single.shard_lengths)
            got = k13.fm_sharded_rank_cuda(positions, *args,
                                           single.shard_before)
            errs["K13"] = max(
                errs["K13"], max_error(got, want),
                max_error(got, k13.fm_sharded_rank_plain(positions, *args)))
        located = k13.fm_sharded_locate_cuda(index, sa_rows,
                                             index.sampling_rate)
        errs["K13l"] = max(
            max_error(located, want_located),
            max_error(located, k13.fm_sharded_locate_plain(
                index, sa_rows, index.sampling_rate)))

        def k11_kernel(index=index):
            return k11.frontier_search_cuda(index, *operands, *search_args)

        before = k11.SHARDED_LAUNCHES
        out = k11_kernel()
        check(k11.SHARDED_LAUNCHES == before + 1,
              "K11 over the shards took more than one launch")
        stats = {}
        plain, k11_plain_s = plain_seconds(lambda: frontier_search_plain(
            index, operands[0][0], operands[1][0], operands[2],
            *search_args, stats))
        errs["K11s"] = max(
            *(max_error(getattr(out, f), getattr(want_k11, f))
              for f in ("reports", "num_reports", "overflow", "iterations",
                        "expanded")),
            max_error(out.reports[0], plain[0]),
            abs(int(out.num_reports[0]) - plain[1]),
            max_error(out.overflow[0], plain[2]),
            abs(int(out.iterations[0]) - stats["iterations"]),
            abs(int(out.expanded[0]) - stats["expanded"]),
        )
        def per_query(index=index):
            return k11.frontier_search_cuda(index, *q_operands, *q_args)

        q_out = per_query()
        errs["K11s"] = max(errs["K11s"], *(
            max_error(getattr(q_out, f), getattr(want_q, f))
            for f in ("reports", "num_reports", "overflow", "iterations",
                      "expanded")))
        for name, err in errs.items():
            check(err == 0, f"{name} at {S} shards differs from its plain "
                            f"version or the unsharded kernel ({err})")
        check(not bool(out.overflow.any()),
              f"K11 over {S} shards overflowed on the block")

        # one direction's shard tables, each shard's rows once
        table_bytes = S * (index.rev_block_offset - 1) * 128
        ns = index.sampled_rows.shape[1]
        # K13l's work: a step is the owner's rank, its symbol, C and the
        # earlier shards' total (3), S owner tests and S sample-chunk
        # tests (2 S), and one binary search of one chunk of ns samples;
        # each row ends with one more chunk search, its S chunk tests and
        # the search of the sequence starts
        probes = PROBE_OPS * int(np.ceil(np.log2(ns + 1)))
        expanded = int(out.expanded[0])
        kernels = {
            "K13": ("fm_sharded_rank",
                    lambda: k13.fm_sharded_rank_cuda(positions, *rank_args,
                                                     fwd.shard_before),
                    lambda: k13.fm_sharded_rank_plain(positions, *rank_args),
                    20, sharded_rank_ops(S) * B,
                    4 * B + 24 * B + table_bytes
                    + tensor_bytes(fwd.shard_starts, fwd.shard_lengths,
                                   fwd.shard_before)),
            "K13l": ("fm_sharded_locate",
                     lambda: k13.fm_sharded_locate_cuda(
                         index, sa_rows, index.sampling_rate),
                     lambda: k13.fm_sharded_locate_plain(
                         index, sa_rows, index.sampling_rate),
                     20, steps * (RANK_OPS + 3 + 2 * S + probes)
                     + B * (probes + S + seq_probes),
                     4 * B + 8 * B + table_bytes
                     + tensor_bytes(fwd.bwt, index.sampled_rows,
                                    index.sampled_values, index.seq_starts)),
            "K11s": ("frontier_search_sharded", k11_kernel, None, 5,
                     (2 * sharded_rank_ops(S) + 76) * expanded,
                     tensor_bytes(index.rank_rows, *operands)
                     + int(out.num_reports[0]) * 5 * 4),
        }
        case = {"max_abs_err": errs, "rank_rows": list(index.rank_rows.shape),
                "shard_lengths": fwd.shard_lengths.tolist()}
        for key, (name, kernel, plain_fn, repeats, ops,
                  nbytes) in kernels.items():
            if key == "K13l":
                # in turns with K9l on the same rows: K9l, K13l, K9l
                k9l_ms = [cuda_ms(k9l, repeats)]
                ms = cuda_ms(kernel, repeats)
                k9l_ms.append(cuda_ms(k9l, repeats))
            else:
                ms = cuda_ms(kernel, repeats)
            plain_s = (k11_plain_s if plain_fn is None
                       else plain_seconds(plain_fn)[1])
            row = {
                "name": name, "route": "cuda",
                "source": k11.SOURCE if key == "K11s" else k13.SOURCE,
                "replaces": (k11.SHARDED_REPLACES if key == "K11s"
                             else k13.REPLACES[key]),
                "max_abs_err": errs[key], "ms": ms,
                "plain_ms": plain_s * 1e3,
                **bound_fields(bound(ops, nbytes, peaks)),
            }
            case[key] = {k: row[k] for k in
                         ("ms", "plain_ms", "bound_ms", "bound_by")}
            if key == "K13l":
                case[key]["k9l_ms"] = k9l_ms
                case[key]["to_k9l"] = ms / (sum(k9l_ms) / 2)
            if S == SHARD_COUNTS[0]:
                row["shape"] = (
                    f"S={S} on pass A's index: B={B}" if key != "K11s" else
                    f"S={S}, pass A's first 256-seed block, C={capacity}, "
                    f"{expanded} expanded states")
                rows[key] = row
        case["K11s"]["expanded_states"] = expanded
        case["K11s"]["by_cluster"] = frontier_clusters(
            k11, index, operands, tables, capacity, reports, max_iterations,
            out, 5)
        case["K11s"]["per_query_ms"] = cuda_ms(per_query, 20)
        case["K11s"]["per_query_by_cluster"] = frontier_clusters(
            k11, index, q_operands, q_tables, q_capacity, q_reports,
            q_iterations, q_out, 20)
        fields[f"shards_{S}"] = case
    return rows, fields


def k10_largest_root(k10, index, padded, classes, tables, report_cap, kw,
                     frames, largest):
    """The root of the chunk with the largest tree, found by K10's
    `largest` on halves of the seeds, then on each of the seed's searches
    alone; that one root launched alone (a one-search scheme of its rows)
    and timed as the chunk's launch is, at the wrapper's budget and at
    one that never spills (the tree on one thread): {seed, search, nodes,
    ms, ms_unspilled}."""
    import numpy as np
    import torch

    device = index.device
    fused = tables.fused()
    parts = tables.num_parts

    def run(patterns, seed_class, scheme, num_searches, budget=k10.BUDGET):
        operands = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
                    for a in (patterns, seed_class, scheme)]
        return k10.WorkqueueLaunch(index, *operands, num_searches, parts,
                                   report_cap, kw, frames, budget)

    def largest_of(lo, hi):
        prepared = run(padded[lo:hi], classes[lo:hi], fused,
                       tables.num_searches)
        prepared.launch()
        return prepared.result().largest_tree

    lo, hi = 0, padded.shape[0]
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if largest_of(lo, mid) == largest:
            hi = mid
        else:
            lo = mid
    cls = int(classes[lo])
    for search in range(tables.num_searches):
        first = (cls * tables.num_searches + search) * parts
        prepared = run(padded[lo:lo + 1], np.zeros(1, dtype=np.int32),
                       fused[first:first + parts], 1)
        prepared.launch()
        nodes = prepared.result().nodes
        if nodes == largest:
            break
    check(nodes == largest, f"no root of seed {lo} has the largest tree "
                            f"({largest} nodes)")
    unspilled = run(padded[lo:lo + 1], np.zeros(1, dtype=np.int32),
                    fused[first:first + parts], 1, K10_BUDGETS[-1])
    return {"seed": lo, "search": search, "nodes": nodes,
            "ms": k10_times(prepared)[1],
            "ms_unspilled": k10_times(unspilled)[1]}


def k10_times(prepared):
    """A K10 search on buffers allocated once, timed (CUDA events,
    K10_REPEATS searches back to back) as the wrapper runs it (its
    generations, reading the last one's count between batches) and as its
    generations alone on the card, as many as the search took, enqueued
    with no read: (search ms, generations ms)."""
    search_ms = cuda_ms(prepared.launch, K10_REPEATS)
    generations = prepared.launches

    def alone():
        prepared.start()
        prepared.enqueue(generations)

    return search_ms, cuda_ms(alone, K10_REPEATS)


def frontier_kernel_checks(index, index_path, inputs, peaks):
    """K11 on each of frontier_inputs' inputs, one frontier a launch,
    timed (CUDA events, launches back to back) with its bound from the
    states it expanded, held exactly (reports, count, overflow,
    iterations, expanded states) to its plain version run on the CPU in a
    worker. Returns (the table row: the per-query bucket, pass H's shape;
    the phase's fields)."""
    import torch

    from floxer_tpu_torch.ops import cuda_frontier as k11

    fields, row, plain_jobs = {}, None, []
    for name, (padded, seed_class, tables, capacity, reports,
               max_iterations) in inputs.items():
        fused = tables.fused()
        operands = [torch.from_numpy(a).to(index.device)
                    for a in (padded, seed_class, fused)]

        def kernel():
            return k11.frontier_search_cuda(
                index, *operands, tables.num_searches, tables.num_parts,
                capacity, reports, max_iterations,
            )

        before = k11.LAUNCHES
        out = kernel()
        check(k11.LAUNCHES == before + 1, "K11 took more than one launch")
        expanded = int(out.expanded[0])
        got = [out.reports[0].cpu().numpy(),
               out.num_reports[:1].cpu().numpy(),
               out.overflow[0].cpu().numpy(), int(out.iterations[0]),
               expanded]
        repeats = 20 if name == "per_query" else 5
        ms = cuda_ms(kernel, repeats)
        pick = k11.cluster_size(index.device, 1,
                                padded.shape[1] * tables.num_searches)
        by_cluster = frontier_clusters(k11, index, operands, tables,
                                       capacity, reports, max_iterations,
                                       out, repeats)
        nbytes = (tensor_bytes(index.rank_rows, *operands)
                  + int(got[1][0]) * 5 * 4)
        bound_ms, bound_by = bound(FRONTIER_OPS_PER_STATE * expanded,
                                   nbytes, peaks)
        case = {
            "shape": f"{padded.shape[1]} seeds x {padded.shape[2]} chars, "
                     f"{tables.num_searches} searches, C={capacity}, "
                     f"R={reports}",
            "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "expanded_states": expanded, "iterations": got[3],
            "us_per_iteration": ms * 1000 / max(got[3], 1),
            "reports": int(got[1][0]), "overflow": bool(got[2].any()),
            "max_abs_err": 0, "plain_on": "cpu", "cluster": pick,
            "by_cluster": by_cluster,
        }
        check(not case["overflow"], f"K11 overflowed on the {name} input")

        fields[name] = case
        plain_jobs.append((name, case, got, (
            _frontier_plain, index_path, padded[0], seed_class[0], fused,
            tables.num_searches, tables.num_parts, capacity, reports,
            max_iterations,
        )))
        if name == "per_query":
            row = {
                "name": "frontier_search", "route": "cuda",
                "source": k11.SOURCE, "replaces": k11.REPLACES,
                "max_abs_err": 0, "ms": ms, "plain_ms": None,
                "plain_on": "cpu", **bound_fields((bound_ms, bound_by)),
                "shape": "pass A's first read's largest per-query bucket: "
                         + case["shape"],
            }
    # the plain versions start once every K11 time is taken, so their
    # workers' start does not load the host under a timed launch
    for name, case, got, job in plain_jobs:
        def record(seconds, case=case, name=name):
            case["plain_ms"] = seconds * 1000
            if name == "per_query":
                row["plain_ms"] = seconds * 1000

        CPU_PLAIN.expect(f"K11 on the {name} input", CPU_PLAIN.submit(*job),
                         [got], record)
    return row, fields


def frontier_clusters(k11, index, operands, tables, capacity, reports,
                      max_iterations, want, repeats):
    """K11 (over the index or its shards) on one input at every cluster
    size the kernel takes, each launch held exactly to `want` (the
    wrapper's pick: reports, count, overflow, iterations, expanded
    states) and timed: {blocks: ms, or "no cluster fits" where the card
    places none (the launch must raise)}."""
    from floxer_tpu_torch.ops.frontier import is_sharded

    timed = {}
    for cluster in FRONTIER_CLUSTERS:
        def kernel(cluster=cluster):
            return k11.frontier_search_cuda(
                index, *operands, tables.num_searches, tables.num_parts,
                capacity, reports, max_iterations, cluster)

        if k11.max_clusters(index.device, cluster, is_sharded(index)) < 1:
            try:
                kernel()
            except RuntimeError:
                timed[cluster] = "no cluster fits"
                continue
            check(False, f"K11 launched on clusters of {cluster} blocks "
                         "that the card cannot place")
        out = kernel()
        err = max(max_error(getattr(out, f), getattr(want, f))
                  for f in ("reports", "num_reports", "overflow",
                            "iterations", "expanded"))
        check(err == 0, f"K11 on clusters of {cluster} blocks differs "
                        f"from the wrapper's pick ({err})")
        timed[cluster] = cuda_ms(kernel, repeats)
    return timed


def emissions(groups, starts, totals, statuses, perm, hard_cap, soft_cap,
              choice_code):
    """int64 [S]: each seed's valid emissions E, as K12 counts them: under
    round robin min(kept_raw, the rows of its first soft_cap groups in the
    order perm, each at most soft_cap); else kept_raw where one of those
    groups counts a row, 0 where none does."""
    import numpy as np

    S = totals.shape[0]
    gid = np.repeat(np.arange(S), np.diff(starts))
    live = (np.arange(groups.shape[0]) - starts[gid]) < soft_cap
    counts = groups[perm, 2][live]
    rows = np.bincount(gid[live], weights=np.clip(counts, 0, soft_cap),
                       minlength=S).astype(np.int64)
    counting = np.bincount(gid[live], weights=counts > 0, minlength=S) > 0
    excluded = (totals > hard_cap) & (choice_code != 2)
    kept_raw = np.where(((statuses & 2) == 0) & ~excluded,
                        np.minimum(totals, soft_cap), 0)
    if choice_code == 0:
        return np.minimum(kept_raw, rows)
    return np.where(counting, kept_raw, 0)


def select_kernel_checks(index, index_path, rep, redo, peaks):
    """K12 on the groups of pass A's first chunk after the dedup and cap
    replay, under the CLI's defaults (count_first, round_robin, erase),
    with full_groups and with first_reported: one launch each, timed (CUDA
    events, the wrapper's allocations included; each code in turns, then
    again in the reverse order, the smaller kept) with its bound (the
    anchors emitted and their LF steps, counted from the same selection
    without erase, which keeps every emission), held exactly to its plain
    version run on the CPU in a worker; the histogram of each seed's
    valid emissions E (0, 1, 2-8, 9 to soft cap - 1, soft cap), which
    splits the seeds between K12's lane path (E <= 1) and its warp path.
    Returns (the table row: the defaults; the phase's fields)."""
    import numpy as np
    import torch

    from floxer_tpu_torch.ops import cuda_select as k12
    from floxer_tpu_torch.search_device import replay_groups
    from floxer_tpu_torch.search_select_device import group_order

    hard_cap, soft_cap = 500, 50  # the CLI's defaults
    groups, starts, totals, statuses = replay_groups(rep, redo, hard_cap + 1)
    S = totals.shape[0]
    started = time.monotonic()
    perm = group_order(groups, starts, 0)
    order_s = time.monotonic() - started
    gid = np.repeat(np.arange(S), np.diff(starts))
    host_arrays = [np.ascontiguousarray(a, dtype=np.int32) for a in (
        groups[:, 0], groups[:, 2], groups[:, 3], gid, perm, starts,
        np.minimum(totals, 2**31 - 1), statuses,
    )]
    operands = [torch.from_numpy(a).to(index.device) for a in host_arrays]
    fields = {"seeds": S, "groups": int(groups.shape[0]),
              "select_order_s": order_s}
    plain_jobs, timers = [], {}
    fwd = index.fwd
    table_bytes = (128 * fwd.planes.shape[0]
                   + tensor_bytes(fwd.bwt, index.sample_plane,
                                  index.sampled_values, index.seq_starts))
    seq_probes = PROBE_OPS * int(np.ceil(np.log2(
        index.seq_starts.shape[0] + 1)))
    for name, choice_code in (("defaults", 0), ("full_groups", 1),
                              ("first_reported", 2)):
        caps = (hard_cap, soft_cap, 0, choice_code, True)
        per_seed = emissions(groups, starts, totals, statuses, perm,
                             hard_cap, soft_cap, choice_code)
        histogram = {
            "0": int((per_seed == 0).sum()), "1": int((per_seed == 1).sum()),
            "2-8": int(((per_seed >= 2) & (per_seed <= 8)).sum()),
            f"9-{soft_cap - 1}": int(((per_seed >= 9)
                                      & (per_seed < soft_cap)).sum()),
            str(soft_cap): int((per_seed == soft_cap).sum()),
        }

        def kernel(caps=caps):
            return k12.select_anchors_cuda(index, *operands, *caps)

        before = k12.LAUNCHES
        anchors, counts = kernel()
        check(k12.LAUNCHES == before + 1, "K12 took more than one launch")
        got = [anchors.cpu().numpy(), counts.cpu().numpy()]
        ms = cuda_ms(kernel, 5)
        # every emission's locate, from the selection without erase
        kept, _ = k12.select_anchors_cuda(
            index, *operands, hard_cap, soft_cap, 0, choice_code, False)
        kept = kept.cpu().numpy()
        emitted = int(per_seed.sum())
        valid = np.arange(soft_cap)[None, :] < per_seed[:, None]
        seq_starts = index.seq_starts.cpu().numpy().astype(np.int64)
        text_positions = (seq_starts[kept[:, :, 0][valid]]
                          + kept[:, :, 1][valid])
        steps = int((text_positions % index.sampling_rate).sum())
        ops = (SELECT_OPS_PER_ANCHOR * emitted + SELECT_OPS_PER_SEED * S
               + locate_ops(steps, emitted, seq_probes))
        nbytes = (tensor_bytes(*operands, anchors, counts) + table_bytes)
        bound_ms, bound_by = bound(ops, nbytes, peaks)
        case = {"ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
                "emitted": emitted, "lf_steps": steps,
                "written": int(got[1][:, 1].sum()),
                "emissions_histogram": histogram, "max_abs_err": 0,
                "plain_on": "cpu"}

        fields[name] = case
        plain_jobs.append((name, case, got, caps))
        timers[name] = kernel
    # each choice code timed again in the reverse order; its time is the
    # smaller of its two (a host stall past the spin inflates one)
    for name in reversed(list(timers)):
        case = fields[name]
        case["ms_in_turns"] = [case["ms"], cuda_ms(timers[name], 5)]
        case["ms"] = min(case["ms_in_turns"])
    row = {
        "name": "select_anchors", "route": "cuda", "source": k12.SOURCE,
        "replaces": k12.REPLACES, "max_abs_err": 0,
        "ms": fields["defaults"]["ms"], "plain_ms": None, "plain_on": "cpu",
        **bound_fields((fields["defaults"]["bound_ms"],
                        fields["defaults"]["bound_by"])),
        "shape": f"pass A's first chunk: {S} seeds, "
                 f"{groups.shape[0]} groups, soft cap {soft_cap}",
    }
    # started once every K12 time is taken, as K11's
    for name, case, got, caps in plain_jobs:
        def record(seconds, case=case, name=name):
            case["plain_ms"] = seconds * 1000
            if name == "defaults":
                row["plain_ms"] = seconds * 1000

        CPU_PLAIN.expect(
            f"K12 with {name}",
            CPU_PLAIN.submit(_select_plain, index_path, host_arrays, caps),
            [got], record,
        )
    return row, fields


def stage_seconds(split: str, stage: str) -> float:
    found = re.search(rf"\b{stage}=([0-9.]+)s", split)
    check(found is not None, f"no {stage}= in the stage split {split!r}")
    return float(found.group(1))


def run_device_search_pass(device, e2e: E2E):
    """Pass G: pass A's arguments with --device-search: the seed search by
    K10, SAM = pass B, one K10 search a chunk's dispatch (a second for a
    dispatch retried after an overflow), one launch a generation (the
    roots', then one a list of spilled entries), counted after the search
    warmup (one K9 and one K10 search) has been joined; the seconds of the
    searcher's stages (the work queue with its report sort, the dedup and
    cap replay, the native select, the native redo)."""
    from floxer_tpu_torch import pipeline, search_queue
    from floxer_tpu_torch.ops import cuda_search_queue as k10
    from floxer_tpu_torch.search_device import DeviceSearcher

    pipeline.start_device_warmup(device, device_search=True)
    pipeline.join_device_warmup()
    long_before = DeviceSearcher.redo_long
    overflow_before = DeviceSearcher.redo_overflow
    dispatches_before = DeviceSearcher._chunk_dispatches
    retries_before = search_queue.RETRIES
    launches, _ = e2e.run_device_pass("pass_g", extra=["--device-search"])
    chunks = -(-e2e.num_reads // 100)
    dispatches = DeviceSearcher._chunk_dispatches - dispatches_before
    retries = search_queue.RETRIES - retries_before
    spills = k10.SPILL_LAUNCHES  # set to 0 with the launch counts
    check(dispatches == chunks,
          f"pass G made {dispatches} work-queue dispatches for {chunks} "
          "chunks")
    check(launches["K10"] == dispatches + retries + spills,
          f"pass G launched K10 {launches['K10']} times for {dispatches} "
          f"dispatches, {retries} retries and {spills} later generations")
    splits = {name: align_seconds(e2e.workdir / f"{name}.log")
              for name in ("pass_g", "pass_a", "pass_b")}
    return {
        "reads": e2e.num_reads, "chunks": chunks, "sam_identical": True,
        "k10_retries": retries, "k10_later_generations": spills,
        "launches": launches,
        **{f"{name}_align_s": splits[name][0] for name in splits},
        **{f"{name}_search_s": stage_seconds(splits[name][1], "search")
           for name in splits},
        "stage_split": splits["pass_g"][1],
        "host_redo_long_seeds": DeviceSearcher.redo_long - long_before,
        "host_redo_overflowed_seeds":
            DeviceSearcher.redo_overflow - overflow_before,
        "search_stage_s": search_stage_seconds(),
    }, launches


SEARCH_STAGES = (
    "work_queue", "work_queue.operands", "work_queue.upload",
    "work_queue.launch", "work_queue.download", "work_queue.sort", "blocks",
    "dedup_cap", "select", "device_select", "select_order", "redo",
    "frontier", "frontier_replay",
)


def search_stage_seconds() -> dict:
    """The last run's seconds in each stage of the device searcher: its
    job's sums of the spans search.device.<stage>."""
    from floxer_tpu_torch import tracing

    job = tracing.last_job()
    return {stage: job.seconds(f"search.device.{stage}")
            for stage in SEARCH_STAGES}


def run_select_pass(e2e: E2E):
    """Pass G2: pass G with FLOXER_TPU_DEVICE_SELECT=1: the groups of each
    chunk's work-queue search selected by K12, one launch a chunk (its
    locate inside it, so no K9l launch); SAM = pass B; the searcher's
    stage seconds (device_select with its host group order,
    select_order)."""
    launches, _ = e2e.run_device_pass(
        "pass_g2", extra=["--device-search"],
        env={"FLOXER_TPU_DEVICE_SELECT": "1"},
    )
    chunks = -(-e2e.num_reads // 100)
    check(launches["K12"] == chunks,
          f"pass G2 launched K12 {launches['K12']} times for {chunks} chunks")
    check(launches["K9l"] == 0 and launches["K11"] == 0,
          f"pass G2 launched K9l or K11: {launches}")
    seconds, split = align_seconds(e2e.workdir / "pass_g2.log")
    return {
        "reads": e2e.num_reads, "chunks": chunks, "sam_identical": True,
        "launches": launches, "align_s": seconds,
        "search_s": stage_seconds(split, "search"), "stage_split": split,
        "search_stage_s": search_stage_seconds(),
    }, launches


def run_block_pass(e2e: E2E):
    """Pass G3: pass G with FLOXER_TPU_SEARCH_NO_CHUNK_FUSE=1: the legacy
    block loop, each error class's 256-seed blocks as frontier searches on
    K11 (up to 256 blocks a launch), no work-queue dispatch; SAM = pass
    B; K11's launches and the seeds redone on the host after an
    overflow."""
    from floxer_tpu_torch.search_device import DeviceSearcher

    overflow_before = DeviceSearcher.redo_overflow
    launches, _ = e2e.run_device_pass(
        "pass_g3", extra=["--device-search"],
        env={"FLOXER_TPU_SEARCH_NO_CHUNK_FUSE": "1"},
    )
    check(launches["K11"] > 0 and launches["K10"] == 0,
          f"pass G3 launched K11 {launches['K11']} and K10 "
          f"{launches['K10']} times")
    seconds, split = align_seconds(e2e.workdir / "pass_g3.log")
    return {
        "reads": e2e.num_reads, "sam_identical": True,
        "launches": launches, "align_s": seconds,
        "search_s": stage_seconds(split, "search"), "stage_split": split,
        "host_redo_overflowed_seeds":
            DeviceSearcher.redo_overflow - overflow_before,
        "search_stage_s": search_stage_seconds(),
    }, launches


def first_reads(e2e: E2E, count: int, host_name: str) -> E2E:
    """The workload cut to its first `count` reads, with their own host
    pass (the native host engine) as `host_name`."""
    import copy

    from floxer_tpu_torch import pipeline
    from floxer_tpu_torch.cli import parse_and_validate

    subset = copy.copy(e2e)
    subset.reads = e2e.workdir / f"reads_first_{count}.fastq"
    subset.num_reads = count
    lines = e2e.reads.read_text().splitlines(keepends=True)
    subset.reads.write_text("".join(lines[:4 * count]))
    check(pipeline.run(parse_and_validate(subset.argv(host_name)),
                       use_device=False) == 0, f"{host_name} failed")
    return subset


def run_frontier_pass(e2e: E2E):
    """Pass H: the first PASS_H_READS reads of the workload with pass A's
    arguments and --engine reference --device-search: every query's seed
    search on the card as one K11 launch a (length, errors) bucket of its
    seeds and strand (the per-query frontier), the rest of the reference
    engine on the host; SAM = the same reads' own host pass (the native
    host engine). Counted after the search warmup is joined."""
    subset = first_reads(e2e, PASS_H_READS, "pass_h_host")
    started = time.monotonic()
    launches, _ = subset.run_device_pass(
        "pass_h", extra=["--device-search"], engine="reference",
        oracle="pass_h_host",
    )
    wall = time.monotonic() - started
    check(launches["K11"] > 0 and launches["K10"] == 0,
          f"pass H launched K11 {launches['K11']} and K10 "
          f"{launches['K10']} times")
    return {
        "reads": PASS_H_READS, "sam_identical": True, "launches": launches,
        "align_s": subset.seconds("pass_h"),
        "host_pass_align_s": subset.seconds("pass_h_host"), "wall_s": wall,
        "search_stage_s": search_stage_seconds(),
    }, launches


def run_sharded_pass(e2e: E2E):
    """Pass I: pass A's arguments with --device-search --index-shards 2:
    the sharded searcher, its chunks through the legacy block loop on K11
    over the shard tables (no K10), the native select and the host
    locate; SAM = pass B; its search seconds and the searcher's stage
    seconds."""
    from floxer_tpu_torch.search_device import DeviceSearcher

    overflow_before = DeviceSearcher.redo_overflow
    launches, _ = e2e.run_device_pass(
        "pass_i", extra=["--device-search", "--index-shards", "2"],
    )
    check(launches["K11s"] > 0 and launches["K11"] == 0
          and launches["K10"] == 0,
          f"pass I launched K11 {launches['K11s']} times over the shards, "
          f"{launches['K11']} over the index and K10 {launches['K10']} "
          f"times")
    seconds, split = align_seconds(e2e.workdir / "pass_i.log")
    return {
        "reads": e2e.num_reads, "sam_identical": True, "launches": launches,
        "align_s": seconds, "search_s": stage_seconds(split, "search"),
        "pass_g3_search_s": stage_seconds(
            align_seconds(e2e.workdir / "pass_g3.log")[1], "search"),
        "stage_split": split,
        "host_redo_overflowed_seeds":
            DeviceSearcher.redo_overflow - overflow_before,
        "search_stage_s": search_stage_seconds(),
    }, launches


def run_sharded_frontier_pass(e2e: E2E):
    """Pass H2: the first PASS_H2_READS reads with --engine reference
    --device-search --index-shards 2: each query's per-query frontier on
    K11 over the shard tables; SAM = their own host pass."""
    subset = first_reads(e2e, PASS_H2_READS, "pass_h2_host")
    started = time.monotonic()
    launches, _ = subset.run_device_pass(
        "pass_h2", extra=["--device-search", "--index-shards", "2"],
        engine="reference", oracle="pass_h2_host",
    )
    check(launches["K11s"] > 0 and launches["K10"] == 0,
          f"pass H2 launched K11 {launches['K11s']} times over the shards "
          f"and K10 {launches['K10']} times")
    return {
        "reads": PASS_H2_READS, "sam_identical": True, "launches": launches,
        "align_s": subset.seconds("pass_h2"),
        "host_pass_align_s": subset.seconds("pass_h2_host"),
        "wall_s": time.monotonic() - started,
    }


def run_dryrun_phase(device):
    """The port's entry points on the card (graft_entry): entry()'s
    step (K9l, K2), then dryrun_multichip(2) and (8) on cuda:0 repeated:
    the reads-split step, the 2-D step whose sharded ranks (K13) must
    equal K9's, the sharded search and locate (K11 over the shards, K13l)
    and the sharded CLI's SAM equal to the unsharded one's. Counted from
    0; returns (fields, launches)."""
    from floxer_tpu_torch import graft_entry, pipeline

    reset_launches()
    printed = io.StringIO()
    started = time.monotonic()
    with contextlib.redirect_stdout(printed):
        fn, args = graft_entry.entry(device)
        out = fn(*args)
        check(bool(out["accepted"].all()), "entry()'s step rejected a "
                                           "planted match")
        for n in (2, 8):
            graft_entry.dryrun_multichip(n, device)
    launches = pipeline.kernel_launches()
    for name in ("K2", "K9l", "K11s", "K13", "K13l"):
        check(launches[name] > 0, f"the dry run never launched {name}")
    lines = printed.getvalue().splitlines()
    check(sum("— OK" in line for line in lines) == 8,
          f"the dry run did not accept every step: {lines}")
    return {"seconds": time.monotonic() - started, "lines": lines,
            "launches": launches}, launches


def run_platform_cpu_pass(e2e: E2E):
    """Pass F2: pass B's engine (--engine batched) with
    FLOXER_TPU_PLATFORM=cpu on the machine with the card: run() takes the
    CPU, so no kernel launches and no fused dispatch; SAM = pass B."""
    launches, fused = e2e.run_device_pass(
        "pass_f2", engine="batched", env={"FLOXER_TPU_PLATFORM": "cpu"},
    )
    check(not any(launches.values()) and fused == 0,
          f"pass F2 launched kernels: {launches}, fused {fused}")
    return {"sam_identical": True, "launches": launches, "fused": fused,
            "align_s": e2e.seconds("pass_f2")}


def run_traceback_pass(e2e: E2E):
    """Pass C: root CIGARs by K4 (FLOXER_TPU_DEVICE_TRACEBACK=1)."""
    launches, fused = e2e.run_device_pass(
        "pass_c", env={"FLOXER_TPU_DEVICE_TRACEBACK": "1"}
    )
    check(launches["K4"] > 0, "K4 was never launched in pass C")
    return {
        "align_s": e2e.seconds("pass_c"),
        "pass_a_align_s": e2e.seconds("pass_a"),
        "pass_b_align_s": e2e.seconds("pass_b"),
        "k4_launches": launches["K4"],
        "launches": launches, "fused_dispatches": fused,
        "sam_identical": True,
    }, launches


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_process_set_pass(e2e: E2E):
    """Pass F: pass A's arguments in PROCESS_SET processes on the one card,
    joined through the reference's variables (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID) on torch.distributed's gloo: each
    process aligns its strided share on the CUDA kernels (K1 launched in
    each), stdout stays empty, and process 0's merged SAM equals pass B's
    byte for byte."""
    port = free_port()
    procs, logs = [], []
    started = time.monotonic()
    for rank in range(PROCESS_SET):
        env = dict(os.environ)
        env.update({
            "PYTHONPATH": str(ROOT),
            "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "JAX_NUM_PROCESSES": str(PROCESS_SET),
            "JAX_PROCESS_ID": str(rank),
        })
        argv = e2e.argv("pass_f", ["--engine", "device"])
        log = e2e.workdir / f"pass_f_{rank}.log"
        argv[argv.index("--logfile") + 1] = str(log)
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", JAX_BLOCKED, *argv],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT, env=env,
        ))
    try:
        outs = [proc.communicate(timeout=PROCESS_SET_TIMEOUT)
                for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall_s = time.monotonic() - started
    for rank, (proc, (stdout, stderr)) in enumerate(zip(procs, outs)):
        check(proc.returncode == 0, f"pass F process {rank} exited "
              f"{proc.returncode}: {stderr[-2000:]}")
        check(stdout == "", f"pass F process {rank} wrote to stdout")
    check(e2e.sam("pass_f") == e2e.sam("pass_b"),
          "pass F's merged SAM and pass B's differ")
    processes = []
    for rank, log in enumerate(logs):
        seconds, split = align_seconds(log)
        launches = run_logged_launches(log)
        check(launches["K1"] > 0, f"pass F process {rank} launched no K1")
        processes.append({"align_s": seconds, "launches": launches,
                          "stage_split": split})
    merged = [line.split("merged", 1)[1].strip()
              for line in logs[0].read_text().splitlines()
              if "merged" in line and "shards" in line]
    check(len(merged) == 1, f"process 0 logged no merge: {merged}")
    for rank in range(1, PROCESS_SET):
        check("merged" not in logs[rank].read_text(),
              f"process {rank} merged")
    return {
        "processes": processes, "merge": "merged " + merged[0],
        "wall_s": wall_s, "pass_a_align_s": e2e.seconds("pass_a"),
        "sam_identical": True,
    }


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


def append_overhanging_reads(e2e: E2E, rng, count=OVERHANG_READS[0],
                             inside=OVERHANG_READS[1],
                             length=None) -> None:
    """Add `count` reads of `length` chars (the workload's read length by
    default) that run off the end of the genome's (one) chromosome: the
    chromosome's last `inside` chars, mutated at the workload's read error
    rate, then random chars up to the read length, as reads that span a
    contig end of a draft assembly do. Their roots verify against windows
    that the chromosome end cuts shorter than m - k, so the fused wave runs
    them full (K3): pass E's over 512 pattern words, pass J's over 2048."""
    import numpy as np

    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = b"".join(
        line.strip() for line in e2e.genome.read_bytes().splitlines()
        if not line.startswith(b">")
    )
    codes = np.searchsorted(letters, np.frombuffer(genome, np.uint8)) + 1
    length = length or e2e.read_len
    with open(e2e.reads, "a") as handle:
        for i in range(count):
            read = mutate(rng, codes[-inside:], e2e.read_error)
            tail = rng.integers(1, 5, size=max(0, length - len(read)))
            text = letters[np.concatenate([read, tail]) - 1].tobytes().decode()
            handle.write(f"@overhang_{i}\n{text}\n+\n{'I' * len(text)}\n")


def run_long_pass(e2e: E2E, rng):
    """Pass E: the LONG_READS workload, with overhanging reads appended,
    with --engine device against its own pass B. Its PEX roots need bands
    over 512 words, so the fused wave runs them on the multi-warp K1, and
    the overhanging reads' roots take K3's cluster kernel (each counted
    apart from its other kernels' launches); no launch of either
    shared-memory kernel. Beside the launches, the tasks of each launch at
    the long reads' widths (K1's multi-warp kernel at 640-2048 band words,
    K3u at 544-2048 pattern words): (width, tasks)."""
    from floxer_tpu_torch.ops import cuda_myers_banded, cuda_myers_large
    from floxer_tpu_torch import tracing

    append_overhanging_reads(e2e, rng)
    e2e.run_host_pass()
    launches, fused = e2e.run_device_pass("pass_e")
    device_kernel_s = tracing.last_job().seconds("verify.device_wait")
    for name, routed in (("K1", "wide"), ("K3", "cluster")):
        check(launches[f"{name}_{routed}"] > 0
              and launches[f"{name}_shared"] == 0,
              f"pass E's long {name} launches did not all take the "
              f"{routed} kernel: {launches}")
    long_tasks = {"K1": list(cuda_myers_banded.LONG_TASKS),
                  "K3": list(cuda_myers_large.LONG_TASKS)}
    check(len(long_tasks["K1"]) == launches["K1_wide"],
          f"pass E's multi-warp K1 launches and their tasks differ: "
          f"{long_tasks}")
    return {
        "device_kernel_s": device_kernel_s,
        "reads": e2e.num_reads, "overhanging_reads": OVERHANG_READS[0],
        "genome_bp": LONG_READS[0],
        "read_len": LONG_READS[2], "read_error": LONG_READS[3],
        "query_error": e2e.query_error,
        "align_s": e2e.seconds("pass_e"),
        "pass_b_align_s": e2e.seconds("pass_b"),
        "stage_split": align_seconds(e2e.workdir / "pass_e.log")[1],
        "launches": launches, "long_tasks": long_tasks,
        "fused_dispatches": fused, "sam_identical": True,
    }, launches


def append_skipped_read(e2e: E2E, seed) -> str:
    """Add one ULTRA_SKIPPED-char read, a mutated slice of the chromosome,
    longer than the aligner takes; its name."""
    import numpy as np

    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = b"".join(
        line.strip() for line in e2e.genome.read_bytes().splitlines()
        if not line.startswith(b">")
    )
    codes = np.searchsorted(letters, np.frombuffer(genome, np.uint8)) + 1
    rng = np.random.default_rng(seed)
    start = int(rng.integers(0, len(codes) - ULTRA_SKIPPED))
    read = mutate(rng, codes[start : start + ULTRA_SKIPPED], e2e.read_error)
    text = letters[np.asarray(read) - 1].tobytes().decode()
    with open(e2e.reads, "a") as handle:
        handle.write(f"@too_long_0\n{text}\n+\n{'I' * len(text)}\n")
    return "too_long_0"


def run_ultra_pass(e2e: E2E, rng, long_result):
    """Pass J: one ULTRA_READ read on pass E's genome at its -p, one
    ULTRA_OVERHANG read that runs off the chromosome's end and one
    ULTRA_SKIPPED read, --engine device against its own pass B. The
    overhanging read's root, cut short by the chromosome's end, runs full
    on K3u past 2048 pattern words, and its merged root windows on K1u
    past 2048 band words; no launch of either shared-memory kernel; the
    ULTRA_SKIPPED read is skipped by both passes, as by the reference.
    Prints the widths the cluster kernels ran (the roots' bands, the
    patterns' words), the launches by kernel, the tasks of each launch at
    the long reads' widths (as pass E) and device_kernel_s beside pass
    E's."""
    from floxer_tpu_torch import tracing
    from floxer_tpu_torch.ops import cuda_myers_banded, cuda_myers_large

    append_overhanging_reads(e2e, rng, 1, ULTRA_OVERHANG[1],
                             ULTRA_OVERHANG[0])
    skipped = append_skipped_read(e2e, SEED + 6)
    e2e.run_host_pass()
    launches, fused = e2e.run_device_pass("pass_j")
    device_kernel_s = tracing.last_job().seconds("verify.device_wait")
    band_words = dict(cuda_myers_banded.CLUSTER_WIDTHS)
    pattern_words = dict(cuda_myers_large.CLUSTER_WIDTHS)
    for name in ("K1", "K3"):
        check(launches[f"{name}_cluster"] > 0
              and launches[f"{name}_shared"] == 0,
              f"pass J's {name} launches did not take the cluster kernel "
              f"and no shared-memory one: {launches}")
    # K1u only past K1w's widest; K3u past 2048 words for the overhanging
    # root and at 544-2048 for the other overhanging roots
    check(min(band_words) > 2048 and max(pattern_words) > 2048,
          f"pass J's cluster launches ran at {band_words}, {pattern_words}")
    long_tasks = {"K1": list(cuda_myers_banded.LONG_TASKS),
                  "K3": list(cuda_myers_large.LONG_TASKS)}
    for name in ("pass_b", "pass_j"):
        check(f"skipping too large query: {skipped}"
              in (e2e.workdir / f"{name}.log").read_text()
              and skipped.encode() not in e2e.sam(name),
              f"{name} did not skip the {ULTRA_SKIPPED}-char read")
    return {
        "root_band_words": band_words,
        "overhang_pattern_words": pattern_words,
        "device_kernel_s": device_kernel_s,
        "pass_e_device_kernel_s": long_result["device_kernel_s"],
        "reads": 3, "read_len": ULTRA_READ[0], "read_error": ULTRA_READ[1],
        "overhang": {"read_len": ULTRA_OVERHANG[0],
                     "on_chromosome": ULTRA_OVERHANG[1]},
        "skipped": {"read_len": ULTRA_SKIPPED, "name": skipped},
        "genome_bp": LONG_READS[0], "query_error": e2e.query_error,
        "align_s": e2e.seconds("pass_j"),
        "pass_b_align_s": e2e.seconds("pass_b"),
        "stage_split": align_seconds(e2e.workdir / "pass_j.log")[1],
        "launches": launches, "long_tasks": long_tasks,
        "fused_dispatches": fused, "sam_identical": True,
    }, launches


def run_long_profile_pass(e2e: E2E):
    """Pass E again under --profile and with the roots' CIGARs by K4
    (FLOXER_TPU_DEVICE_TRACEBACK=1): its device time by kernel from the
    trace (the multi-warp K1 and K3 and K4 named in it); the long roots'
    bands (~8000-10000 cells) run K4's 16- or 32-cell register layout;
    SAM identical."""
    trace_dir = e2e.workdir / "trace_e"
    launches, _ = e2e.run_device_pass(
        "pass_ep", extra=["--profile", str(trace_dir)],
        env={"FLOXER_TPU_DEVICE_TRACEBACK": "1"},
    )
    check(launches.get("K4_reg16", 0) + launches.get("K4_reg32", 0) > 0,
          f"pass E's roots never ran K4's 16- or 32-cell layout: {launches}")
    traces = list(trace_dir.glob("*.json"))
    check(len(traces) == 1, f"expected one trace in {trace_dir}: {traces}")
    text = traces[0].read_text()
    for kernel in ("myers_banded_wide_kernel", "myers_large_cluster_kernel",
                   "traceback_kernel"):
        check(kernel in text, f"pass E's trace does not name {kernel}")
    return {"align_s": e2e.seconds("pass_ep"), "launches": launches,
            "sam_identical": True, **trace_breakdown(json.loads(text))}


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
    check("myers_banded_reg_kernel" in text,
          "the trace does not name K1's register kernel")
    return {
        "align_s": e2e.seconds("pass_p"), "trace_bytes": len(text),
        "k1_events": text.count("myers_banded_reg_kernel"),
        "launches": launches, "sam_identical": True,
        **trace_breakdown(json.loads(text)),
    }


def trace_breakdown(trace: dict, top: int = 6) -> dict:
    """Device time of a torch.profiler Chrome trace: the kernels' summed
    time by name (the `top` largest) and by CUDA kernel K1-K4 (both of a
    kernel's variants together), the union of the kernel and copy
    intervals (device busy) and the first-to-last device span, in s."""
    intervals, by_name = [], {}
    for event in trace.get("traceEvents", []):
        if event.get("ph") != "X" or event.get("cat") not in (
            "kernel", "gpu_memcpy", "gpu_memset"
        ):
            continue
        start, dur = float(event["ts"]), float(event.get("dur", 0))
        intervals.append((start, start + dur))
        if event["cat"] == "kernel":
            name = event["name"].replace("(anonymous namespace)::", "")
            name = name.split("(")[0].removeprefix("void ")
            count, total = by_name.get(name, (0, 0.0))
            by_name[name] = (count + 1, total + dur)
    check(bool(intervals), "the trace holds no device activity")
    intervals.sort()
    busy, (cur_start, cur_end) = 0.0, intervals[0]
    for start, end in intervals[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    kernels_s = sum(total for _, total in by_name.values()) / 1e6
    largest = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    families = {}
    for name, (count, total) in by_name.items():
        for key, prefix in (("K1", "myers_banded"), ("K2", "myers_small"),
                            ("K3", "myers_large"), ("K4", "traceback")):
            if name.startswith(prefix):
                family = families.setdefault(key, {"launches": 0, "s": 0.0})
                family["launches"] += count
                family["s"] += total / 1e6
    return {
        "kernels_by_family": families,
        "device_busy_s": busy / 1e6,
        "device_span_s": (intervals[-1][1] - intervals[0][0]) / 1e6,
        "kernel_s": kernels_s,
        "kernel_launches": sum(count for count, _ in by_name.values()),
        "kernels_by_time": [
            {"name": name[:80], "launches": count, "s": total / 1e6,
             "share": total / 1e6 / kernels_s}
            for name, (count, total) in largest
        ],
    }


def ptxas_phase() -> dict:
    """The register kernels' instances as the aligner's build compiled
    them: K1's myers_banded_reg_kernel<R>, K3's myers_large_reg_kernel<R>
    and K2's myers_small_kernel<G>. For each, what ptxas -v reported
    (registers, stack, spills) and, from the library's SASS, the
    instructions of each column loop (a loop runs once per text column):
    K1 two (sliding, then frozen; also per band word), K3 one per group
    count 1..R (a task runs the loop of its own), K2 one; and the
    multi-warp and cluster kernels (K1 myers_banded_wide_kernel<R>, R =
    1..16 words a lane, its column loops beside its barrier waits; K1u
    myers_banded_cluster_kernel<Q>; K3u myers_large_cluster_kernel, one
    per group count 1..4 and any other innermost loop the compiler made);
    and the device search's K9, K9x, K9l, K10, K11 and K12 (ptxas only).
    Fails on a missing instance, a spill, a stack frame or another loop
    count."""
    from floxer_tpu_torch.ops import _build
    from floxer_tpu_torch.ops.cuda_myers import LANES_FOR_WORDS
    from floxer_tpu_torch.ops.cuda_myers_banded import REGISTER_BAND_WORDS
    from floxer_tpu_torch.ops.cuda_myers_large import REGISTER_WORDS

    usage = _build.ALIGNER.ptxas_usage()
    loops = _build.sass_loops(_build.ALIGNER.sass())
    report = {}
    for kernel, instances, loop_count in (
        ("myers_banded_reg_kernel", [w // 32 for w in REGISTER_BAND_WORDS],
         lambda r: 2),
        ("myers_large_reg_kernel", [w // 32 for w in REGISTER_WORDS],
         lambda r: r),
        ("myers_small_kernel", sorted(set(LANES_FOR_WORDS.values())),
         lambda g: 1),
    ):
        names = {}
        for name in usage:
            found = re.search(rf"{kernel}ILi(\d+)E", name)
            if found:
                names[int(found.group(1))] = name
        check(sorted(names) == instances,
              f"{kernel}'s instances are {sorted(names)}, not {instances}")
        for n, name in sorted(names.items()):
            found = usage[name]
            check(found.get("spill_stores", 1) == 0
                  and found.get("spill_loads", 1) == 0
                  and found.get("stack", 1) == 0,
                  f"{kernel}<{n}> spills or keeps a stack frame: {found}")
            check(len(loops[name]) == loop_count(n),
                  f"{kernel}<{n}> has innermost loops of {loops[name]} "
                  f"instructions, not {loop_count(n)}")
            entry = {**found, "sass_loop_instructions": loops[name]}
            if kernel == "myers_banded_reg_kernel":
                entry["per_band_word"] = [i / n for i in loops[name]]
            report[f"{kernel}<{n}>"] = entry
    # the multi-warp K1's instances of R = 1..16 words a lane (4 warps):
    # its column loops (merged sliding, the last sliding and frozen ones)
    # beside the barrier waits the compiler made innermost loops of
    names = {int(found.group(1)): name for name in usage
             if (found := re.search(r"myers_banded_wide_kernelILi(\d+)E",
                                    name))}
    check(sorted(names) == list(range(1, 17)),
          f"myers_banded_wide_kernel's instances are {sorted(names)}")
    for r, name in sorted(names.items()):
        found = usage[name]
        check(found.get("spill_stores", 1) == 0
              and found.get("spill_loads", 1) == 0
              and found.get("stack", 1) == 0,
              f"myers_banded_wide_kernel<{r}> spills or keeps a stack "
              f"frame: {found}")
        check(len(loops[name]) >= 2, f"myers_banded_wide_kernel<{r}> has "
              f"innermost loops of {loops[name]} instructions")
        report[f"myers_banded_wide_kernel<{r}>"] = {
            **found, "sass_loop_instructions": loops[name]}
    # K3u's column loop per group count 1..4 (listed with the spare warps'
    # barrier loop and any other innermost loop the compiler made); K1u's
    # instances of Q = 1, 2, 4 lookahead words each with its two column
    # loops and that loop
    for kernel, enough in (("myers_large_cluster_kernel", lambda n: n >= 4),):
        names = [name for name in usage if kernel in name]
        check(len(names) == 1, f"{kernel} is compiled as {names}")
        found = usage[names[0]]
        check(found.get("spill_stores", 1) == 0
              and found.get("spill_loads", 1) == 0
              and found.get("stack", 1) == 0,
              f"{kernel} spills or keeps a stack frame: {found}")
        kernel_loops = loops[names[0]]
        check(enough(len(kernel_loops)),
              f"{kernel} has innermost loops of {kernel_loops} instructions")
        report[kernel] = {**found, "sass_loop_instructions": kernel_loops}
    names = {int(found.group(1)): name for name in usage
             if (found := re.search(r"myers_banded_cluster_kernelILi(\d+)E",
                                    name))}
    check(sorted(names) == [1, 2, 4],
          f"myers_banded_cluster_kernel's instances are {sorted(names)}")
    for q, name in sorted(names.items()):
        found = usage[name]
        check(found.get("spill_stores", 1) == 0
              and found.get("spill_loads", 1) == 0
              and found.get("stack", 1) == 0,
              f"myers_banded_cluster_kernel<{q}> spills or keeps a stack "
              f"frame: {found}")
        check(len(loops[name]) >= 2, f"myers_banded_cluster_kernel<{q}> has "
              f"innermost loops of {loops[name]} instructions")
        report[f"myers_banded_cluster_kernel<{q}>"] = {
            **found, "sass_loop_instructions": loops[name]}
    # the device search's kernels: K9, K9x (a kernel each for the combined
    # and the planes layout), K9l (csrc/fm_index.cu), K10
    # (csrc/workqueue_search.cu), K11 (csrc/frontier_search.cu) and K12
    # (csrc/select_anchors.cu), one instance each
    # (K11 twice: over the index and over the shard tables), and the
    # sharded index's K13 and K13l (csrc/fm_sharded.cu)
    for kernel, instances in (
        ("fm_rank_kernel", 1), ("fm_extend_kernel", 1),
        ("fm_rank_group_kernel", 1), ("fm_extend_group_kernel", 1),
        ("fm_locate_kernel", 1), ("workqueue_kernel", 1),
        ("frontier_kernel", 2), ("select_kernel", 1),
        ("fm_sharded_rank_kernel", 1), ("fm_sharded_locate_kernel", 1),
    ):
        names = sorted(name for name in usage if kernel in name)
        check(len(names) == instances, f"{kernel} is compiled as {names}")
        for name in names:
            found = usage[name]
            check(found.get("spill_stores", 1) == 0
                  and found.get("spill_loads", 1) == 0
                  and found.get("stack", 1) == 0,
                  f"{name} spills or keeps a stack frame: {found}")
            key = kernel
            if kernel == "frontier_kernel":
                key += "<sharded>" if "Sharded" in name else "<index>"
            report[key] = found
    return report


def main() -> int:
    global CPU_PLAIN
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
    peaks = card_peaks(device)
    phase("env", torch=torch.__version__, cuda=torch.version.cuda,
          capability=list(torch.cuda.get_device_capability(0)), **peaks)
    print(card, flush=True)

    # the plain versions of K1's sweep and of K5-K8 at full width run on
    # the CPU in worker processes from now on, while the kernels build and
    # the card runs on
    from floxer_tpu_torch.scripts import NUM_TEXT

    sweep = k1_sweep_cases(SEED + 1)
    large_sweep = k3_sweep_cases(SEED + 3)
    cluster_sweep = cluster_sweep_cases(SEED + 5)
    full_arrays = script_arrays(NUM_TEXT)
    spawn = multiprocessing.get_context("spawn")
    cpu_pool = spawn.Pool(CPU_PLAIN_WORKERS, _cpu_plain_init)
    search_pool = spawn.Pool(SEARCH_PLAIN_WORKERS, _cpu_plain_init)
    sweep_pool = spawn.Pool(SWEEP_WORKERS)
    pools = [cpu_pool, search_pool, sweep_pool]
    try:
        # the plain versions that take minutes, in parts, the longest
        # parts first (K1 at the root shape on its wider band, K3, K1w,
        # K1 on the narrower band, then K4's): each makes its own tasks
        # from the seed
        CPU_PLAIN = CpuPlain(cpu_pool, search_pool)
        results = CPU_PLAIN.results
        for key, fn, args in (
            (ROOT_WAVE_BAND_WORDS, _k1_root_plain, (ROOT_WAVE_BAND_WORDS,)),
            ("long_k3", _long_k3_plain, ()),
            ("long_k1", _long_k1_plain, ()),
            (ROOT_SHAPE[3], _k1_root_plain, (ROOT_SHAPE[3],)),
        ):
            results[key] = JoinedResult([
                CPU_PLAIN.submit(fn, *args, part)
                for part in range(K1_PLAIN_PARTS)
            ])
        for key in ("K4s", "K4", "K4r32", "K4r16"):
            results[key] = CPU_PLAIN.submit(_k4_plain, key)
        large_plain = sweep_pool.map_async(_k3_plain, large_sweep,
                                           chunksize=1)
        sweep_plain = sweep_pool.map_async(_k1_plain, sweep, chunksize=1)
        cluster_plain = (
            sweep_pool.map_async(_k1_plain, cluster_sweep[0], chunksize=1),
            sweep_pool.map_async(_k3_plain, cluster_sweep[1], chunksize=1),
        )
        results["root_mirror"] = JoinedResult([
            sweep_pool.apply_async(_k1_root_mirror, (task,))
            for task in range(ROOT_MIRROR_TASKS)])
        full_pool, full_plain = start_full_width_plain(full_arrays)
        pools.append(full_pool)
        return run_all(device, peaks, (sweep, sweep_plain),
                       (large_sweep, large_plain), (cluster_sweep,
                                                    cluster_plain),
                       full_arrays, full_plain)
    finally:
        for pool in pools:
            pool.terminate()
            pool.join()


def run_all(device, peaks, k1_sweep, k3_sweep, cluster_sweep, full_arrays,
            full_plain) -> int:
    import numpy as np
    import torch

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
    phase("ptxas", **ptxas_phase())

    rng = np.random.default_rng(SEED)
    started = time.monotonic()
    rows, k1_ends, sweep_fields = run_kernel_phase(
        device, rng, peaks, *k1_sweep, *k3_sweep
    )
    kernels_s = time.monotonic() - started
    rows.update(run_traceback_phase(device, peaks))
    phase("kernels", k1_sweep=sweep_fields, k1_k2_k3_s=kernels_s,
          k4_s=time.monotonic() - started - kernels_s,
          **{name: {k: v for k, v in row.items()
                    if k not in ("name", "route", "source", "replaces")}
             for name, row in rows.items()})
    # the multi-warp and shared-memory rows, at pass E's shapes, and the
    # cluster kernels' rows at theirs
    long_rows, long_fields = run_long_shapes(device, peaks)
    rows.update(long_rows)
    ultra_rows, ultra_fields = run_ultra_shapes(device, peaks)
    rows.update(ultra_rows)
    phase("long_shapes", **long_fields, **ultra_fields)
    phase("cluster_sweep", widths=list(CLUSTER_SWEEP_WIDTHS),
          **run_cluster_sweep(device, rows, *cluster_sweep))

    fields, script_rows = run_scripts_phase(
        device, scripts_build, rows["K1"], k1_ends, full_arrays,
        full_plain, peaks,
    )
    phase("scripts", **fields)

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        workdir = Path(tmp)
        run_toy_e2e(workdir)
        phase("toy_e2e", ok=True)
        e2e = E2E(workdir, E2E_READS)
        result, launches = run_e2e(device, e2e)
        phase("e2e", **result)
        search_rows, fields, inputs = run_search_kernels(device, e2e, peaks)
        rows.update(search_rows)
        phase("search_kernels", **fields)
        bodies = fields["bodies"]
        sharded_rows, fields = run_sharded_kernels(device, e2e, peaks,
                                                   inputs)
        rows.update(sharded_rows)
        phase("sharded_kernels", **fields)
        result, launches_g = run_device_search_pass(device, e2e)
        phase("device_search", **result)
        result, launches_g2 = run_select_pass(e2e)
        phase("device_select", **result)
        result, launches_g3 = run_block_pass(e2e)
        phase("device_search_blocks", **result)
        result, launches_h = run_frontier_pass(e2e)
        phase("frontier_search", **result)
        result, launches_i = run_sharded_pass(e2e)
        phase("sharded_search", **result)
        phase("sharded_frontier", **run_sharded_frontier_pass(e2e))
        result, launches_dryrun = run_dryrun_phase(device)
        phase("dryrun", **result)
        phase("platform_cpu", **run_platform_cpu_pass(e2e))
        result, launches_c = run_traceback_pass(e2e)
        phase("traceback", **result)
        phase("process_set", **run_process_set_pass(e2e))
        phase("legacy", **run_legacy_pass(e2e))
        phase("server", **run_server_pass(e2e))
        phase("profile", **run_profile_pass(e2e))
        long = E2E(workdir / "long", LONG_READS[1], LONG_READS[0],
                   *LONG_READS[2:])
        result, launches_e = run_long_pass(long, rng)
        result["profiled"] = run_long_profile_pass(long)
        launches_ep = result["profiled"]["launches"]
        phase("long_reads", **result)
        ultra = E2E(workdir / "ultra", 1, LONG_READS[0], *ULTRA_READ,
                    LONG_READS[4])
        result_j, launches_j = run_ultra_pass(ultra, rng, result)
        phase("ultra_reads", **result_j)
        # every plain version run on the CPU beside the card, compared
        # (the search kernels' read the workload's index)
        phase("cpu_plain", seconds=CPU_PLAIN.settle())

    for name in ("K1", "K2", "K3"):
        rows[name]["launches"] = launches[name]
    rows["K1w"]["launches"] = launches_e["K1_wide"]
    rows["K1u"]["launches"] = launches_j["K1_cluster"]
    # K3u runs pass E's overhanging roots and pass J's
    rows["K3u"]["launches"] = (launches_e["K3_cluster"]
                               + launches_j["K3_cluster"])
    for name in ("K1", "K3"):
        rows[f"{name}s"]["launches"] = (launches_e[f"{name}_shared"]
                                        + launches_j[f"{name}_shared"])
    rows["K4"]["launches"] = launches_c["K4"]
    for name in ("K9", "K9x", "K9l", "K10"):
        rows[name]["launches"] = launches_g[name]
    rows["K11"]["launches"] = launches_h["K11"]
    # the search_kernels phase's replay of passes G and H launched what
    # they did, so its node and state counts are theirs
    check(bodies["pass_g_k10_launches"] == launches_g["K10"]
          and bodies["pass_h_k11_launches"] == launches_h["K11"],
          f"the replay of passes G and H ({bodies}) launched other than "
          f"they did (K10 {launches_g['K10']}, K11 {launches_h['K11']})")
    rows["K12"]["launches"] = launches_g2["K12"]
    rows["K11s"]["launches"] = launches_i["K11s"]
    for name in ("K13", "K13l"):
        rows[name]["launches"] = launches_dryrun[name]
    for key, _, layout, _, _ in K4_WIDE:
        rows[key]["launches"] = (launches_c.get(f"K4_{layout}", 0)
                                 + launches_ep.get(f"K4_{layout}", 0))
    rows.update(script_rows)
    phase("total", seconds=time.monotonic() - STARTED)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [
        {k: rows[name][k] for k in keys}
        for name in ("K1", "K1w", "K1u", "K1s", "K2", "K3", "K3u", "K3s",
                     "K4",
                     "K4r16", "K4r32", "K4s", "K5", "K6", "K7", "K8",
                     "K9", "K9x", "K9l", "K10", "K11", "K12", "K11s",
                     "K13", "K13l")
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
