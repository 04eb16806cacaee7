"""Build and load the hand-written CUDA kernels.

Each source set is compiled with nvcc for Hopper (sm_90a), one nvcc per
source file, all started together, and linked into its own shared library
under build/floxer_tpu_torch_kernels/ at first use, then loaded with
ctypes: the aligner's kernels (csrc/*.cu, `ALIGNER`) and the
research scripts' kernels (scripts/csrc/*.cu, `SCRIPTS`), so the aligner
never builds the research kernels, and tools/k1_bench.py's own
(tools/csrc/*.cu, `BENCH`). A library's name carries a hash of its
sources and of the headers they include: those beside them (*.cuh, which
nvcc finds beside the including file) and any named from elsewhere (the
scripts' K5 includes the aligner's csrc/myers_banded_column.cuh, whose
directory goes on nvcc's include path), so an edited kernel or header is
never served from a stale build. A file lock per library keeps concurrent
processes from building it twice.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
BUILD_DIR = _PACKAGE_DIR.parent / "build" / "floxer_tpu_torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
# per source: ptxas reports every kernel's registers, stack and spills,
# kept beside the library (KernelLibrary.log_path)
COMPILE_FLAGS = ["-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    for candidate in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if candidate and os.path.isfile(candidate):
            return candidate
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels are built from floxer_tpu_torch's .cu sources at first use"
    )


class KernelLibrary:
    """One shared library built from every `*.cu` file of `csrc_dir`.

    `signatures` maps each C entry point to its argtypes (pointers and the
    stream as c_void_p); every entry returns cudaGetLastError() as an int.
    `extra_headers` are headers outside `csrc_dir` that its sources
    include by name.
    """

    def __init__(self, csrc_dir: Path, stem: str, signatures: dict,
                 extra_headers: tuple[Path, ...] = ()):
        self.csrc_dir = csrc_dir
        self.stem = stem
        self.signatures = signatures
        self.extra_headers = tuple(extra_headers)
        self.last_build_seconds: float | None = None
        self._lock = threading.Lock()
        self._library = None

    def sources(self) -> list[Path]:
        """The files nvcc compiles, one object each."""
        return sorted(self.csrc_dir.glob("*.cu"))

    def headers(self) -> list[Path]:
        """The headers the sources include."""
        return sorted(self.csrc_dir.glob("*.cuh")) + list(self.extra_headers)

    def include_flags(self) -> list[str]:
        """nvcc's -I for the extra headers' directories."""
        return [f"-I{d}" for d in sorted({h.parent for h in self.extra_headers})]

    def path(self) -> Path:
        digest = hashlib.sha256()
        for source in self.sources() + self.headers():
            digest.update(source.name.encode())
            digest.update(source.read_bytes())
        digest.update(" ".join(NVCC_FLAGS + COMPILE_FLAGS).encode())
        return BUILD_DIR / f"{self.stem}_{digest.hexdigest()[:16]}.so"

    def log_path(self) -> Path:
        """The compilers' output of the library's build (ptxas -v's
        report of every kernel)."""
        return self.path().with_suffix(".log")

    def _build(self, target: Path) -> None:
        """Compile every source to an object file, one nvcc each, all
        started together, then link them into `target` (under the build
        lock)."""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with open(BUILD_DIR / f"{self.stem}.lock", "w") as lock_file:
            fcntl.flock(lock_file, fcntl.LOCK_EX)
            try:
                if target.exists():
                    return
                started = time.monotonic()
                nvcc = _nvcc()
                compile_flags = [
                    *(f for f in NVCC_FLAGS if f != "-shared"), *COMPILE_FLAGS,
                    *self.include_flags(),
                ]
                with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
                    objects = [
                        Path(tmp_dir) / f"{s.stem}.o" for s in self.sources()
                    ]
                    compiles = [
                        subprocess.Popen(
                            [nvcc, *compile_flags, "-c", str(s), "-o", str(o)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True,
                        )
                        for s, o in zip(self.sources(), objects)
                    ]
                    logs = [p.communicate()[0] for p in compiles]
                    if any(p.returncode != 0 for p in compiles):
                        raise RuntimeError(
                            f"nvcc failed building {self.stem}:\n"
                            + "".join(logs)
                        )
                    tmp = Path(tmp_dir) / target.name
                    result = subprocess.run(
                        [nvcc, *NVCC_FLAGS, *map(str, objects), "-o", str(tmp)],
                        capture_output=True, text=True,
                    )
                    if result.returncode != 0:
                        raise RuntimeError(
                            f"nvcc failed linking {self.stem}:\n"
                            + result.stdout + result.stderr
                        )
                    log = Path(tmp_dir) / "build.log"
                    log.write_text("".join(logs))
                    os.replace(log, target.with_suffix(".log"))
                    os.replace(tmp, target)
                self.last_build_seconds = time.monotonic() - started
            finally:
                fcntl.flock(lock_file, fcntl.LOCK_UN)

    def load(self) -> ctypes.CDLL:
        """The library, built on first use. Raises when the build or the
        load fails; there is no fallback."""
        with self._lock:
            if self._library is None:
                target = self.path()
                if not target.exists():
                    self._build(target)
                library = ctypes.CDLL(str(target))
                for name, argtypes in self.signatures.items():
                    fn = getattr(library, name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                self._library = library
            return self._library

    def ptxas_usage(self) -> dict[str, dict[str, int]]:
        """Per kernel, what ptxas -v reported when the built library was
        compiled (parse_ptxas_log of log_path)."""
        return parse_ptxas_log(self.log_path().read_text())

    def sass(self) -> str:
        """The built library's machine code as `cuobjdump -sass` prints it
        (the CUDA toolkit's, beside nvcc). Raises when cuobjdump fails."""
        result = subprocess.run(
            [str(Path(_nvcc()).parent / "cuobjdump"), "-sass",
             str(self.path())],
            capture_output=True, text=True,
        )
        if result.returncode != 0:
            raise RuntimeError(f"cuobjdump failed on {self.path()}:\n"
                               + result.stdout + result.stderr)
        return result.stdout

    def launch(self, name: str, *args) -> None:
        """Call one C entry point; raise on a non-zero cudaError_t."""
        code = getattr(self.load(), name)(*args)
        if code != 0:
            raise RuntimeError(f"{name}: CUDA launch failed with error {code}")


ALIGNER = KernelLibrary(_PACKAGE_DIR / "csrc", "libfloxer_kernels", {
    # vp0, planes0, texts, stream, scalars, T, band_words, text_words,
    # dist, end, stream (the three K1 kernels)
    "floxer_myers_banded": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "floxer_myers_banded_reg": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "floxer_myers_banded_wide": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # ... text_words, blocks a cluster, dist, end, stream (K1u); band
    # words, blocks, the clusters the card holds (an int on the host)
    "floxer_myers_banded_cluster": [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P,
    ],
    "floxer_myers_banded_cluster_max_clusters": [_I, _I, _P],
    # peq, plen, texts, tlen, B, num_words, num_text, dist, end, stream
    "floxer_myers_small": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # peq, plen, texts, tlen, B, words_padded, num_text, dist, end, stream
    # (the K3 kernels)
    "floxer_myers_large": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "floxer_myers_large_reg": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    # ... num_text, blocks a cluster, dist, end, stream (K3u); words,
    # blocks, the clusters the card holds (an int on the host)
    "floxer_myers_large_cluster": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "floxer_myers_large_cluster_max_clusters": [_I, _I, _P],
    # windows, patterns, table, T, threads, stored, walk, dirs, ops,
    # num_ops, begin_cols, stream
    "floxer_traceback_banded": [
        _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P,
    ],
    # rows, occ, planes, row_offset, positions, B, out, stream (K9)
    "floxer_fm_rank": [_P, _P, _P, _I, _P, _I, _P, _P],
    # rows, occ, planes, row_offset, C, lb, lb_rev, length, B, left,
    # new_lb, new_lb_rev, counts, stream (K9x)
    "floxer_fm_extend": [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _P,
                         _P],
    # rows, occ, planes, bwt, C, sample_plane, sampled_values, n,
    # seq_starts, num_seqs, sampling_rate, rows, B, seq_ids, positions,
    # stream (K9l)
    "floxer_fm_locate": [_P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P, _I,
                         _P, _P, _P],
    # the blocks one SM holds of K10 (written to an int on the host)
    "floxer_workqueue_occupancy": [_P],
    # rows, fwd occ, fwd planes, rev occ, rev planes, rev_block_offset, C,
    # n, patterns, num_seeds, pad_len, seed_class, scheme, num_searches,
    # num_parts, key_words, report_capacity, reports, counters, scratch,
    # frame_capacity, budget, in_list, in_entries, generation, out_list,
    # list_capacity, root_nodes, blocks, stream (K10, one generation)
    "floxer_workqueue_search": [
        _P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I,
        _P, _P, _P, _I, _I, _P, _P, _P, _P, ctypes.c_longlong, _P, _I, _P,
    ],
    # rows, fwd occ, fwd planes, rev occ, rev planes, rev_block_offset, C,
    # n, patterns, seed_class, num_frontiers, num_seeds, pad_len, scheme,
    # num_searches, num_parts, capacity, report_capacity, max_iterations,
    # frontier, reports, stats, cluster, stream (K11)
    "floxer_frontier_search": [
        _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _P, _I, _I, _I,
        _I, _I, _P, _P, _P, _I, _P,
    ],
    # sharded, cluster, the clusters one card holds (written to an int on
    # the host) (K11)
    "floxer_frontier_max_clusters": [_I, _I, _P],
    # rows, shard_rows, rev_block_offset, fwd starts, fwd lengths, fwd
    # before, rev starts, rev lengths, rev before, num_shards, C, n,
    # patterns, seed_class, num_frontiers, num_seeds, pad_len, scheme,
    # num_searches, num_parts, capacity, report_capacity, max_iterations,
    # frontier, reports, stats, cluster, stream (K11 over the sharded
    # index)
    "floxer_frontier_search_sharded": [
        _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I,
        _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P,
    ],
    # rows, shard_rows, row_offset, starts, lengths, before, num_shards,
    # positions, B, out, stream (K13)
    "floxer_fm_sharded_rank": [_P, _I, _I, _P, _P, _P, _I, _P, _I, _P, _P],
    # rows, shard_rows, num_shards, bwt, bwt_stride, C, sampled_rows,
    # sampled_values, ns, seq_starts, num_seqs, sampling_rate, layout,
    # rows, B, seq_ids, positions, stream (K13l)
    "floxer_fm_sharded_locate": [
        _P, _I, _I, _P, _I, _P, _P, _P, _I, _P, _I, _I, _P, _P, _I, _P, _P,
        _P,
    ],
    # rows, occ, planes, bwt, C, sample_plane, sampled_values, n,
    # seq_starts, num_seqs, sampling_rate, lb, cnt, err, perm,
    # group_starts, totals, statuses, num_seeds, hard_cap, soft_cap,
    # choice_code, erase_useless, anchors, counts, scratch, shared_bytes,
    # stream (K12)
    "floxer_select_anchors": [
        _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P,
        _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P,
    ],
})

SCRIPTS = KernelLibrary(_PACKAGE_DIR / "scripts" / "csrc", "libfloxer_scripts", {
    # vp0, planes0, texts, pattern stream, scalars, rows, band_words,
    # num_text, variant flags, dist, end, stream
    "floxer_ablate_banded": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    # texts, starts, rows, num_text, variant, out, stream
    "floxer_column_loop": [_P, _P, _I, _I, _I, _P, _P],
    # texts, starts, rows, num_text, n_carry, n_ops, n_rolls, out, stream
    "floxer_carry_scaling": [_P, _P, _I, _I, _I, _I, _I, _P, _P],
    # texts, jstar, starts, rows, num_text, n_bcast, out, stream
    "floxer_bcast": [_P, _P, _P, _I, _I, _I, _P, _P],
}, extra_headers=(_PACKAGE_DIR / "csrc" / "myers_banded_column.cuh",))

# tools/k1_bench.py's own kernels (tools/csrc/*.cu), built only when the
# bench asks: the lockstep multi-warp K1 column and its ablations
BENCH = KernelLibrary(_PACKAGE_DIR / "tools" / "csrc", "libfloxer_bench", {
    # vp0, planes0, texts, pattern stream, scalars, T, band_words,
    # text_words, the parts dropped, dist, end, stream
    "floxer_wide_lockstep": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
}, extra_headers=(_PACKAGE_DIR / "csrc" / "myers_banded_column.cuh",))

launch = ALIGNER.launch


def parse_ptxas_log(text: str) -> dict[str, dict[str, int]]:
    """ptxas -v's info lines -> {mangled kernel name: {"registers",
    "stack", "spill_stores", "spill_loads"}}, and "shared" (bytes of
    static shared memory) for a kernel whose line reports any."""
    usage: dict[str, dict[str, int]] = {}
    name = None
    for line in text.splitlines():
        found = re.search(
            r"(?:Compiling entry function|Function properties for) '?([\w$]+)",
            line,
        )
        if found:
            name = found.group(1)
            usage.setdefault(name, {})
        found = re.search(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
            r"(\d+) bytes spill loads", line,
        )
        if found and name:
            usage[name].update(zip(
                ("stack", "spill_stores", "spill_loads"),
                map(int, found.groups()),
            ))
        found = re.search(r"Used (\d+) registers", line)
        if found and name:
            usage[name]["registers"] = int(found.group(1))
        found = re.search(r"(\d+) bytes smem", line)
        if found and name:
            usage[name]["shared"] = int(found.group(1))
    return usage


def sass_loops(text: str) -> dict[str, list[int]]:
    """`cuobjdump -sass` output -> {mangled kernel name: the instruction
    count of each innermost loop (a branch back to an earlier address and
    the instructions from there to it), in address order}."""
    loops_of = {}
    for function in re.split(r"\n\s*Function : ", "\n" + text)[1:]:
        name = function.split(None, 1)[0]
        code = [
            (int(address, 16), body) for address, body in
            re.findall(r"/\*([0-9a-f]+)\*/\s+([^;]*);", function)
        ]
        index = {address: i for i, (address, _) in enumerate(code)}
        loops = []
        for i, (address, body) in enumerate(code):
            found = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", body)
            if found:
                target = int(found.group(1), 16)
                if target < address and target in index:
                    loops.append((index[target], i))
        loops_of[name] = [
            last - first + 1 for first, last in sorted(loops)
            if not any(first <= f and l <= last and (f, l) != (first, last)
                       for f, l in loops)
        ]
    return loops_of


def check_operand(tensor, name: str, shape: tuple, dtype, device) -> None:
    """Validate one kernel operand (on either route, so the CPU tests
    catch what the CUDA kernel would refuse)."""
    if tensor.device != device:
        raise ValueError(f"{name}: on {tensor.device}, expected {device}")
    if tensor.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {tensor.dtype}")
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected shape {tuple(shape)}, got {tuple(tensor.shape)}"
        )
    if not tensor.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
