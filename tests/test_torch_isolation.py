"""The port stands alone: floxer_tpu_torch and chip_smoke.py import nothing
of the JAX package floxer_tpu (not even its jax-free modules) and no jax.
The port carries its own copies of the reference's host modules and of its
native C++ sources; the copies stay equal to their originals, and the
index artifacts of the two packages load in each other."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "floxer_tpu_torch"
REFERENCE = ROOT / "floxer_tpu"

# the reference's modules the port carries, the same code below a header line
COPIED = [
    "alphabet.py", "cigar.py", "cli.py", "intervals.py", "output.py",
    "pex.py", "schemes.py", "search_host.py", "stats.py", "verify.py",
    "io/sam.py", "io/sequence_io.py", "index/fmindex.py",
    "ops/dp_reference.py", "ops/myers_banded.py", "utils/mathutils.py",
    "utils/introsort.py", "tools/simulated_dataset.py", "tools/merge_sam.py",
]
# the reference's functions and classes the port copies out of a module it
# does not carry whole; _BamShardCursor's _next_blob is repaired (R2: a
# 1-3-byte size prefix raises ValueError) and held by
# tests/test_torch_multihost.py instead
COPIED_DEFINITIONS = {
    "parallel/multihost.py": [
        "shard_queries", "shard_output_path", "_read_sam_query_groups",
        "merge_sam_shards", "_BamShardCursor", "merge_bam_shards",
    ],
    "parallel/sharded_index.py": [
        "HostShardedSingle", "shard_single_index", "ShardedHostIndex",
        "shard_full_index",
    ],
}
REPAIRED = {("_BamShardCursor", "_next_blob")}
# strings a copy words differently from its original, because the port's
# behaviour differs there: the original's text, the copy's
REWORDED = {
    "cli.py": [(
        '"Write a jax.profiler trace of the alignment phase to "\n'
        '              "this directory (view with TensorBoard/Perfetto)."',
        '"Write a torch.profiler Chrome trace of the alignment "\n'
        '              "phase to this directory (view with Perfetto)."',
    )],
}


def forbidden(module: str) -> bool:
    return any(
        module == name or module.startswith(name + ".")
        for name in ("floxer_tpu", "jax", "jaxlib")
    )


def port_files():
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py"
    ]


def test_no_port_file_imports_the_reference_or_jax():
    """An AST scan of every import statement (top level or inside a
    function) of the port, chip_smoke.py and the card tests."""
    found = []
    for path in port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [
                f"{path.relative_to(ROOT)}:{node.lineno} {name}"
                for name in names if forbidden(name)
            ]
    assert not found, found


E2E = """
import importlib, pkgutil, sys, tempfile
from pathlib import Path
import torch
import floxer_tpu_torch
for module in pkgutil.walk_packages(floxer_tpu_torch.__path__, "floxer_tpu_torch."):
    if not module.name.endswith("__main__"):
        importlib.import_module(module.name)
import floxer_tpu_torch.__main__, floxer_tpu_torch.pipeline
import floxer_tpu_torch.server, floxer_tpu_torch.verify_batch
from floxer_tpu_torch import pipeline
from floxer_tpu_torch.cli import parse_and_validate
data = Path(sys.argv[1])
with tempfile.TemporaryDirectory() as tmp:
    for engine, extra in (("device", []), ("batched", []),
                          ("batched", ["--device-search"]),
                          ("reference", ["--device-search"]),
                          ("batched", ["--index-shards", "2"])):
        name = engine + "".join(extra)
        cli = parse_and_validate([
            "--reference", str(data / "reference.fasta"),
            "--queries", str(data / "queries.fastq"),
            "--output", f"{tmp}/{name}.sam",
            "--query-errors", "2", "--seed-errors", "1",
            "--extra-verification-ratio", "2", "--interval-optimization",
            "--engine", engine, *extra,
        ])
        assert pipeline.run(cli, device=torch.device("cpu")) == 0
        assert Path(f"{tmp}/{name}.sam").read_text().count("query2") == 2
print("\\n".join(sorted(sys.modules)))
"""


def test_port_runs_without_loading_the_reference(data_dir):
    """Import every module of the port, run the toy e2e on the CPU (fused
    device waves through the plain versions, the batched engine, the
    batched and reference engines with --device-search, and the sharded
    index), then list sys.modules: no floxer_tpu module and no jax."""
    proc = subprocess.run(
        [sys.executable, "-c", E2E, str(data_dir)],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT), "CUDA_VISIBLE_DEVICES": ""},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    modules = proc.stdout.split()
    assert "floxer_tpu_torch.verify_batch" in modules
    assert "floxer_tpu_torch.native" in modules
    assert [m for m in modules if forbidden(m)] == []


def test_native_sources_are_byte_copies():
    port = sorted(p.name for p in (PORT / "native" / "csrc").glob("*.cpp"))
    reference = sorted(p.name for p in (REFERENCE / "native").glob("*.cpp"))
    assert port == reference
    for name in port:
        assert (PORT / "native" / "csrc" / name).read_bytes() == (
            REFERENCE / "native" / name
        ).read_bytes(), name


def code_of(source: str) -> str:
    """A module's syntax tree with every docstring emptied: its code
    without comments and docstrings."""
    tree = ast.parse(source)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (
            isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))
            and body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)
        ):
            body[0].value.value = ""
    return ast.dump(tree)


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_equals_its_original(module):
    """Each copy is its original below one header line naming it: the same
    code (its docstrings may differ, and the strings REWORDED names)."""
    header, body = (PORT / module).read_text().split("\n", 1)
    assert header.startswith(f"# Copied from floxer_tpu/{module}")
    original = (REFERENCE / module).read_text()
    for theirs, ours in REWORDED.get(module, []):
        assert original.count(theirs) == 1 and body.count(ours) == 1
        original = original.replace(theirs, ours)
    assert code_of(body) == code_of(original)


def test_index_artifacts_load_across_packages(tmp_path):
    """An index saved by either package is byte-identical to the other's
    and loads in the other with the same locate results, so a user's
    cached index keeps working."""
    from floxer_tpu.index.fmindex import FmIndex as RefIndex
    from floxer_tpu_torch.index.fmindex import FmIndex as PortIndex

    rng = np.random.default_rng(5)
    sequences = [rng.integers(1, 5, size=n).astype(np.uint8) for n in (700, 90)]
    paths = {}
    for name, cls in (("ref", RefIndex), ("port", PortIndex)):
        paths[name] = tmp_path / f"{name}.npz"
        cls(sequences).save(paths[name])
    assert paths["ref"].read_bytes() == paths["port"].read_bytes()
    rows = np.arange(len(sequences[0]) + len(sequences[1]) + 2)
    for saved, loader in (("ref", PortIndex), ("port", RefIndex)):
        loaded = loader.load(paths[saved])
        want = RefIndex.load(paths["ref"]).locate_batch(rows)
        for got, expected in zip(loaded.locate_batch(rows), want):
            np.testing.assert_array_equal(got, expected)


def definitions_of(source: str, names) -> dict:
    """{name: code of that top-level function or class}, docstrings
    emptied and the methods in REPAIRED left out."""
    found = {}
    for node in ast.parse(source).body:
        if getattr(node, "name", None) in names:
            if isinstance(node, ast.ClassDef):
                node.body = [
                    item for item in node.body
                    if (node.name, getattr(item, "name", None)) not in REPAIRED
                ]
            found[node.name] = code_of(ast.unparse(node))
    return found


@pytest.mark.parametrize("module", sorted(COPIED_DEFINITIONS))
def test_copied_definitions_equal_their_originals(module):
    """A partial copy names its original in line 1 and carries the listed
    definitions with their code (the repaired method aside)."""
    names = COPIED_DEFINITIONS[module]
    port_source = (PORT / module).read_text()
    assert port_source.startswith(f"# Copied from floxer_tpu/{module}")
    got = definitions_of(port_source, names)
    want = definitions_of((REFERENCE / module).read_text(), names)
    assert sorted(got) == sorted(names)
    assert got == want


def test_scaling_bench_copy_spawns_the_port():
    """tools/scaling_bench.py is its original with the spawned module
    floxer_tpu_torch instead of floxer_tpu."""
    module = "tools/scaling_bench.py"
    header, body = (PORT / module).read_text().split("\n", 1)
    assert header.startswith(f"# Copied from floxer_tpu/{module}")
    original = (REFERENCE / module).read_text()
    spawn = '"-m", "floxer_tpu",'
    assert original.count(spawn) == 1
    assert code_of(body) == code_of(
        original.replace(spawn, '"-m", "floxer_tpu_torch",')
    )
