"""Nothing the benchmark runs loads JAX or the JAX package. Modules are
compared by their whole top-level name: the port, floxer_tpu_torch, begins
with the JAX package's name and is not it."""

import ast
import subprocess
import sys
import types
from pathlib import Path

import pytest

from benchmark import control, run
from benchmark.run import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("names, found", [
    (["floxer_tpu_torch", "floxer_tpu_torch.server", "numpy"], []),
    (["floxer_tpu.pipeline"], ["floxer_tpu"]),
    (["floxer_tpu"], ["floxer_tpu"]),
    (["jaxlib.xla_client", "jax", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jaxtyping", "flax_helpers", "floxer_tpux"], []),
])
def test_top_level_names_are_compared_whole(names, found):
    assert forbidden_modules(names) == found


def _imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    sources = [p for p in (ROOT / "benchmark").rglob("*.py")
               if "tests" not in p.parts]
    assert sources
    for path in sources:
        assert not forbidden_modules(_imported(path)), path


def test_the_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "simulate.py"):
        imported = _imported(ROOT / "benchmark" / name)
        assert imported <= {"__future__", "math", "re", "dataclasses",
                            "numpy"}, (name, imported)


def test_a_fresh_process_of_the_harness_and_the_server_loads_no_jax():
    code = (
        "import sys, benchmark.run, benchmark.control, benchmark.trace\n"
        "import floxer_tpu_torch.server, floxer_tpu_torch.pipeline\n"
        "from floxer_tpu_torch import cli, verify_batch, search_device\n"
        "print(benchmark.run.forbidden_modules(list(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def _load_jax_late(monkeypatch):
    """A module named jax that turns up after the window, as one that a
    metric's reader or the check imported would."""
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))


def test_a_run_that_loaded_jax_by_its_end_prints_no_result(monkeypatch,
                                                            capsys):
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(run, "require_gpu", lambda chips: None)
    monkeypatch.setattr(run, "run_cell", lambda *args: (
        _load_jax_late(monkeypatch), {"correct": True})[1])
    code = run.main(["--workload", "chr21_ont20k", "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    captured = capsys.readouterr()
    assert code != 0 and captured.out == ""
    assert "jax" in captured.err


def test_the_control_that_loaded_jax_prints_no_result(monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(control, "control_numbers", lambda *args: (
        _load_jax_late(monkeypatch), {"correct": False})[1])
    code = control.main(["--workload", "chr21_ont20k", "--seed", "1"])
    captured = capsys.readouterr()
    assert code != 0 and captured.out == ""
    assert "jax" in captured.err
