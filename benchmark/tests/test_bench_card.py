"""The harness's look for a card, and a tiny cell on the card.

Without a CUDA card a run prints no result and exits non-zero; so does a
run from a directory that holds only BENCHMARK.json and the benchmark's
folder. The `cuda` tests run on the card:

    python -m pytest -p no:cacheprovider benchmark/tests -m cuda
"""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

from test_bench_faults import tiny  # noqa: F401 - the fixture

REPO = Path(__file__).resolve().parents[2]


def test_no_card_gives_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(REPO)
    code = run.main(["--workload", "chr21_ont20k", "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    assert code != 0
    assert capsys.readouterr().out == ""


def test_too_few_cards_give_no_result(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(run.RunFailed, match="asks for 1"):
        run.require_gpu(1)


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = subprocess.run(
        [sys.executable, "-m", "benchmark", "--workload", "chr21_ont20k",
         "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)},
    )
    assert out.returncode != 0
    assert out.stdout == ""


@pytest.mark.cuda
def test_a_tiny_cell_on_the_card(tiny, cuda_device, monkeypatch):  # noqa: F811
    monkeypatch.delenv("FLOXER_TPU_PLATFORM")
    assert run.require_gpu(1) == cuda_device
    result = tiny(device=cuda_device)
    assert result["correct"] is True, result["check"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["memory_peak_bytes"] > 0
