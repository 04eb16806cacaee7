"""A whole run on the CPU, past the harness's look for a card: the server
on a thread, set-up, a short window and the check, with the timed path
broken underneath at the one place every SAM record is written, or where
each read's alignments are handed to it. Each fault a cell of this
benchmark can have must turn `correct` false; the sound run stays
correct. (There is no exchange between chips: every cell
takes one.)"""

import json
import shutil
import time
from pathlib import Path

import pytest

from benchmark import manifest
from benchmark.run import run_cell
from floxer_tpu_torch import pipeline, pipeline_host
from floxer_tpu_torch.io import sam
from floxer_tpu_torch.ops.dp_reference import Orientation
from floxer_tpu_torch.verify import QueryAlignments

HERE = Path(__file__).resolve().parents[1]
REPO = HERE.parent


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    """A checkout-like root with one tiny cell of the chr21 settings."""
    monkeypatch.setenv("FLOXER_TPU_PLATFORM", "cpu")
    root = tmp_path / "benchmark"
    for sub in ("configs", "traffic"):
        (root / sub).mkdir(parents=True)
    shutil.copytree(HERE / "metrics", root / "metrics")
    config = json.loads((HERE / "configs/chr21_ont.json").read_text())
    config["genome"] = {"chromosome_length": 200000, "num_chromosomes": 2,
                        "seed": 3}
    (root / "configs/tiny.json").write_text(json.dumps(config))
    (root / "traffic/tiny_mix.json").write_text(json.dumps({
        "reads_per_job": 16, "read_length": 2000, "error_rate": 0.07,
        "reverse_share": 0.5, "argv": ["-p", "0.08"], "distinct_jobs": 2, "warmup_reads": 4,
        "optimum_sample": 6}))
    data = json.loads((REPO / "BENCHMARK.json").read_text())
    data["configs"] = [{"name": "tiny", "source": "a test",
                        "file": "benchmark/configs/tiny.json",
                        "reduced": [], "why": "a test"}]
    data["workloads"] = [{"name": "tiny_cell", "config": "tiny",
                          "traffic": "tiny_mix", "chips": 1, "why": "a test"}]
    for metric in data["per_layer"]:
        metric.pop("workloads", None)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    cell = manifest.load_cell(tmp_path / "BENCHMARK.json", "tiny_cell", root)

    def run(seed=2**31 + 3, device=None):
        return run_cell(cell, seed, 0.5, False, tmp_path, time.monotonic(),
                        device)
    return run


def _read_id(record) -> int:
    return int(record.qname.split("_")[1])


FAULTS = {
    # the step returns its state unchanged: nothing is written
    "unchanged": lambda write: (lambda self, record: None),
    # half of each batch left out
    "half": lambda write: (
        lambda self, record: None if _read_id(record) % 2
        else write(self, record)),
    # an answer altered where it is produced: one NM in four one higher
    "altered": lambda write: (
        lambda self, record: write(self, _bump(record))
        if _read_id(record) % 4 == 0 else write(self, record)),
}


def _bump(record):
    record.tags = [(tag, kind, value + 1) if tag == "NM" else (tag, kind, value)
                   for tag, kind, value in record.tags]
    return record


def test_a_sound_run_is_correct(tiny):
    result = tiny()
    assert result["correct"] is True, result["check"]
    assert result["failed"] == 0 and result["attempted"] >= 16
    assert set(result["metrics"]) == {"reads_per_s", "peak_mem_gib",
                                      "setup_s"}
    assert list(result)[-1] == "check"


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, fault):
    monkeypatch.setattr(sam.AlignmentOutput, "write_record",
                        FAULTS[fault](sam.AlignmentOutput.write_record))
    result = tiny()
    assert result["correct"] is False
    numbers = {name: item["value"] for name, item in result["check"].items()}
    if fault == "altered":
        assert numbers["record_faults"] > 0
    else:
        assert numbers["missing_reads"] > 0 and result["failed"] > 0


def _forward_only(write):
    """The reverse strand's search left out: each read keeps only its
    forward alignments, so a reverse read is written unmapped."""
    def written(output, query, alignments, references):
        kept = QueryAlignments(alignments.num_references)
        for reference_id, found in enumerate(alignments.per_reference):
            for alignment in found:
                if alignment.orientation != Orientation.REVERSE_COMPLEMENT:
                    kept.insert(alignment, reference_id)
        return write(output, query, kept, references)
    return written


def test_a_forward_only_search_is_not_correct(tiny, monkeypatch):
    for module in (pipeline, pipeline_host):
        monkeypatch.setattr(module, "write_alignments_for_query",
                            _forward_only(module.write_alignments_for_query))
    result = tiny()
    assert result["correct"] is False
    numbers = {name: item["value"] for name, item in result["check"].items()}
    assert numbers["origin_missed"] > 0
    assert numbers["missing_reads"] == 0 and numbers["record_faults"] == 0
