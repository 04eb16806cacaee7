"""BENCHMARK.json's names and units, and the files it names found by name:
a new configuration, traffic mix or per-layer metric is new files and a
new entry, with no edit to a file that is there."""

import json
import shutil
from pathlib import Path

import pytest

from benchmark import manifest
from benchmark.run import RunData

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"


def repo_manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("name, ok", [
    ("chr21_ont20k", True), ("mfu.train", True), ("_x-1", True),
    ("9lives", True), ("a" * 64, True), ("a" * 65, False),
    ("has space", False), ("a,b", False), ("a/b", False), ("", False),
    (".hidden", False), ("µs", False),
])
def test_names(name, ok):
    assert manifest.valid_name(name) is ok


@pytest.mark.parametrize("unit, ok", [
    ("reads/s", True), ("%", True), ("s/kread", True), ("GiB", True),
    ("tokens per second", False), ("us", True), ("µs", False),
    ("a" * 17, False), ("", False),
])
def test_units(unit, ok):
    assert manifest.valid_unit(unit) is ok


def test_the_repository_manifest_keeps_the_rules():
    data = repo_manifest()
    assert manifest.check_manifest(data) == []
    assert set(data) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert "setup_s" in {m["name"] for m in data["end_to_end"]}
    for entry in data["per_layer"]:
        assert entry["moves"] in {m["name"] for m in data["end_to_end"]}


def test_every_cell_of_the_repository_loads_with_its_files():
    data = repo_manifest()
    for workload in data["workloads"]:
        cell = manifest.load_cell(ROOT / "BENCHMARK.json", workload["name"])
        assert cell.config["name"] == workload["config"]
        assert cell.per_layer and cell.end_to_end
        for metric in cell.per_layer + cell.end_to_end:
            assert callable(manifest.metric_reader(metric["name"]))
    for config in data["configs"]:
        assert (ROOT / config["file"]).is_file()
        assert config["file"].startswith("benchmark/configs/")


def test_broken_names_are_refused(tmp_path):
    data = repo_manifest()
    data["end_to_end"][0]["unit"] = "reads per second"
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(data))
    with pytest.raises(ValueError, match="bad unit"):
        manifest.load_cell(path, data["workloads"][0]["name"])


def test_a_cell_config_mix_and_metric_are_added_as_files(tmp_path):
    """A copy of the benchmark's folder gains a configuration, a traffic
    mix and a metric as new files and entries; every file already there
    stays byte for byte as it was."""
    root = tmp_path / "benchmark"
    shutil.copytree(HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    config = json.loads((root / "configs/chr21_ont.json").read_text())
    config.update(name="chr21_hifi", argv=["--threads", "4"])
    (root / "configs/chr21_hifi.json").write_text(json.dumps(config))
    (root / "traffic/hifi15k_e1_p01.json").write_text(json.dumps({
        "reads_per_job": 10, "read_length": 15000, "error_rate": 0.01,
        "reverse_share": 0.5,
        "argv": ["-p", "0.01"], "distinct_jobs": 2, "warmup_reads": 5,
        "optimum_sample": 4}))
    (root / "metrics/jobs_in_window.py").write_text(
        "def read(run):\n    return float(len(run.ok_jobs))\n")
    data = repo_manifest()
    data["configs"].append({
        "name": "chr21_hifi", "source": "a test",
        "file": "benchmark/configs/chr21_hifi.json", "reduced": [],
        "why": "a test"})
    data["workloads"].append({
        "name": "chr21_hifi15k", "config": "chr21_hifi",
        "traffic": "hifi15k_e1_p01", "chips": 1, "why": "a test"})
    data["per_layer"].append({
        "name": "jobs_in_window", "unit": "jobs", "better": "higher",
        "source": "host_clock", "layer": "server and pipeline",
        "moves": "reads_per_s", "workloads": ["chr21_hifi15k"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))

    cell = manifest.load_cell(tmp_path / "BENCHMARK.json", "chr21_hifi15k",
                              root)
    assert cell.config["argv"] == ["--threads", "4"]
    assert cell.traffic["read_length"] == 15000
    assert "jobs_in_window" in [m["name"] for m in cell.per_layer]
    assert "host_search_s" not in [m["name"] for m in cell.per_layer]
    reader = manifest.metric_reader("jobs_in_window", root)
    assert reader(RunData([], None, cell.config, cell.traffic, 1.0, 0)) == 0.0
    assert {p: p.read_bytes() for p in before} == before
