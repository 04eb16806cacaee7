"""BENCHMARK.json and the files it names, found by name.

A configuration is the file its entry names (`configs/<name>.json`), a
traffic mix `traffic/<name>.json`, a metric's reader `metrics/<name>.py`
(a metric name's dots become underscores there). A later cell, mix or
metric is new files and new entries: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass
from pathlib import Path

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
HERE = Path(__file__).resolve().parent


def valid_name(text) -> bool:
    return isinstance(text, str) and NAME.fullmatch(text) is not None


def valid_unit(text) -> bool:
    return isinstance(text, str) and UNIT.fullmatch(text) is not None


def check_manifest(manifest: dict) -> list[str]:
    """The naming rules of every name and unit; returns what breaks them."""
    problems = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [entry.get("name") for entry in manifest.get(section, [])]
        if len(set(names)) != len(names):
            problems.append(f"{section}: a name appears twice")
        for entry in manifest.get(section, []):
            for key in ("name", "config", "traffic"):
                if key in entry and not valid_name(entry[key]):
                    problems.append(f"{section}: bad {key} {entry[key]!r}")
            for key in entry.get("reduced", []):
                if not valid_name(key):
                    problems.append(f"{section}: bad reduced key {key!r}")
            if "unit" in entry and not valid_unit(entry["unit"]):
                problems.append(f"{section}: bad unit {entry['unit']!r}")
            if "better" in entry and entry["better"] not in ("lower", "higher"):
                problems.append(f"{section}: bad better {entry['better']!r}")
    return problems


@dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    root: Path = HERE


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(manifest_path: Path, workload: str,
              root: Path = HERE) -> Cell:
    """The cell named `workload`; `root` holds configs/, traffic/ and
    metrics/ (the benchmark's own folder)."""
    manifest = json.loads(Path(manifest_path).read_text())
    problems = check_manifest(manifest)
    if problems:
        raise ValueError("BENCHMARK.json: " + "; ".join(problems))
    cells = {entry["name"]: entry for entry in manifest["workloads"]}
    if workload not in cells:
        raise ValueError(f"no workload {workload!r} in {manifest_path}")
    entry = cells[workload]
    configs = {config["name"]: config for config in manifest["configs"]}
    config_entry = configs[entry["config"]]
    config = json.loads((Path(manifest_path).parent
                         / config_entry["file"]).read_text())
    traffic = json.loads(
        (root / "traffic" / f"{entry['traffic']}.json").read_text()
    )
    return Cell(
        name=workload,
        chips=int(entry["chips"]),
        config=config,
        traffic=traffic,
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, workload)],
        root=root,
    )


def metric_reader(name: str, root: Path = HERE):
    """The `read(run)` function of metrics/<name>.py."""
    path = root / "metrics" / f"{name.replace('.', '_')}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{path.stem}", path
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
