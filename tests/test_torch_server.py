"""The port's alignment server (floxer_tpu_torch/server.py) and the
pipeline's server-process bank cache.

A daemon started with --serve, with jax unimportable as on the GPU
machine, runs two --server jobs whose SAM is byte-identical to a direct
run, answers a ping, and exits 0 on --shutdown-server. In-process, a
persistent process reuses the resident reference bank across jobs, and
the cached bank holds no host copy of the genome (the reference's fault
R3 is not copied)."""

import json
import logging
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

from floxer_tpu_torch.cli import parse_and_validate
from floxer_tpu_torch import pipeline

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
JAX_BLOCKED = (
    "import runpy, sys; sys.modules['jax'] = None; "
    "sys.argv = ['floxer_tpu_torch'] + sys.argv[1:]; "
    "runpy.run_module('floxer_tpu_torch', run_name='__main__')"
)


def cli_args(data_dir, output, extra=()):
    return [
        "--reference", str(data_dir / "reference.fasta"),
        "--queries", str(data_dir / "queries.fastq"),
        "--output", str(output),
        "--query-errors", "2", "--seed-errors", "1",
        "--extra-verification-ratio", "2", "--interval-optimization",
        *extra,
    ]


def port_env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = str(ROOT)
    return env


def port_cli(args, **kwargs):
    return subprocess.run(
        [sys.executable, "-c", JAX_BLOCKED, *args],
        capture_output=True, text=True, env=port_env(), cwd=ROOT,
        timeout=300, **kwargs,
    )


def test_daemon_runs_jobs_with_jax_blocked(tmp_path, data_dir):
    sock = str(tmp_path / "floxer.sock")
    daemon = subprocess.Popen(
        [sys.executable, "-c", JAX_BLOCKED, "--serve", sock],
        stderr=subprocess.PIPE, text=True, env=port_env(), cwd=ROOT,
    )
    lines = []
    ready = threading.Event()

    def read_stderr():
        for line in daemon.stderr:
            lines.append(line)
            if "warm replay done fused=0" in line:
                ready.set()

    reader = threading.Thread(target=read_stderr, daemon=True)
    reader.start()
    try:
        assert ready.wait(timeout=120), "".join(lines)
        assert any(f"listening on {sock}" in line for line in lines)

        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as conn:
            conn.connect(sock)
            conn.sendall(b'{"op": "ping"}\n')
            assert json.loads(conn.makefile("r").readline()) == {"exit": 0}

        direct = tmp_path / "direct.sam"
        proc = port_cli(cli_args(data_dir, direct))
        assert proc.returncode == 0, proc.stderr
        for name in ("job1.sam", "job2.sam"):
            out = tmp_path / name
            proc = port_cli(["--server", sock, *cli_args(data_dir, out)])
            assert proc.returncode == 0, proc.stderr
            assert proc.stdout == ""
            assert "[server] [INFO] finished aligning successfully" in (
                proc.stderr
            )
            assert out.read_bytes() == direct.read_bytes()

        # a bad job fails on its own; the daemon keeps serving
        proc = port_cli(
            ["--server", sock, *cli_args(data_dir, tmp_path / "bad.sam")[:4]]
        )
        assert proc.returncode != 0
        assert daemon.poll() is None

        proc = port_cli(["--shutdown-server", sock])
        assert proc.returncode == 0, proc.stderr
        assert daemon.wait(timeout=60) == 0
        assert not os.path.exists(sock)
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait()
        reader.join(timeout=10)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_persistent_process_caches_the_bank(
    tmp_path, data_dir, monkeypatch
):
    """Two device runs in a persistent process: the second reuses the
    first's bank, which by then holds only its device copy."""
    monkeypatch.setattr(pipeline, "_PERSISTENT_PROCESS", True)
    monkeypatch.setattr(pipeline, "_RESIDENT_BANK_CACHE", {})
    outputs = []
    logs = []
    for job in range(2):
        output = tmp_path / f"job{job}.sam"
        records = _Records()
        cli = parse_and_validate(
            cli_args(data_dir, output, ["--engine", "device"])
        )
        assert pipeline.run(
            cli, device=CPU, extra_log_handler=records
        ) == 0
        outputs.append(output.read_bytes())
        logs.append(records.messages)
    assert outputs[0] == outputs[1]
    hits = [
        sum("resident reference bank: cache hit" in m for m in messages)
        for messages in logs
    ]
    assert hits == [0, 1]
    (bank,) = pipeline._RESIDENT_BANK_CACHE.values()
    deadline = time.monotonic() + 30
    while bank._flat is None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert bank._flat is not None
    assert bank._sequences == [] and bank._words is None


def test_job_error_returns_exit_minus_one(monkeypatch):
    """A job that raises answers {"exit": -1} and leaves the daemon up."""
    from floxer_tpu_torch import server

    def boom(cli, **kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(pipeline, "run", boom)
    lines = []
    code = server._execute_job(
        {"argv": cli_args(Path("tests/data"), "x.sam")}, lines.append
    )
    assert code == -1
    assert any("job failed: boom" in line["log"]["message"] for line in lines)


def test_failed_kernel_build_fails_device_jobs(tmp_path, data_dir, monkeypatch):
    """A warmup whose kernel build failed fails every job that would use
    the device, and never routes it quietly to the host; host-only jobs
    still run."""
    warmup = pipeline._DeviceWarmup()
    warmup._error = RuntimeError("nvcc failed")
    monkeypatch.setattr(pipeline, "_WARMUP", warmup)
    cli = parse_and_validate(cli_args(data_dir, tmp_path / "device.sam"))
    assert pipeline.run(
        cli, device=CPU, use_device=pipeline._accelerator_ready
    ) != 0
    cli = parse_and_validate(cli_args(data_dir, tmp_path / "host.sam"))
    assert pipeline.run(cli, device=CPU, use_device=False) == 0
