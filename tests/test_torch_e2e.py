"""The port's pipeline and CLI end to end (floxer_tpu_torch.pipeline,
python -m floxer_tpu_torch) on the reference's tiny e2e data.

The port's SAM must be byte-identical to python -m floxer_tpu's; the port
must run with jax unimportable (as on the GPU machine, which has no jax);
every option the port does not cover yet must fail loudly, and the options
and modes ported since must write the reference's SAM."""

import json
import os
import socketserver
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from floxer_tpu_torch.cli import parse_and_validate
from floxer_tpu_torch import pipeline, server, tracing
from floxer_tpu_torch.__main__ import main
from floxer_tpu_torch.backend import accelerator_available
from test_e2e import check_output_records, parse_sam

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def cli_args(data_dir, output, extra=()):
    return [
        "--reference", str(data_dir / "reference.fasta"),
        "--queries", str(data_dir / "queries.fastq"),
        "--output", str(output),
        "--query-errors", "2", "--seed-errors", "1",
        "--extra-verification-ratio", "2", "--interval-optimization",
        *extra,
    ]


def env_without_gpu():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = str(ROOT)
    return env


@pytest.fixture(scope="module")
def reference_sam(tmp_path_factory, data_dir):
    """SAM of the JAX package (python -m floxer_tpu, CPU backend)."""
    output = tmp_path_factory.mktemp("reference") / "out.sam"
    env = env_without_gpu()
    env["FLOXER_TPU_PLATFORM"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-m", "floxer_tpu", *cli_args(data_dir, output)],
        capture_output=True, text=True, env=env, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr
    return output.read_bytes()


@pytest.mark.parametrize("engine", ["device", "batched", "reference"])
def test_run_matches_reference_sam(tmp_path, data_dir, reference_sam, engine):
    """--engine device fuses every wave (plain kernel versions on the CPU);
    the other engines run on the host."""
    output = tmp_path / "out.sam"
    cli = parse_and_validate(
        cli_args(data_dir, output, ["--engine", engine])
    )
    assert pipeline.run(cli, device=CPU) == 0
    assert output.read_bytes() == reference_sam
    check_output_records(parse_sam(output))


def test_cli_runs_with_jax_unimportable(tmp_path, data_dir, reference_sam):
    """The port never imports jax: with jax blocked the CLI still runs,
    writes the reference's SAM and keeps stdout empty."""
    output = tmp_path / "out.sam"
    code = (
        "import runpy, sys; sys.modules['jax'] = None; "
        "sys.argv = ['floxer_tpu_torch'] + sys.argv[1:]; "
        "runpy.run_module('floxer_tpu_torch', run_name='__main__')"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code, *cli_args(data_dir, output)],
        capture_output=True, text=True, env=env_without_gpu(), cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout == ""
    assert output.read_bytes() == reference_sam


def test_no_module_of_the_port_imports_jax():
    package = ROOT / "floxer_tpu_torch"
    sources = list(package.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for source in sources:
        text = source.read_text()
        assert "import jax" not in text and "from jax" not in text, source


def test_engine_device_without_hopper_gpu_fails(tmp_path, data_dir):
    proc = subprocess.run(
        [
            sys.executable, "-m", "floxer_tpu_torch",
            *cli_args(data_dir, tmp_path / "out.sam", ["--engine", "device"]),
        ],
        capture_output=True, text=True, env=env_without_gpu(), cwd=ROOT,
    )
    assert proc.returncode != 0
    assert "compute capability" in proc.stderr
    assert not (tmp_path / "out.sam").exists()


SERVER_FLAGS = ("--serve", "--server", "--shutdown-server")


def serve_in_thread(sock: str):
    """python -m floxer_tpu_torch --serve SOCK, in a thread of this
    process; returns (thread, result) once the daemon answers a ping. The
    socket file appears at bind(), before listen(), so a client that
    connects as soon as it exists can be refused."""
    result = {}
    thread = threading.Thread(
        target=lambda: result.setdefault("code", main(["--serve", sock])),
        daemon=True,
    )
    thread.start()
    deadline = time.monotonic() + 60
    while True:
        try:
            if server._request(sock, {"op": "ping"}) == 0:
                return thread, result
        except (ConnectionRefusedError, FileNotFoundError):
            pass
        assert time.monotonic() < deadline, "the server did not answer a ping"
        time.sleep(0.05)


def test_serve_in_thread_waits_until_the_server_listens(
    tmp_path, data_dir, reference_sam, monkeypatch
):
    """A daemon slow between bind() and listen() (server_activate delayed
    by 0.5 s): the helper still returns a server that answers a job."""
    activate = socketserver.TCPServer.server_activate

    def slow_activate(self):
        time.sleep(0.5)
        activate(self)

    monkeypatch.setattr(socketserver.TCPServer, "server_activate",
                        slow_activate)
    sock = str(tmp_path / "sock")
    output = tmp_path / "out.sam"
    thread, result = serve_in_thread(sock)
    try:
        assert main(["--server", sock, *cli_args(data_dir, output)]) == 0
        assert output.read_bytes() == reference_sam
    finally:
        assert main(["--shutdown-server", sock]) == 0
        thread.join(timeout=60)
    assert not thread.is_alive() and result["code"] == 0


@pytest.mark.parametrize(
    "extra",
    [
        ["--device-search", "--engine", "reference"],
        ["--index-shards", "2"],
        ["--profile", "trace_dir"],
        ["--serve", "sock"],
        ["--server", "sock"],
        ["--shutdown-server", "sock"],
    ],
)
def test_unported_options_fail(tmp_path, data_dir, reference_sam, extra,
                               monkeypatch):
    """Every option of the reference CLI is ported now. --device-search
    with --engine reference (the per-query frontier search, its plain
    version with device=cpu) writes the reference's SAM, as
    --device-search under the batched engines does
    (test_device_search_writes_reference_sam); so does --index-shards 2
    (frontier searches over the row-sharded index, K11 over the shard
    tables on the card; tests/test_torch_sharded_index.py holds it at 8
    shards and under every engine). --profile and the server flags are
    ported: --profile writes a torch.profiler trace and the reference's
    SAM; a job through --serve / --server writes the reference's SAM and
    --shutdown-server stops the daemon. (Multi-host and multi-process runs
    are ported too: tests/test_torch_multihost.py.)"""
    output = tmp_path / "out.sam"
    args = cli_args(data_dir, output)
    if extra[0] in ("--device-search", "--index-shards"):
        from floxer_tpu_torch.ops import frontier

        calls = []
        original = frontier.frontier_search_plain

        def counted(index, *call_args, **kwargs):
            calls.append(hasattr(index, "num_shards"))
            return original(index, *call_args, **kwargs)

        monkeypatch.setattr(frontier, "frontier_search_plain", counted)
        cli = parse_and_validate(args + extra)
        assert pipeline.run(cli, device=CPU) == 0
        assert calls, "no frontier search ran"
        assert all(calls) == (extra[0] == "--index-shards")
        assert output.read_bytes() == reference_sam
        check_output_records(parse_sam(output))
        return
    if extra[0] == "--profile":
        trace_dir = tmp_path / extra[1]
        assert main(args + ["--profile", str(trace_dir)]) == 0
        assert output.read_bytes() == reference_sam
        traces = list(trace_dir.glob("*.json"))
        assert len(traces) == 1
        assert "traceEvents" in json.loads(traces[0].read_text())
        return
    if extra[0] in SERVER_FLAGS:
        sock = str(tmp_path / extra[1])
        thread, result = serve_in_thread(sock)
        try:
            assert main(["--server", sock, *args]) == 0
            assert output.read_bytes() == reference_sam
        finally:
            assert main(["--shutdown-server", sock]) == 0
            thread.join(timeout=60)
        assert not thread.is_alive() and result["code"] == 0
        assert not os.path.exists(sock)
        return
    raise AssertionError(f"no case for {extra}")


@pytest.mark.parametrize(
    "env_name",
    [
        "FLOXER_TPU_DEVICE_TRACEBACK",
        "FLOXER_TPU_NO_NATIVE",
        "FLOXER_TPU_LEGACY_VERIFY",
    ],
)
def test_unported_modes_fail(
    tmp_path, data_dir, reference_sam, monkeypatch, env_name
):
    """Runs without the native library and the legacy object path are
    ported: the CLI writes the reference's SAM. Device tracebacks are
    ported too, but need a Hopper GPU: without one (and without an explicit
    device) the CLI exits non-zero instead of tracing back elsewhere; with
    an explicit CPU device the run writes the reference's SAM."""
    env = env_without_gpu()
    env[env_name] = "1"
    output = tmp_path / "out.sam"
    proc = subprocess.run(
        [sys.executable, "-m", "floxer_tpu_torch", *cli_args(data_dir, output)],
        capture_output=True, text=True, env=env, cwd=ROOT,
    )
    if env_name != "FLOXER_TPU_DEVICE_TRACEBACK":
        assert proc.returncode == 0, proc.stderr
        assert output.read_bytes() == reference_sam
        return
    assert proc.returncode != 0
    assert "FLOXER_TPU_DEVICE_TRACEBACK" in proc.stderr
    assert "Hopper" in proc.stderr
    assert not output.exists()

    from floxer_tpu_torch.ops import traceback_device

    tasks = []
    original = traceback_device.banded_cigar_traceback_device_batch

    def counting(batch, device, **kwargs):
        tasks.extend(batch)
        return original(batch, device, **kwargs)

    monkeypatch.setattr(
        traceback_device, "banded_cigar_traceback_device_batch", counting
    )
    monkeypatch.setenv(env_name, "1")
    cli = parse_and_validate(cli_args(data_dir, output))
    assert pipeline.run(cli, device=CPU) == 0
    assert tasks, "no traceback ran on the device"
    assert output.read_bytes() == reference_sam


def test_no_accelerator_on_this_host_means_host_waves(tmp_path, data_dir):
    """Without a Hopper GPU the default engine keeps every wave on the
    native host engine (no fused dispatch)."""
    if accelerator_available():
        pytest.skip("this host has a Hopper GPU")
    cli = parse_and_validate(cli_args(data_dir, tmp_path / "out.sam"))
    assert pipeline.run(cli) == 0
    job = tracing.last_job()
    assert job.counter("verify.fused_dispatches") == 0
    assert job.counter("verify.cells_device") == 0


@pytest.fixture(scope="module")
def reference_device_search_sam(tmp_path_factory, data_dir):
    """SAM of python -m floxer_tpu --device-search (the work-queue search
    on JAX's CPU backend)."""
    output = tmp_path_factory.mktemp("reference_ds") / "out.sam"
    env = env_without_gpu()
    env["FLOXER_TPU_PLATFORM"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-m", "floxer_tpu",
         *cli_args(data_dir, output, ["--device-search"])],
        capture_output=True, text=True, env=env, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr
    return output.read_bytes()


@pytest.mark.parametrize("engine", ["batched", "device"])
def test_device_search_writes_reference_sam(
    tmp_path, data_dir, reference_sam, reference_device_search_sam, engine
):
    """run(..., device=cpu) with --device-search (the work queue's plain
    version, one dispatch a chunk) writes the reference's SAM, which is
    also the reference's --device-search SAM."""
    from floxer_tpu_torch.search_device import DeviceSearcher

    output = tmp_path / "out.sam"
    cli = parse_and_validate(
        cli_args(data_dir, output, ["--engine", engine, "--device-search"])
    )
    before = DeviceSearcher._chunk_dispatches
    assert pipeline.run(cli, device=CPU) == 0
    assert DeviceSearcher._chunk_dispatches > before
    assert output.read_bytes() == reference_sam
    assert reference_device_search_sam == reference_sam


def test_device_search_without_gpu_fails(tmp_path, data_dir, monkeypatch):
    """--device-search with no CUDA device and no device given exits
    non-zero and writes nothing; it does not fall back to the host."""
    monkeypatch.setattr(pipeline, "accelerator_available", lambda: False)
    output = tmp_path / "out.sam"
    assert main(cli_args(data_dir, output, ["--device-search"])) != 0
    assert not output.exists()


def test_reference_engine_device_search_without_gpu_fails(tmp_path, data_dir,
                                                          monkeypatch):
    """--engine reference --device-search (the per-query frontier) with no
    CUDA device and no device given exits non-zero and writes nothing."""
    monkeypatch.setattr(pipeline, "accelerator_available", lambda: False)
    output = tmp_path / "out.sam"
    args = cli_args(data_dir, output, ["--engine", "reference",
                                       "--device-search"])
    assert main(args) != 0
    assert not output.exists()


def test_platform_cpu_keeps_run_on_the_cpu(tmp_path, data_dir, reference_sam,
                                           monkeypatch):
    """FLOXER_TPU_PLATFORM=cpu (fault F2, repaired): with a Hopper GPU
    reported present, run() still takes the CPU where it would take
    cuda:0, so the batched engine keeps every wave on the host and starts
    no kernel warmup, and --engine device runs on the plain versions;
    both write the reference's SAM. accelerator_available() itself is
    False under the variable."""
    from floxer_tpu_torch import backend

    monkeypatch.setattr(pipeline, "accelerator_available", lambda: True)
    monkeypatch.setenv("FLOXER_TPU_PLATFORM", "cpu")
    assert not backend.accelerator_available()
    warmups = []
    monkeypatch.setattr(pipeline, "start_device_warmup",
                        lambda *args: warmups.append(args))
    devices = []
    original = pipeline.verify_and_write_chunk

    def spy(*args, **kwargs):
        devices.append(kwargs.get("device"))
        return original(*args, **kwargs)

    monkeypatch.setattr(pipeline, "verify_and_write_chunk", spy)
    for engine in ("batched", "device"):
        output = tmp_path / f"{engine}.sam"
        cli = parse_and_validate(cli_args(data_dir, output,
                                          ["--engine", engine]))
        assert pipeline.run(cli) == 0
        assert output.read_bytes() == reference_sam
        assert devices and set(devices) == {CPU}
        fused = tracing.last_job().counter("verify.fused_dispatches")
        assert (fused > 0) == (engine == "device")
        devices.clear()
    assert warmups == []


@pytest.mark.parametrize("value", ["tpu", "cuda", ""])
def test_platform_other_values_leave_the_choice(monkeypatch, value):
    """Any FLOXER_TPU_PLATFORM value other than cpu leaves the port's
    device choice as it is (the reference hands the value to
    jax_platforms; an intended divergence)."""
    from floxer_tpu_torch import backend

    monkeypatch.setenv("FLOXER_TPU_PLATFORM", value)
    assert not backend.cpu_requested()
    assert backend.accelerator_available() == (
        torch.cuda.is_available()
        and torch.cuda.get_device_capability(0) >= backend.MIN_CAPABILITY
    )
    monkeypatch.setenv("FLOXER_TPU_PLATFORM", " CPU ")
    assert backend.cpu_requested() and not backend.accelerator_available()
