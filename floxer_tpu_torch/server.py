"""Persistent alignment server: amortize per-process costs across CLI runs.

Counterpart of floxer_tpu/server.py. The daemon builds and warms the CUDA
kernels once, keeps loaded indexes and the resident reference bank across
jobs, and runs each job's normal CLI invocation inside the process:

    python -m floxer_tpu_torch --serve /tmp/floxer.sock
    python -m floxer_tpu_torch --server /tmp/floxer.sock <normal args>
    python -m floxer_tpu_torch --shutdown-server /tmp/floxer.sock

Protocol (the reference's): newline-delimited JSON over a Unix stream
socket. The client sends one request line `{"argv": [...], "cwd": "..."}`
(or `{"op": "ping"}` / `{"op": "shutdown"}`); the server streams back
`{"log": {...}}` lines (mirrored logging records) followed by one
`{"exit": N}` line. Jobs run one at a time under one lock: the process owns
one GPU. A job that fails returns `{"exit": -1}` without stopping the
daemon.

Left out against the reference: the TPU backend probe and the hard
os._exit at teardown (a workaround for the TPU plugin's destructors).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import socketserver
import sys
import threading
import time

logger = logging.getLogger("floxer-tpu")


class _JobLogHandler(logging.Handler):
    """Mirrors log records of one job to the client connection."""

    def __init__(self, send_line):
        super().__init__(level=logging.DEBUG)
        self._send_line = send_line

    def emit(self, record: logging.LogRecord) -> None:
        self._send_line(
            {"log": {"level": record.levelname, "message": record.getMessage()}}
        )


def _execute_job(request: dict, send_line) -> int:
    from .cli import parse_and_validate

    from . import pipeline, tracing

    started = tracing.now()
    argv = request.get("argv", [])
    cwd = request.get("cwd")
    if cwd:
        os.chdir(cwd)
    try:
        cli = parse_and_validate(argv)
    except (ValueError, SystemExit) as error:
        send_line(
            {"log": {"level": "ERROR", "message": f"[CLI PARSER ERROR] {error}"}}
        )
        return -1
    handler = _JobLogHandler(send_line)

    def emit(line: str) -> None:
        # to this job's client only: the server's own log stays short
        handler.handle(logging.makeLogRecord(
            {"name": logger.name, "levelno": logging.INFO,
             "levelname": "INFO", "msg": line}
        ))

    try:
        # the job span runs from the request's parse to its exit code; with
        # tracing on (a profiler running, or --profile), the job's
        # `trace spans:` line reaches the client before the exit line
        with tracing.job(on=bool(cli.profile_dir), started_ns=started,
                         emit=emit):
            return pipeline.run(cli, extra_log_handler=handler)
    except Exception as error:  # noqa: BLE001 - a job must not kill the daemon
        logger.debug("job failure traceback:", exc_info=True)
        send_line({"log": {"level": "ERROR", "message": f"job failed: {error}"}})
        return -1
    finally:
        logger.removeHandler(handler)


def _report_warmup(device, started: float) -> None:
    """Readiness lines on stderr: the kernels-ready line once the warmup
    has joined, then the reference's readiness line (bench.py waits for
    it; the port has no plan replay, hence fused=0)."""
    from . import pipeline

    if device is None:
        print(
            "floxer-tpu server: no Hopper GPU, jobs run on the host engines",
            file=sys.stderr,
        )
    else:
        try:
            pipeline.join_device_warmup()
            print(
                f"floxer-tpu server: kernels ready on {device} in "
                f"{time.monotonic() - started:.2f}s",
                file=sys.stderr,
            )
        except RuntimeError as error:
            print(
                f"floxer-tpu server: KERNEL BUILD FAILED, every device job "
                f"will fail: {error}",
                file=sys.stderr,
            )
    print("floxer-tpu server: warm replay done fused=0", file=sys.stderr)
    sys.stderr.flush()


def serve(socket_path: str) -> int:
    """Run the alignment daemon on a Unix socket until a shutdown request;
    returns 0."""
    import torch

    from . import pipeline
    from .backend import accelerator_available

    # the process hosts many jobs: the resident reference bank is cached
    # across them, and the kernel warmup starts now, not at the first job
    pipeline._PERSISTENT_PROCESS = True
    started = time.monotonic()
    device = None
    if accelerator_available():
        device = torch.device("cuda", 0)
        pipeline.start_device_warmup(device)

    job_lock = threading.Lock()

    class Handler(socketserver.StreamRequestHandler):
        def handle(self) -> None:
            line = self.rfile.readline()
            if not line:
                return
            try:
                request = json.loads(line)
            except json.JSONDecodeError as error:
                self._send({"exit": -1, "error": f"bad request: {error}"})
                return
            if request.get("op") == "ping":
                self._send({"exit": 0})
                return
            if request.get("op") == "shutdown":
                self._send({"exit": 0})
                threading.Thread(
                    target=self.server.shutdown, daemon=True
                ).start()
                return
            with job_lock:
                code = _execute_job(request, self._send)
            self._send({"exit": code})

        def _send(self, obj) -> None:
            # a disconnected client must not kill or fail the job: the run
            # completes and writes its output file regardless
            try:
                self.wfile.write((json.dumps(obj) + "\n").encode())
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, ValueError):
                pass

    if os.path.exists(socket_path):
        os.remove(socket_path)

    class Server(socketserver.ThreadingUnixStreamServer):
        daemon_threads = True
        allow_reuse_address = True

    try:
        with Server(socket_path, Handler) as server:
            print(
                f"floxer-tpu server: listening on {socket_path}",
                file=sys.stderr,
            )
            sys.stderr.flush()
            threading.Thread(
                target=_report_warmup, args=(device, started),
                name="warmup-report", daemon=True,
            ).start()
            try:
                server.serve_forever()
            except KeyboardInterrupt:
                pass
    finally:
        if os.path.exists(socket_path):
            os.remove(socket_path)
        pipeline._PERSISTENT_PROCESS = False
        pipeline._RESIDENT_BANK_CACHE.clear()
    return 0


def _request(socket_path: str, request: dict) -> int:
    """Send one request; mirror the job's logs to stderr; return the exit
    code the daemon reports (-1 if the connection ends without one)."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as conn:
        conn.connect(socket_path)
        conn.sendall((json.dumps(request) + "\n").encode())
        reader = conn.makefile("r")
        for line in reader:
            event = json.loads(line)
            if "exit" in event:
                if event.get("error"):
                    print(event["error"], file=sys.stderr)
                return int(event["exit"])
            log = event.get("log")
            if log:
                print(
                    f"[server] [{log['level']}] {log['message']}",
                    file=sys.stderr,
                )
    return -1


def run_via_server(socket_path: str, argv: list[str]) -> int:
    """Run one CLI invocation inside a running daemon; return its exit
    code."""
    return _request(socket_path, {"argv": argv, "cwd": os.getcwd()})


def shutdown_server(socket_path: str) -> int:
    """Ask a running daemon to exit."""
    return _request(socket_path, {"op": "shutdown"})
