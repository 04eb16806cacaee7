"""A client of the program's warm server (floxer_tpu_torch/server.py).

Newline-delimited JSON over a Unix stream socket: one request line
`{"argv": [...], "cwd": "..."}` (or `{"op": "ping"}` /
`{"op": "shutdown"}`), then `{"log": {"level", "message"}}` lines and one
`{"exit": N}` line.
"""

from __future__ import annotations

import json
import os
import socket
import time
from dataclasses import dataclass, field


@dataclass
class Reply:
    exit: int
    logs: list[str] = field(default_factory=list)
    started: float = 0.0  # time.monotonic() at the request
    ended: float = 0.0  # time.monotonic() at the exit line

    @property
    def wall(self) -> float:
        return self.ended - self.started


def request(socket_path: str, body: dict, timeout: float = 900.0) -> Reply:
    """Send one request and read its reply to the exit line; a connection
    that ends without one replies exit -1."""
    started = time.monotonic()
    logs = []
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as conn:
        conn.settimeout(timeout)
        conn.connect(socket_path)
        conn.sendall((json.dumps(body) + "\n").encode())
        with conn.makefile("r") as reader:
            for line in reader:
                event = json.loads(line)
                if "exit" in event:
                    return Reply(int(event["exit"]), logs, started,
                                 time.monotonic())
                if "log" in event:
                    logs.append(event["log"].get("message", ""))
    return Reply(-1, logs, started, time.monotonic())


def run_job(socket_path: str, argv: list[str]) -> Reply:
    return request(socket_path, {"argv": argv, "cwd": os.getcwd()})


def wait_ready(socket_path: str, timeout: float = 120.0) -> None:
    """Ping until the server answers."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            if request(socket_path, {"op": "ping"}, timeout=10).exit == 0:
                return
        except (FileNotFoundError, ConnectionRefusedError):
            pass
        if time.monotonic() > deadline:
            raise TimeoutError(f"no server on {socket_path}")
        time.sleep(0.05)


def shutdown(socket_path: str) -> None:
    request(socket_path, {"op": "shutdown"}, timeout=60)
