"""CLI entry point: python -m floxer_tpu_torch ... (the floxer_tpu CLI,
verifying on an NVIDIA Hopper GPU).

The arguments are floxer_tpu's (this package's copy of its cli.py); the
options this port does not cover yet are rejected with a non-zero exit (see ROADMAP.md).

Server mode (server.py), as in floxer_tpu:
  python -m floxer_tpu_torch --serve SOCKET             run the daemon
  python -m floxer_tpu_torch --server SOCKET <args...>  run one job in it
  python -m floxer_tpu_torch --shutdown-server SOCKET   stop the daemon
"""

import sys


def _take_flag(argv: list[str], flag: str):
    """Remove `flag VALUE` from argv, returning VALUE or None."""
    if flag not in argv:
        return None
    at = argv.index(flag)
    if at + 1 >= len(argv):
        print(f"{flag} requires a socket path", file=sys.stderr)
        raise SystemExit(255)
    value = argv[at + 1]
    del argv[at : at + 2]
    return value


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)

    serve_path = _take_flag(argv, "--serve")
    if serve_path is not None:
        from .server import serve

        return serve(serve_path)
    shutdown_path = _take_flag(argv, "--shutdown-server")
    if shutdown_path is not None:
        from .server import shutdown_server

        return shutdown_server(shutdown_path)
    server_path = _take_flag(argv, "--server")
    if server_path is not None:
        from .server import run_via_server

        return run_via_server(server_path, argv)

    from .cli import parse_and_validate

    from .pipeline import run

    try:
        cli = parse_and_validate(argv)
    except ValueError as error:
        print(f"[CLI PARSER ERROR]\n{error}", file=sys.stderr)
        return -1
    return run(cli)


if __name__ == "__main__":
    code = main()
    sys.exit(code if code >= 0 else 256 + code)
