"""``mia-serve`` — resident device scoring server.

Holds the initialized device backend and the compiled scoring programs so
short assembly runs skip the per-process backend init + executable load
(see :mod:`mia.serve`).  Point runs at it with MIA_SERVER (or just run it at
the default socket, which clients probe automatically).

    python -m mia.cli.serve [--sock PATH] [--idle-timeout SECONDS]
"""
from __future__ import annotations

import sys


def main(argv=None) -> int:
    import argparse

    from ..config import check_switches
    from ..serve import Server, sock_path
    from ..utils.jaxcfg import setup_jax_cache

    p = argparse.ArgumentParser(prog="mia-serve")
    p.add_argument("--sock", default=None, help=f"unix socket (default {sock_path()})")
    p.add_argument(
        "--idle-timeout",
        type=float,
        default=0.0,
        help="exit after this many idle seconds (0 = run forever)",
    )
    args = p.parse_args(argv)

    check_switches()
    setup_jax_cache()
    Server(args.sock, idle_timeout=args.idle_timeout).serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
