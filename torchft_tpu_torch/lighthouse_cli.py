"""Standalone lighthouse server CLI (twin of torchft_tpu/lighthouse_cli.py
without its fleet-tree options). Run as:

    python -m torchft_tpu_torch.lighthouse_cli --min_replicas 2 --bind 0.0.0.0:29510

Serves the quorum RPCs and the HTML dashboard on one port.
Defaults: join timeout 60 s (not the 100 ms embedded/test default), tick
100 ms, heartbeat 5 s.
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="torchft_tpu_torch lighthouse")
    parser.add_argument(
        "--bind", default="0.0.0.0:29510",
        help="address to bind the server to",
    )
    parser.add_argument(
        "--min_replicas", type=int, required=True,
        help="minimum number of replicas to consider a quorum",
    )
    parser.add_argument(
        "--join_timeout_ms", type=int, default=60000,
        help="how long to wait for heartbeating stragglers before issuing "
             "a quorum",
    )
    parser.add_argument(
        "--quorum_tick_ms", type=int, default=100,
        help="how frequently to re-evaluate the quorum",
    )
    parser.add_argument(
        "--heartbeat_timeout_ms", type=int, default=5000,
        help="heartbeat age after which a replica is considered dead",
    )
    parser.add_argument(
        "--hostname", default="",
        help="advertised hostname (default: machine hostname)",
    )
    args = parser.parse_args(argv)

    import socket

    from torchft_tpu_torch.control import Lighthouse

    lighthouse = Lighthouse(
        bind=args.bind,
        min_replicas=args.min_replicas,
        join_timeout_ms=args.join_timeout_ms,
        quorum_tick_ms=args.quorum_tick_ms,
        heartbeat_timeout_ms=args.heartbeat_timeout_ms,
        hostname=args.hostname or socket.gethostname(),
    )
    # NOTE: tooling parses this exact line (address = last token).
    print(f"lighthouse serving at {lighthouse.address()}", flush=True)

    stop = threading.Event()

    def _handle(signum, frame):
        stop.set()

    signal.signal(signal.SIGINT, _handle)
    signal.signal(signal.SIGTERM, _handle)
    stop.wait()
    lighthouse.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
