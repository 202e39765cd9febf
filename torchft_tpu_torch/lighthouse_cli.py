"""Standalone lighthouse server CLI (twin of torchft_tpu/lighthouse_cli.py).
Run as:

    python -m torchft_tpu_torch.lighthouse_cli --min_replicas 2 --bind 0.0.0.0:29510

Serves the quorum RPCs and the HTML dashboard on one port.
Defaults: join timeout 60 s (not the 100 ms embedded/test default), tick
100 ms, heartbeat 5 s. With ``--upstream`` (and ``--domain``) it is a
tier-1 aggregator for one domain of a two-level fleet tree, reporting its
membership to the root lighthouse every ``--upstream_report_interval_ms``.
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
    parser.add_argument(
        "--no-cache-quorum", action="store_true",
        help="disable epoch-cached quorum decisions (recompute the full "
             "decision on every evaluation)",
    )
    parser.add_argument(
        "--prune_after_ms", type=int, default=0,
        help="prune heartbeat/participant entries dead longer than this "
             "(0: 12x heartbeat_timeout_ms)",
    )
    parser.add_argument(
        "--domain", default="",
        help="domain (rack) name; with --upstream this lighthouse is the "
             "domain's tier-1 aggregator",
    )
    parser.add_argument(
        "--upstream", default="",
        help="root lighthouse address to report this domain's membership "
             "summary to (two-level tree)",
    )
    parser.add_argument(
        "--upstream_report_interval_ms", type=int, default=500,
        help="report cadence to the root",
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
        cache_quorum=not args.no_cache_quorum,
        prune_after_ms=args.prune_after_ms or None,
        domain=args.domain or None,
        upstream_addr=args.upstream or None,
        upstream_report_interval_ms=args.upstream_report_interval_ms,
    )
    # NOTE: tooling parses this exact line (address = last token).
    print(f"lighthouse serving at {lighthouse.address()}", flush=True)
    if args.upstream:
        print(f"tier-1 aggregator for domain {args.domain!r}, reporting to "
              f"{args.upstream}", flush=True)

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
