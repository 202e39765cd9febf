"""Network helpers shared by every component that advertises an address
(twin of ``torchft_tpu/utils/net.py``; the same environment override)."""

from __future__ import annotations

import os
import socket

__all__ = ["advertised_host"]

HOST_ENV = "TORCHFT_TPU_HOST"


def advertised_host() -> str:
    """Host string peers should dial to reach servers on this machine.

    Priority: TORCHFT_TPU_HOST env override, then the machine hostname if it
    resolves locally, else loopback. Every cross-host address the framework
    publishes (manager, checkpoint server, comm rendezvous, parameter
    server) goes through here so the policy lives in one place.
    """
    override = os.environ.get(HOST_ENV)
    if override:
        return override
    host = socket.gethostname()
    try:
        socket.getaddrinfo(host, None)
        return host
    except OSError:
        return "127.0.0.1"
