"""Lighthouse-free parameter-server sessions.

Twin of ``torchft_tpu/parameter_server.py``: an HTTP endpoint mints a
session (a uuid and a store prefix); the server side then configures a fresh
2-rank comm context (rank 0) and runs a user-defined handler against it,
while the client configures rank 1 of the same session. Built on the port's
``StoreServer`` and ``TcpCommContext``, whose frames are byte-compatible
with the reference's, so a client of either package joins a server of the
other.

Usage:

    class MyPS(ParameterServer):
        def handle_session(self, session_id, comm):
            weights = comm.broadcast([w], root=0).future().result()
            ...

    ps = MyPS()
    # client process:
    comm = ParameterServerClient(ps.address()).new_session()
    comm.broadcast([...], root=0)
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.request
import uuid
from abc import ABC, abstractmethod
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from torchft_tpu_torch.comm.context import CommContext
from torchft_tpu_torch.comm.store import StoreServer
from torchft_tpu_torch.comm.transport import TcpCommContext
from torchft_tpu_torch.utils.net import advertised_host

logger = logging.getLogger(__name__)

__all__ = ["ParameterServer", "ParameterServerClient"]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, format, *args):  # noqa: A002
        logger.debug("ps http: " + format, *args)

    def do_GET(self) -> None:  # noqa: N802
        ps: "ParameterServer" = self.server.ps  # type: ignore[attr-defined]
        if self.path != "/new_session":
            self.send_error(404)
            return
        session_id = str(uuid.uuid4())
        store_addr = f"{ps._store.addr}/ps/{session_id}"
        body = json.dumps({"session_id": session_id,
                           "store_addr": store_addr,
                           "world_size": 2}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        # the response is complete: this handler thread now serves the
        # session as rank 0
        try:
            comm = ps._make_comm()
            comm.configure(store_addr, 0, 2)
            try:
                ps.handle_session(session_id, comm)
            finally:
                comm.shutdown()
        except Exception:
            logger.exception("parameter server session %s failed", session_id)
        self.close_connection = True


class ParameterServer(ABC):
    """Serve a fresh comm context per session to clients."""

    def __init__(self, port: int = 0, timeout: float = 60.0) -> None:
        self._timeout = timeout
        # bind all interfaces and advertise a routable host, so a client on
        # another host can reach the session's store
        self._store = StoreServer(host="0.0.0.0",
                                  advertise_host=advertised_host())
        self._server = ThreadingHTTPServer(("0.0.0.0", port), _Handler)
        self._server.daemon_threads = True
        self._server.ps = self  # type: ignore[attr-defined]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True,
            name="torchft_tpu_torch_ps",
        )
        self._thread.start()

    def _make_comm(self) -> CommContext:
        return TcpCommContext(timeout=self._timeout)

    def address(self) -> str:
        return f"http://{advertised_host()}:{self._server.server_address[1]}"

    @abstractmethod
    def handle_session(self, session_id: str, comm: CommContext) -> None:
        """Run the server side of one session (rank 0 of world 2)."""

    def shutdown(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._store.shutdown()


class ParameterServerClient:
    """Client: mint a session and get its rank-1 comm context."""

    def __init__(self, addr: str, timeout: float = 60.0) -> None:
        self._addr = addr
        self._timeout = timeout

    def new_session(self) -> CommContext:
        with urllib.request.urlopen(f"{self._addr}/new_session",
                                    timeout=self._timeout) as resp:
            info = json.loads(resp.read())
        comm = TcpCommContext(timeout=self._timeout)
        comm.configure(info["store_addr"], 1, info["world_size"])
        return comm
