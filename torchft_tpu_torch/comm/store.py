"""TCP key-value store for rendezvous.

Twin of ``torchft_tpu/comm/store.py``, on the same wire, so a client of
either package works against a server of the other. It serves (a)
manager-address discovery by non-zero local ranks and (b) per-quorum
transport rendezvous under a ``{store}/torchft/{quorum_id}/...`` prefix.

Protocol: length-framed binary over one TCP connection per client.
    request  = op:u8  klen:u32  key  vlen:u64  value  timeout_ms:u32
    response = status:u8  vlen:u64  value
Ops: SET, GET, WAIT (block until key exists), ADD (atomic int add, returns
new value), DELETE, LIST (prefix scan, newline-joined keys).

The server is a daemon thread-per-connection loop guarded by one condition
variable — rendezvous traffic is tiny and rare (once per quorum change), so
simplicity beats throughput here. The wire format is Python-free so the C++
control plane can host the same store natively.
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from datetime import timedelta
from typing import Dict, List, Optional, Tuple

__all__ = ["StoreServer", "StoreClient", "PrefixStore", "create_store_client"]

_OP_SET = 1
_OP_GET = 2
_OP_WAIT = 3
_OP_ADD = 4
_OP_DELETE = 5
_OP_LIST = 6

_ST_OK = 0
_ST_MISSING = 1
_ST_TIMEOUT = 2
_ST_ERROR = 3


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("store connection closed")
        buf.extend(chunk)
    return bytes(buf)


class StoreServer:
    """In-process KV store server. Bind with port=0 for an ephemeral port."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 advertise_host: Optional[str] = None) -> None:
        """``host`` is the bind address; ``advertise_host`` is what
        ``addr`` reports to peers (pass "0.0.0.0" + an advertised host for
        cross-host rendezvous)."""
        self._data: Dict[str, bytes] = {}
        self._cond = threading.Condition()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(512)
        self._advertise_host = advertise_host
        self._shutdown = False
        self._thread = threading.Thread(
            target=self._accept_loop, name="torchft_tpu_store", daemon=True
        )
        self._thread.start()

    @property
    def addr(self) -> str:
        host, port = self._sock.getsockname()[:2]
        if self._advertise_host:
            host = self._advertise_host
        return f"{host}:{port}"

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def shutdown(self) -> None:
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass

    # -- server internals ---------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._shutdown:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(
                target=self._serve_conn, args=(conn,), daemon=True
            ).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        try:
            while True:
                hdr = _recv_exact(conn, 5)
                op, klen = struct.unpack("<BI", hdr)
                key = _recv_exact(conn, klen).decode()
                (vlen,) = struct.unpack("<Q", _recv_exact(conn, 8))
                value = _recv_exact(conn, vlen) if vlen else b""
                (timeout_ms,) = struct.unpack("<I", _recv_exact(conn, 4))
                status, out = self._handle(op, key, value, timeout_ms)
                conn.sendall(struct.pack("<BQ", status, len(out)) + out)
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle(
        self, op: int, key: str, value: bytes, timeout_ms: int
    ) -> Tuple[int, bytes]:
        with self._cond:
            if op == _OP_SET:
                self._data[key] = value
                self._cond.notify_all()
                return _ST_OK, b""
            if op == _OP_GET:
                if key in self._data:
                    return _ST_OK, self._data[key]
                return _ST_MISSING, b""
            if op == _OP_WAIT:
                deadline = time.monotonic() + timeout_ms / 1000.0
                while key not in self._data:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or self._shutdown:
                        return _ST_TIMEOUT, b""
                    self._cond.wait(timeout=remaining)
                return _ST_OK, self._data[key]
            if op == _OP_ADD:
                delta = int(value.decode() or "0")
                cur = int(self._data.get(key, b"0").decode() or "0")
                cur += delta
                self._data[key] = str(cur).encode()
                self._cond.notify_all()
                return _ST_OK, str(cur).encode()
            if op == _OP_DELETE:
                existed = self._data.pop(key, None) is not None
                return (_ST_OK if existed else _ST_MISSING), b""
            if op == _OP_LIST:
                keys = sorted(k for k in self._data if k.startswith(key))
                return _ST_OK, "\n".join(keys).encode()
        return _ST_ERROR, b"unknown op"


class StoreClient:
    """Blocking client. One socket, serialized by a lock (rendezvous traffic
    is infrequent; contention is not a concern)."""

    def __init__(
        self, addr: str, connect_timeout: "float | timedelta" = 60.0
    ) -> None:
        if isinstance(connect_timeout, timedelta):
            connect_timeout = connect_timeout.total_seconds()
        host, port_s = addr.rsplit(":", 1)
        self._addr = addr
        self._lock = threading.Lock()
        deadline = time.monotonic() + connect_timeout
        last_err: Optional[Exception] = None
        while True:
            try:
                self._sock = socket.create_connection(
                    (host, int(port_s)), timeout=connect_timeout
                )
                break
            except OSError as e:  # retry until the server side comes up
                last_err = e
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"could not connect to store {addr}: {last_err}"
                    ) from last_err
                time.sleep(0.01)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    @property
    def addr(self) -> str:
        return self._addr

    def _request(
        self, op: int, key: str, value: bytes = b"", timeout_ms: int = 0
    ) -> Tuple[int, bytes]:
        kb = key.encode()
        msg = (
            struct.pack("<BI", op, len(kb))
            + kb
            + struct.pack("<Q", len(value))
            + value
            + struct.pack("<I", timeout_ms)
        )
        with self._lock:
            # Socket read timeout must outlast a server-side WAIT.
            self._sock.settimeout(timeout_ms / 1000.0 + 60.0 if timeout_ms else 60.0)
            self._sock.sendall(msg)
            hdr = _recv_exact(self._sock, 9)
            status, vlen = struct.unpack("<BQ", hdr)
            out = _recv_exact(self._sock, vlen) if vlen else b""
        return status, out

    def set(self, key: str, value: "bytes | str") -> None:
        if isinstance(value, str):
            value = value.encode()
        status, _ = self._request(_OP_SET, key, value)
        if status != _ST_OK:
            raise RuntimeError(f"store set({key!r}) failed: status={status}")

    def get(self, key: str) -> Optional[bytes]:
        status, out = self._request(_OP_GET, key)
        return out if status == _ST_OK else None

    def wait(self, key: str, timeout: "float | timedelta" = 60.0) -> bytes:
        if isinstance(timeout, timedelta):
            timeout = timeout.total_seconds()
        status, out = self._request(_OP_WAIT, key, timeout_ms=int(timeout * 1000))
        if status == _ST_TIMEOUT:
            raise TimeoutError(f"store wait({key!r}) timed out after {timeout}s")
        if status != _ST_OK:
            raise RuntimeError(f"store wait({key!r}) failed: status={status}")
        return out

    def add(self, key: str, delta: int) -> int:
        status, out = self._request(_OP_ADD, key, str(delta).encode())
        if status != _ST_OK:
            raise RuntimeError(f"store add({key!r}) failed: status={status}")
        return int(out.decode())

    def delete(self, key: str) -> bool:
        status, _ = self._request(_OP_DELETE, key)
        return status == _ST_OK

    def list_keys(self, prefix: str = "") -> List[str]:
        status, out = self._request(_OP_LIST, prefix)
        if status != _ST_OK:
            raise RuntimeError(f"store list({prefix!r}) failed: status={status}")
        return out.decode().split("\n") if out else []

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


class PrefixStore:
    """Namespaced view of a StoreClient (analog of torch PrefixStore used at
    ref process_group.py:113-120)."""

    def __init__(self, client: StoreClient, prefix: str) -> None:
        self._client = client
        self._prefix = prefix.rstrip("/")

    def _k(self, key: str) -> str:
        return f"{self._prefix}/{key}"

    def set(self, key: str, value: "bytes | str") -> None:
        self._client.set(self._k(key), value)

    def get(self, key: str) -> Optional[bytes]:
        return self._client.get(self._k(key))

    def wait(self, key: str, timeout: "float | timedelta" = 60.0) -> bytes:
        return self._client.wait(self._k(key), timeout)

    def add(self, key: str, delta: int) -> int:
        return self._client.add(self._k(key), delta)


def create_store_client(
    store_addr: str, timeout: "float | timedelta" = 60.0
) -> "StoreClient | PrefixStore":
    """Parse ``host:port[/prefix]`` into a (possibly prefixed) client —
    mirrors ref process_group.py:102-120 where the quorum id rides in the
    store path."""
    if "/" in store_addr:
        addr, prefix = store_addr.split("/", 1)
        return PrefixStore(StoreClient(addr, timeout), prefix)
    return StoreClient(store_addr, timeout)
