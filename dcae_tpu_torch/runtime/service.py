"""TCP bitstream transport, byte for byte the JAX package's
(dcae_tpu/runtime/service.py) and the reference client / server's.

Protocol: client -> "name|size\n" header, server -> b"ACK", client -> raw
bytes. The server also takes a header without the terminator (the
reference's own client sends none), through a short drain window. Plus a
BitstreamServer that can hand every received payload to a callback (the
port's tools/server.py decodes it on arrival). No torch here: a client
needs none.
"""

from __future__ import annotations

import os
import socket
import threading
from typing import Callable, Optional


def send_bytes(name: str, data: bytes, host: str, port: int,
               timeout: float = 60.0) -> None:
    """Send one named payload using the name|size + ACK protocol."""
    sock = socket.create_connection((host, port), timeout=timeout)
    try:
        # newline terminator lets the server parse the header without a
        # drain window; the server still accepts terminator-less peers
        header = f"{name}|{len(data)}\n".encode()
        sock.sendall(header)
        ack = sock.recv(1024)
        if ack != b"ACK":
            raise ConnectionError(f"no ACK from server (got {ack!r})")
        sock.sendall(data)
    finally:
        sock.close()


def send_file(path: str, host: str, port: int) -> None:
    with open(path, "rb") as f:
        data = f.read()
    send_bytes(os.path.basename(path), data, host, port)


class BitstreamServer:
    """Accept loop: receives named payloads into out_dir as
    'received_<name>' (reference server.py behavior) and optionally calls
    on_payload(name, bytes)."""

    def __init__(self, port: int, out_dir: str = "./output/binary/bin",
                 on_payload: Optional[Callable[[str, bytes], None]] = None):
        self.port = port
        self.out_dir = out_dir
        self.on_payload = on_payload
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._running = False

    def start(self, background: bool = False) -> None:
        os.makedirs(self.out_dir, exist_ok=True)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("", self.port))
        self._sock.listen(5)
        self._running = True
        if background:
            self._thread = threading.Thread(target=self._serve, daemon=True)
            self._thread.start()
        else:
            self._serve()

    @property
    def bound_port(self) -> int:
        return self._sock.getsockname()[1]

    def _serve(self) -> None:
        while self._running:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break
            try:
                self._handle(conn)
            except Exception as e:  # keep serving on bad clients
                print(f"[server] error: {e}")
            finally:
                conn.close()

    @staticmethod
    def _read_header(conn: socket.socket) -> str:
        """Read the 'name|size' header, tolerating TCP fragmentation.
        The in-repo client newline-terminates the header, so the normal
        path parses the moment the terminator arrives — no stall. For
        terminator-less peers (the reference's own client format,
        server.py:24-30, assumes one recv returns everything) fall back
        to a short drain window that disambiguates 'name|12' from
        'name|123' split across segments."""
        buf = b""
        while len(buf) < 4096 and b"\n" not in buf:
            name_size = buf.rsplit(b"|", 1)
            parsed = len(name_size) == 2 and name_size[1].isdigit()
            # A parseable PREFIX is not a complete header: 'name|12' and
            # 'name|123' differ only in bytes still in flight, so keep a
            # generous quiet window (longer than any re-chunking proxy's
            # delivery gap) before accepting a terminator-less parse.
            conn.settimeout(0.5 if parsed else 30.0)
            try:
                data = conn.recv(4096)
            except socket.timeout:
                if parsed:
                    break
                raise
            if not data:
                break
            buf += data
        conn.settimeout(60.0)
        return buf.split(b"\n", 1)[0].decode()

    def _handle(self, conn: socket.socket) -> None:
        header = self._read_header(conn)
        if not header or "|" not in header:
            return
        name, size_s = header.rsplit("|", 1)
        size = int(size_s)
        conn.sendall(b"ACK")
        chunks = []
        received = 0
        while received < size:
            data = conn.recv(min(65536, size - received))
            if not data:
                break
            chunks.append(data)
            received += len(data)
        payload = b"".join(chunks)
        if received != size:
            print(f"[server] short read for {name}: {received}/{size}")
            return
        safe = os.path.basename(name)
        out_path = os.path.join(self.out_dir, f"received_{safe}")
        with open(out_path, "wb") as f:
            f.write(payload)
        if self.on_payload is not None:
            self.on_payload(safe, payload)

    def stop(self) -> None:
        self._running = False
        if self._sock is not None:
            try:
                self._sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._sock.close()
        if self._thread is not None:
            self._thread.join(timeout=5)
