"""Dependency-free WebSocket (RFC 6455) — server upgrade + frame codec
(a copy of `mlx_audio_tpu/ws.py`: the port imports nothing of the JAX
package).

The reference's realtime STT endpoint requires FastAPI/uvicorn; this module
lets the stdlib server speak WebSocket so realtime transcription works in
hermetic environments (and is testable without external packages). Covers
what an audio-streaming endpoint needs: handshake, masked client frames,
text/binary messages, fragmentation, ping/pong, close.
"""

from __future__ import annotations

import base64
import hashlib
import os
import struct
from typing import Optional, Tuple

__all__ = ["accept_key", "WebSocketConnection", "client_handshake_headers"]

_MAGIC = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0x0, 0x1, 0x2, 0x8, 0x9, 0xA


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _MAGIC).encode()).digest()
    return base64.b64encode(digest).decode()


def client_handshake_headers(host: str, path: str) -> Tuple[bytes, str]:
    """(request bytes, expected Sec-WebSocket-Accept) for a test client."""
    key = base64.b64encode(os.urandom(16)).decode()
    req = (
        f"GET {path} HTTP/1.1\r\n"
        f"Host: {host}\r\n"
        "Upgrade: websocket\r\n"
        "Connection: Upgrade\r\n"
        f"Sec-WebSocket-Key: {key}\r\n"
        "Sec-WebSocket-Version: 13\r\n\r\n"
    ).encode()
    return req, accept_key(key)


class WebSocketConnection:
    """Frame codec over buffered file objects (server or client role).

    Servers send unmasked frames and require masked client frames; clients
    mask their frames (`mask_outgoing=True`).
    """

    def __init__(self, rfile, wfile, mask_outgoing: bool = False,
                 auto_close_reply: bool = True):
        self.rfile = rfile
        self.wfile = wfile
        self.mask_outgoing = mask_outgoing
        self.auto_close_reply = auto_close_reply
        self.closed = False

    # ---- receive ----

    def _read_exact(self, n: int) -> Optional[bytes]:
        data = b""
        while len(data) < n:
            chunk = self.rfile.read(n - len(data))
            if not chunk:
                return None
            data += chunk
        return data

    def _read_frame(self):
        head = self._read_exact(2)
        if head is None:
            return None
        b1, b2 = head
        fin = bool(b1 & 0x80)
        opcode = b1 & 0x0F
        masked = bool(b2 & 0x80)
        length = b2 & 0x7F
        if length == 126:
            ext = self._read_exact(2)
            if ext is None:
                return None
            (length,) = struct.unpack(">H", ext)
        elif length == 127:
            ext = self._read_exact(8)
            if ext is None:
                return None
            (length,) = struct.unpack(">Q", ext)
        mask = self._read_exact(4) if masked else None
        payload = self._read_exact(length) if length else b""
        if payload is None:
            return None
        if mask:
            payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
        return fin, opcode, payload

    def recv(self) -> Optional[Tuple[int, bytes]]:
        """Next complete message → (opcode, payload); None on EOF/close.
        Transparently answers pings and reassembles fragmented messages."""
        message = b""
        msg_opcode = None
        while True:
            frame = self._read_frame()
            if frame is None:
                return None
            fin, opcode, payload = frame
            if opcode == OP_PING:
                self._send_frame(OP_PONG, payload)
                continue
            if opcode == OP_PONG:
                continue
            if opcode == OP_CLOSE:
                if not self.auto_close_reply:
                    # caller wants to flush pending data before completing
                    # the close handshake; it must call close() afterwards
                    return OP_CLOSE, payload
                if not self.closed:
                    self._send_frame(OP_CLOSE, payload[:2])
                    self.closed = True
                return None
            if opcode in (OP_TEXT, OP_BINARY):
                msg_opcode = opcode
                message = payload
            elif opcode == OP_CONT:
                message += payload
            if fin and msg_opcode is not None:
                return msg_opcode, message

    # ---- send ----

    def _send_frame(self, opcode: int, payload: bytes) -> None:
        b1 = 0x80 | opcode
        mask_bit = 0x80 if self.mask_outgoing else 0
        n = len(payload)
        if n < 126:
            head = struct.pack(">BB", b1, mask_bit | n)
        elif n < (1 << 16):
            head = struct.pack(">BBH", b1, mask_bit | 126, n)
        else:
            head = struct.pack(">BBQ", b1, mask_bit | 127, n)
        if self.mask_outgoing:
            mask = os.urandom(4)
            payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
            head += mask
        self.wfile.write(head + payload)
        self.wfile.flush()

    def send_text(self, text: str) -> None:
        self._send_frame(OP_TEXT, text.encode())

    def send_binary(self, data: bytes) -> None:
        self._send_frame(OP_BINARY, data)

    def close(self, code: int = 1000) -> None:
        if not self.closed:
            try:
                self._send_frame(OP_CLOSE, struct.pack(">H", code))
            except Exception:
                pass
            self.closed = True
