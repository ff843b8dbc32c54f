"""Encrypted authenticated stream transport (Noise XX).

Parity: ref:crates/p2p2/src/quic/transport.rs + stream.rs — the
reference runs a patched libp2p whose secure channel is libp2p-noise
(`Noise_XX_25519_ChaChaPoly_SHA256` + a signed identity payload) under
protocol `/sdp2p/1`, and hands out `UnicastStream`s.  Here each unicast
stream is one asyncio TCP connection secured by the same construction:

  → clear:  protocol magic `/sdp2p/1` (also the Noise prologue)
  → msg1:   XX `e`
  ← msg2:   XX `e, ee, s, es`   payload: ident_pub ‖ sig(ctx ‖ s_pub)
  → msg3:   XX `s, se`          payload: ident_pub ‖ sig(ctx ‖ s_pub)

The Noise state machine lives in `noise.py` (written against the public
spec, rev 34); each side's ed25519 identity is bound to its session
X25519 static by the libp2p-noise signed payload.  Transport-phase
records are Noise transport messages (≤64 KiB) framed with a 2-byte BE
length, keys from Split(), counter nonces per spec §5.1.  Security
argument and threat model: docs/security.md.

Counterpart of `spacedrive_tpu/p2p/transport.py`: a port peer and a
JAX peer handshake and exchange records with each other.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Awaitable, Callable

try:
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
    )
except ImportError:  # gated: noise.require_crypto() refuses at handshake
    X25519PrivateKey = None  # type: ignore

from . import noise
from .identity import Identity, RemoteIdentity
from .noise import CipherState, HandshakeState, NoiseError

PROTOCOL = b"/sdp2p/1"  # ref:quic/transport.rs:33
MAX_RECORD = noise.MAX_PLAINTEXT  # plaintext bytes per encrypted record


class HandshakeError(Exception):
    pass


async def _send_msg(writer: asyncio.StreamWriter, msg: bytes) -> None:
    writer.write(struct.pack(">H", len(msg)) + msg)
    await writer.drain()


async def _recv_msg(reader: asyncio.StreamReader) -> bytes:
    (length,) = struct.unpack(">H", await reader.readexactly(2))
    return await reader.readexactly(length)


class EncryptedStream:
    """One bidirectional encrypted stream (ref:stream.rs `UnicastStream`)
    in the Noise transport phase."""

    def __init__(
        self,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        send: CipherState,
        recv: CipherState,
        remote_identity: RemoteIdentity,
    ):
        self._reader = reader
        self._writer = writer
        self._send = send
        self._recv = recv
        self._recv_buf = bytearray()
        self.remote_identity = remote_identity
        self._closed = False

    # --- raw byte API (wire.Reader/Writer plug in here) ---

    async def write(self, data: bytes) -> None:
        view = memoryview(data)
        for off in range(0, max(len(view), 1), MAX_RECORD):
            chunk = bytes(view[off : off + MAX_RECORD])
            ct = self._send.encrypt_with_ad(b"", chunk)
            self._writer.write(struct.pack(">H", len(ct)) + ct)
        await self._writer.drain()

    async def read_exact(self, n: int) -> bytes:
        while len(self._recv_buf) < n:
            ct = await _recv_msg(self._reader)
            try:
                self._recv_buf += self._recv.decrypt_with_ad(b"", ct)
            except NoiseError as exc:
                raise ValueError("record decrypt failed") from exc
        out = bytes(self._recv_buf[:n])
        del self._recv_buf[:n]
        return out

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._writer.close()
            await self._writer.wait_closed()
        except Exception:
            pass

    @property
    def peer_addr(self) -> tuple[str, int] | None:
        try:
            return self._writer.get_extra_info("peername")[:2]
        except Exception:
            return None


def _split_for_role(hs: HandshakeState) -> tuple[CipherState, CipherState]:
    """(send, recv) cipher states for this side's role."""
    c_i2r, c_r2i = hs.split()
    return (c_i2r, c_r2i) if hs.initiator else (c_r2i, c_i2r)


async def _client_handshake(
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    identity: Identity,
    expect: RemoteIdentity | None,
) -> EncryptedStream:
    noise.require_crypto()
    static = X25519PrivateKey.generate()
    hs = HandshakeState(initiator=True, s=static, prologue=PROTOCOL)
    try:
        writer.write(PROTOCOL)
        await _send_msg(writer, hs.write_message(b""))

        payload = hs.read_message(await _recv_msg(reader))
        srv_ident = noise.verify_identity_payload(payload, hs.rs)
        if expect is not None and srv_ident != expect:
            raise HandshakeError(f"unexpected peer identity {srv_ident}")

        my_payload = noise.identity_payload(identity, hs.local_static_pub)
        await _send_msg(writer, hs.write_message(my_payload))
    except NoiseError as exc:
        raise HandshakeError(str(exc)) from exc

    send, recv = _split_for_role(hs)
    return EncryptedStream(reader, writer, send, recv, srv_ident)


async def _server_handshake(
    reader: asyncio.StreamReader,
    writer: asyncio.StreamWriter,
    identity: Identity,
) -> EncryptedStream:
    magic = await reader.readexactly(len(PROTOCOL))
    if magic != PROTOCOL:
        raise HandshakeError("bad protocol magic")
    noise.require_crypto()
    static = X25519PrivateKey.generate()
    hs = HandshakeState(initiator=False, s=static, prologue=PROTOCOL)
    try:
        hs.read_message(await _recv_msg(reader))

        my_payload = noise.identity_payload(identity, hs.local_static_pub)
        await _send_msg(writer, hs.write_message(my_payload))

        payload = hs.read_message(await _recv_msg(reader))
        cli_ident = noise.verify_identity_payload(payload, hs.rs)
    except NoiseError as exc:
        raise HandshakeError(str(exc)) from exc

    send, recv = _split_for_role(hs)
    return EncryptedStream(reader, writer, send, recv, cli_ident)


class Listener:
    """Bound accept socket handing each authenticated stream to
    `on_stream` (ref:transport.rs incoming-stream task)."""

    def __init__(self, server: asyncio.base_events.Server, port: int):
        self._server = server
        self.port = port

    async def close(self) -> None:
        self._server.close()
        await self._server.wait_closed()


async def listen(
    identity: Identity,
    on_stream: Callable[[EncryptedStream], Awaitable[None]],
    host: str = "0.0.0.0",
    port: int = 0,
) -> Listener:
    async def handle(reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            stream = await _server_handshake(reader, writer, identity)
        except (HandshakeError, asyncio.IncompleteReadError, OSError):
            writer.close()
            return
        try:
            await on_stream(stream)
        finally:
            await stream.close()

    server = await asyncio.start_server(handle, host, port)
    bound = server.sockets[0].getsockname()[1]
    return Listener(server, bound)


async def connect(
    addr: tuple[str, int],
    identity: Identity,
    expect: RemoteIdentity | None = None,
    timeout: float = 10.0,
) -> EncryptedStream:
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(addr[0], addr[1]), timeout
    )
    try:
        return await asyncio.wait_for(
            _client_handshake(reader, writer, identity, expect), timeout
        )
    except BaseException:
        writer.close()
        raise
