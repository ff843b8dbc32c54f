"""The port's MessagePack codec against the `msgpack` package at its
nesting bounds, and a peer's nested header frame through the port's
`Header.read` against JAX's.

`msgpack` 1.1 packs an object sitting under 511 containers and refuses
one under 512 (`ValueError`); it unpacks 1,024 nested containers and
refuses 1,025 (`StackError`, a `ValueError`). The port raises its
`MsgpackError` (a `ValueError`) at the same edges, in both directions
and for arrays and maps alike, and never `RecursionError`. On the wire
the port reads a frame as JAX's `msgpack.unpackb(raw, raw=False)` does,
map keys str or bytes only.
"""

import asyncio
import struct
import uuid

import msgpack
import pytest

import spacedrive_tpu.p2p.protocol as j_protocol
import spacedrive_tpu_torch.p2p.protocol as p_protocol
from spacedrive_tpu_torch.p2p.wire import Reader
from spacedrive_tpu_torch.utils import msgpack_codec


def _nested(depth: int, kind: str, leaf=1):
    obj = leaf
    for _ in range(depth):
        obj = [obj] if kind == "array" else {"k": obj}
    return obj


def _nested_bytes(depth: int, kind: str, leaf: bytes = b"\x01") -> bytes:
    """`depth` one-element containers around `leaf`, built by hand: past
    depth 511 `msgpack.packb` refuses to write them."""
    return (b"\x91" if kind == "array" else b"\x81\xa1k") * depth + leaf


def _outcome(fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except ValueError:
        return "ValueError", None


@pytest.mark.parametrize("kind", ["array", "map"])
def test_pack_depth_bound_matches_msgpack(kind):
    seen = {}
    for depth, leaf in ((511, 1), (512, 1), (511, []), (512, [])):
        obj = _nested(depth, kind, leaf)
        want = _outcome(msgpack.packb, obj, use_bin_type=True)
        got = _outcome(msgpack_codec.packb, obj)
        assert got == want, (depth, leaf)
        seen[(depth, repr(leaf))] = want[0]
    # the edge itself: a scalar under 511 containers packs, under 512 not
    assert seen[(511, "1")] == "ok" and seen[(512, "1")] == "ValueError"


@pytest.mark.parametrize("kind", ["array", "map"])
def test_unpack_depth_bound_matches_msgpack(kind):
    seen = {}
    for depth, leaf in ((1023, b"\x90"), (1024, b"\x01"), (1024, b"\x90"), (1025, b"\x01")):
        data = _nested_bytes(depth, kind, leaf)
        want = _outcome(msgpack.unpackb, data)
        got = _outcome(msgpack_codec.unpackb, data)
        assert got == want, (depth, leaf)
        seen[(depth, leaf)] = want[0]
    assert seen[(1024, b"\x01")] == "ok" and seen[(1025, b"\x01")] == "ValueError"


def test_unpack_far_past_the_bound_raises_msgpack_error():
    """A frame of 100,000 open arrays (100 KB, well inside a wire frame's
    64 MiB bound) is refused with MsgpackError, not RecursionError."""
    with pytest.raises(msgpack_codec.MsgpackError):
        msgpack_codec.unpackb(b"\x91" * 100_000 + b"\x01")


class _Pipe:
    def __init__(self, data: bytes):
        self._buf = bytearray(data)

    async def read_exact(self, n: int) -> bytes:
        if len(self._buf) < n:
            raise asyncio.IncompleteReadError(bytes(self._buf), n)
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out


def _frame(payload: bytes) -> bytes:
    return struct.pack(">I", len(payload)) + payload


def _read(protocol, data: bytes):
    async def run():
        h = await protocol.Header.read(_Pipe(data))
        return int(h.type), h.library_id, h.trace, h.telemetry_op

    try:
        return "ok", asyncio.run(asyncio.wait_for(run(), 30))
    except ValueError:
        return "ValueError", None


@pytest.mark.parametrize("depth", [700, 2000])
@pytest.mark.parametrize("kind", ["array", "map"])
@pytest.mark.parametrize("header", ["SYNC", "TELEMETRY"])
def test_header_read_nested_frame_matches_jax(header, kind, depth):
    """A SYNC header whose trace field nests `depth` deep, and a
    TELEMETRY header whose op field does: at 700 both packages read the
    same header, at 2,000 both raise ValueError."""
    nested = _frame(_nested_bytes(depth, kind))
    if header == "SYNC":
        data = bytes([2]) + uuid.UUID(int=7).bytes + nested
    else:
        data = bytes([8]) + _frame(msgpack.packb({"trace_id": "ab" * 16})) + nested
    want = _read(j_protocol, data)
    assert want[0] == ("ok" if depth == 700 else "ValueError")
    assert _read(p_protocol, data) == want


def test_wire_map_keys_are_strict_as_jax():
    """A wire frame whose map has an int key is refused on the wire, as
    JAX's `msgpack.unpackb(raw=False)` refuses it; the codec's own
    default (which the op log's decoder relies on, as JAX's passes
    strict_map_key=False there) still reads it."""
    body = msgpack.packb({1: "a"})

    async def read():
        return await Reader(_Pipe(_frame(body))).msgpack()

    with pytest.raises(ValueError):
        msgpack.unpackb(body, raw=False)
    with pytest.raises(msgpack_codec.MsgpackError):
        asyncio.run(read())
    assert msgpack_codec.unpackb(body) == {1: "a"}
