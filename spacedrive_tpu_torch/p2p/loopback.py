"""In-process duplex P2P transport — two REAL nodes, one process.

The two-node test/bench harness: builds real ``Node``s sharing one
library and links their ``P2PManager``s over an in-process duplex
that drives the real wire protocol (``Header`` SYNC / SYNC_REQUEST /
TELEMETRY / WORK, msgpack frames) without the encrypted socket layer,
so it runs in dep-less CI containers where ``cryptography`` is absent.

Counterpart of `spacedrive_tpu/p2p/loopback.py`: the same duplex and
the same pair, of port Nodes on the CPU (JAX's use `use_device=False`).

Note: both nodes live in one process and therefore share the global
metrics registry and flight-recorder rings — per-peer series stay
distinguishable because every label is the instance's ``peer_label``
short-hash.
"""

from __future__ import annotations

import asyncio
import logging
import os
import shutil
from typing import Any

logger = logging.getLogger(__name__)


class Pipe:
    """One direction of a duplex stream: an awaitable byte buffer."""

    def __init__(self):
        self._buf = bytearray()
        self._event = asyncio.Event()

    async def write(self, data: bytes) -> None:
        self._buf += data
        self._event.set()

    async def read_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            self._event.clear()
            await self._event.wait()
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out


class DuplexEnd:
    """One side of the duplex: reads one pipe, writes the other, and
    carries the remote's identity the way a real stream would."""

    def __init__(self, rd: Pipe, wr: Pipe, remote_identity: Any):
        self._rd, self._wr = rd, wr
        self.remote_identity = remote_identity

    async def write(self, data: bytes) -> None:
        await self._wr.write(data)

    async def read_exact(self, n: int) -> bytes:
        return await self._rd.read_exact(n)

    async def close(self) -> None:
        pass


def fake_transport(src_mgr: Any, dst_mgr: Any, server_tasks: set):
    """A ``new_stream`` replacement: in-process duplex whose server end
    is dispatched through the destination manager's REAL stream handler
    (the full Header protocol, minus socket encryption)."""

    async def new_stream(identity, timeout: float = 10.0):
        assert identity == dst_mgr.p2p.remote_identity
        c2s, s2c = Pipe(), Pipe()
        client = DuplexEnd(s2c, c2s, dst_mgr.p2p.remote_identity)
        server = DuplexEnd(c2s, s2c, src_mgr.p2p.remote_identity)
        task = asyncio.ensure_future(dst_mgr._handle_stream(server))
        server_tasks.add(task)

        def _reap(t: asyncio.Task) -> None:
            server_tasks.discard(t)
            if not t.cancelled() and t.exception() is not None:
                # a responder racing node shutdown (library DB already
                # closed) is harness teardown, not a test failure —
                # keep it off the unraisable-exception channel
                logger.debug("loopback server task died: %r", t.exception())

        task.add_done_callback(_reap)
        return client

    return new_stream


async def make_mesh_pair(base_dir: str | os.PathLike,
                         names: tuple[str, str] = ("alpha", "beta")):
    """Two Nodes sharing one library, P2PManagers linked in-process.

    Returns ``(node_a, node_b, lib_a, lib_b, server_tasks)`` — the
    library is created on ``node_a`` and shared to ``node_b`` by file
    move (the pairing outcome), with each instance row carrying the
    owning node's ``RemoteIdentity`` bytes so the TELEMETRY/WORK
    library-membership gates admit both sides.
    """
    from ..node.node import Node
    from .manager import P2PManager

    nodes = []
    for name in names:
        n = Node(os.path.join(os.fspath(base_dir), name), device="cpu",
                 with_labeler=False)
        n.config.config.p2p.enabled = False
        n.config.config.name = name
        await n.start()
        nodes.append(n)
    a, b = nodes

    lib_a = await a.create_library("shared")
    # share the library id with the second node (pairing, by file move)
    b.libraries.libraries.clear()
    lib_b_local = b.libraries.create("shared")
    old = lib_b_local.id
    for suffix in (".sdlibrary", ".db"):
        shutil.move(
            os.path.join(b.libraries.dir, f"{old}{suffix}"),
            os.path.join(b.libraries.dir, f"{lib_a.id}{suffix}"),
        )
    for s in ("-wal", "-shm"):
        p = os.path.join(b.libraries.dir, f"{old}.db{s}")
        if os.path.exists(p):
            shutil.move(p, os.path.join(b.libraries.dir, f"{lib_a.id}.db{s}"))
    lib_b_local.close()
    b.libraries.libraries.clear()
    lib_b = b.libraries.load(lib_a.id)
    await b._init_library(lib_b)
    for src, dst, src_node in ((lib_a, lib_b, a), (lib_b, lib_a, b)):
        inst = src.db.find_one("instance", pub_id=src.instance_uuid.bytes)
        dst.db.insert(
            "instance",
            pub_id=inst["pub_id"],
            # what the pairing flow stores: the owning node's
            # RemoteIdentity bytes — the TELEMETRY/WORK responders'
            # library-membership gates key off this
            identity=src_node.config.config.identity
            .to_remote_identity().to_bytes(),
            node_id=inst["node_id"], node_name=inst["node_name"],
            node_platform=inst["node_platform"], last_seen=inst["last_seen"],
            date_created=inst["date_created"],
        )

    a.p2p = P2PManager(a)
    b.p2p = P2PManager(b)
    server_tasks: set = set()
    a.p2p.p2p.new_stream = fake_transport(a.p2p, b.p2p, server_tasks)
    b.p2p.p2p.new_stream = fake_transport(b.p2p, a.p2p, server_tasks)
    a.p2p.register_library(lib_a)
    b.p2p.register_library(lib_b)
    # mutual "discovery" with library/instance metadata (what mdns
    # beacons would have advertised)
    for me, other, other_lib in ((a, b, lib_b), (b, a, lib_a)):
        me.p2p.p2p.discovered(
            "test",
            other.p2p.p2p.remote_identity,
            {("127.0.0.1", 1)},
            {
                "name": other.config.config.name,
                "libraries": str(other_lib.id),
                "instances": str(other_lib.sync.instance),
            },
        )
    return a, b, lib_a, lib_b, server_tasks
