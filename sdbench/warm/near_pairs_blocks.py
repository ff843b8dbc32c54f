"""The card's shapes of a duplicates pass, without the pass: one block
of the program's pair search over the library's hashes, at the call's
threshold, on the node's device (the kernels, cuBLAS's handle and the
allocator's blocks of a pass). The host's queries need no warming: the
library's file is in the page cache from its install."""

from __future__ import annotations

import asyncio


def _blocks(data, threshold: int, device) -> None:
    from spacedrive_tpu_torch.ops import phash_torch

    blocks = phash_torch.near_pairs(list(data.phash_bytes()), threshold, device)
    next(blocks, None)
    blocks.close()


async def run(node, library_id: str, data, arg: dict) -> None:
    await asyncio.to_thread(_blocks, data, int(arg["threshold"]), node.device)
