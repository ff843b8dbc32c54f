"""FileEncryptor/FileDecryptor jobs — sd-crypto over library files.

Parity: ref:core/src/object/fs/{encrypt.rs,decrypt.rs} (reference
pre-rewrite file-crypto jobs) on top of crates/crypto: encrypt writes
`<name>.sdenc` next to the source with a keyslotted header (optional
embedded metadata = the file_path row essentials, optional preview
media = the existing thumbnail, matching the reference's header
extras); decrypt reverses by password.

Counterpart of `spacedrive_tpu/object/fs/encrypt.py`: the same steps
write the same bytes. Each step holds the location watcher on the paths
it writes (`watcher_pause`), runs the cipher off the event loop, and
then hands the watcher the finished file (and the erased original) as
its own events (`watcher_announce`): a half-written file starts no
rescan, and the finished one is indexed like a user's, its cas_id
through the node's device. The JAX job pauses the whole location, but
its manager checks the pause only after the step has resumed it, so
the watcher picks its files up there too.
"""

from __future__ import annotations

import asyncio
import os

from ...crypto.hashing import HashingAlgorithm
from ...crypto.header import decrypt_file, encrypt_file
from ...crypto.stream import Algorithm
from ...jobs import StatefulJob
from ...jobs.job import JobContext, StepResult
from ...jobs.manager import register_job
from . import get_location_path, get_many_files_datas, watcher_announce, watcher_pause

ENCRYPTED_EXT = "sdenc"


def _read_preview(path: str) -> bytes | None:
    """Blocking thumbnail read — runs via asyncio.to_thread."""
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def _overrides(init: dict) -> tuple | None:
    return tuple(init["_test_overrides"]) if init.get("_test_overrides") else None


@register_job
class FileEncryptorJob(StatefulJob):
    """init: {location_id, file_path_ids, password, algorithm?,
    with_metadata?, with_preview_media?, erase_original?}"""

    NAME = "file_encryptor"

    async def init_job(self, ctx: JobContext) -> None:
        db = ctx.library.db
        loc_path = get_location_path(db, self.init["location_id"])
        for fd in get_many_files_datas(db, loc_path, self.init["file_path_ids"]):
            if fd.row.get("is_dir"):
                continue  # ref:encrypt.rs skips directories
            self.steps.append(
                {
                    "full_path": fd.full_path,
                    "cas_id": fd.row.get("cas_id"),
                    "name": fd.row.get("name"),
                    "extension": fd.row.get("extension"),
                }
            )
        ctx.progress(task_count=len(self.steps), phase="encrypting")

    async def execute_step(self, ctx: JobContext, step: dict, step_number: int) -> StepResult:
        src = step["full_path"]
        dst = f"{src}.{ENCRYPTED_EXT}"
        erase = bool(self.init.get("erase_original"))
        metadata = None
        if self.init.get("with_metadata", True):
            metadata = {
                "name": step["name"],
                "extension": step["extension"],
                "cas_id": step["cas_id"],
            }
        preview = None
        if self.init.get("with_preview_media") and step["cas_id"]:
            node = getattr(ctx.library, "node", None)
            if node is not None:
                thumb = node.thumbnailer.store.path_for(
                    str(ctx.library.id), step["cas_id"]
                )
                preview = await asyncio.to_thread(_read_preview, thumb)

        def run() -> None:
            encrypt_file(
                src,
                dst,
                self.init["password"].encode(),
                algorithm=Algorithm(self.init.get("algorithm", 0)),
                hashing=HashingAlgorithm(
                    self.init.get("hashing", HashingAlgorithm.ARGON2ID)
                ),
                metadata=metadata,
                preview_media=preview,
                _test_overrides=_overrides(self.init),
            )
            if erase:
                from .erase import erase_file

                erase_file(src, passes=1)
                os.remove(src)

        loc_id = self.init["location_id"]
        with watcher_pause(ctx, loc_id, [dst, src] if erase else [dst]):
            await asyncio.to_thread(run)
        await watcher_announce(ctx, loc_id, created=[dst], removed=[src] if erase else [])
        ctx.progress(completed_task_count=step_number + 1)
        return StepResult()

    async def finalize(self, ctx: JobContext):
        return {"encrypted": len(self.steps)}


@register_job
class FileDecryptorJob(StatefulJob):
    """init: {location_id, file_path_ids, password, erase_original?}"""

    NAME = "file_decryptor"

    async def init_job(self, ctx: JobContext) -> None:
        db = ctx.library.db
        loc_path = get_location_path(db, self.init["location_id"])
        for fd in get_many_files_datas(db, loc_path, self.init["file_path_ids"]):
            if fd.row.get("is_dir"):
                continue
            self.steps.append({"full_path": fd.full_path})
        ctx.progress(task_count=len(self.steps), phase="decrypting")

    async def execute_step(self, ctx: JobContext, step: dict, step_number: int) -> StepResult:
        src = step["full_path"]
        if src.endswith(f".{ENCRYPTED_EXT}"):
            dst = src[: -(len(ENCRYPTED_EXT) + 1)]
        else:
            dst = src + ".decrypted"
        erase = bool(self.init.get("erase_original"))

        def run() -> None:
            decrypt_file(
                src,
                dst,
                self.init["password"].encode(),
                _test_overrides=_overrides(self.init),
            )
            if erase:
                os.remove(src)

        loc_id = self.init["location_id"]
        with watcher_pause(ctx, loc_id, [dst, src] if erase else [dst]):
            await asyncio.to_thread(run)
        await watcher_announce(ctx, loc_id, created=[dst], removed=[src] if erase else [])
        ctx.progress(completed_task_count=step_number + 1)
        return StepResult()

    async def finalize(self, ctx: JobContext):
        return {"decrypted": len(self.steps)}
