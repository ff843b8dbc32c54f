"""Hardware probing — device model + accelerator inventory.

Counterpart of `spacedrive_tpu/node/hardware.py`; only `accelerators`
differs: it lists the CUDA devices instead of JAX's.

Parity: ref:core/src/node/hardware.rs — `HardwareModel` detection fed
into node metadata/peer listings — extended with the accelerator
inventory a node advertises (device kind and count) and `crates/fda`'s
disk-access check (macOS Full Disk Access prompt,
ref:crates/fda/src/lib.rs:31-40; on non-macOS the check degrades to a
plain read-permission probe).
"""

from __future__ import annotations

import functools
import os
import platform
from typing import Any


@functools.cache
def hardware_model() -> str:
    """Coarse device model string (ref:hardware.rs `HardwareModel`)."""
    system = platform.system()
    if system == "Darwin":
        try:
            import subprocess

            out = subprocess.run(
                ["sysctl", "-n", "hw.model"], capture_output=True, text=True,
                timeout=5,
            )
            return out.stdout.strip() or "Mac"
        except Exception:
            return "Mac"
    if system == "Linux":
        for probe in (
            "/sys/devices/virtual/dmi/id/product_name",
            "/proc/device-tree/model",
        ):
            try:
                with open(probe) as f:
                    name = f.read().strip("\x00\n ")
                if name:
                    return name
            except OSError:
                continue
        return "Linux PC"
    return platform.machine() or "Unknown"


def accelerators() -> list[dict[str, Any]]:
    """The node's CUDA device inventory, in the JAX package's record
    shape (advertised in nodeState/peer metadata): one entry per
    visible device, [] on a host without CUDA."""
    try:
        import torch

        if not torch.cuda.is_available():
            return []
        return [
            {
                "id": i,
                "kind": torch.cuda.get_device_name(i),
                "platform": "gpu",
                "process_index": 0,
            }
            for i in range(torch.cuda.device_count())
        ]
    except Exception:
        return []


def has_full_disk_access(probe_path: str | None = None) -> bool:
    """ref:crates/fda/src/lib.rs:31-40 — the reference reads a
    TCC-protected dir on macOS to detect Full Disk Access; elsewhere a
    plain readability probe of the requested path stands in."""
    if platform.system() == "Darwin":
        probe = probe_path or os.path.expanduser(
            "~/Library/Application Support/com.apple.TCC"
        )
    else:
        probe = probe_path or os.path.expanduser("~")
    try:
        os.listdir(probe)
        return True
    except PermissionError:
        return False
    except OSError:
        return True  # missing dir ≠ missing permission
