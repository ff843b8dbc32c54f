"""OS volume / mounted-disk enumeration.

Parity: ref:core/src/volume/mod.rs — `Volume{name, mount_points,
total_capacity, available_capacity, disk_type, file_system,
is_root_filesystem}` gathered via `sysinfo` (mod.rs:109,249). Here:
/proc/mounts + `shutil.disk_usage` on Linux, `psutil`-free; other
platforms fall back to the root filesystem only. Pseudo-filesystems are
filtered the way the reference skips zero-capacity disks.

Counterpart of `spacedrive_tpu/node/volumes.py`.
"""

from __future__ import annotations

import os
import platform
import shutil
from dataclasses import dataclass

_PSEUDO_FS = {
    "proc", "sysfs", "devtmpfs", "devpts", "tmpfs", "cgroup", "cgroup2",
    "overlay", "squashfs", "securityfs", "debugfs", "tracefs", "ramfs",
    "pstore", "bpf", "autofs", "mqueue", "hugetlbfs", "fusectl",
    "configfs", "binfmt_misc", "nsfs", "rpc_pipefs", "efivarfs",
}


@dataclass
class Volume:
    name: str
    mount_point: str
    total_bytes_capacity: int = 0
    total_bytes_available: int = 0
    disk_type: str = "Unknown"  # SSD | HDD | Unknown (ref:volume/mod.rs DiskType)
    filesystem: str | None = None
    is_system: bool = False


def _disk_type(device: str) -> str:
    """SSD/HDD via /sys rotational flag (sysinfo does the same probe)."""
    base = os.path.basename(device).rstrip("0123456789")
    if base.startswith("nvme"):
        return "SSD"
    rot = f"/sys/block/{base}/queue/rotational"
    try:
        with open(rot) as f:
            return "HDD" if f.read().strip() == "1" else "SSD"
    except OSError:
        return "Unknown"


def get_volumes() -> list[Volume]:
    """Enumerate real mounted volumes (ref:volume/mod.rs:109 `get_volumes`)."""
    vols: list[Volume] = []
    seen: set[str] = set()
    if platform.system() == "Linux" and os.path.exists("/proc/mounts"):
        with open("/proc/mounts") as f:
            lines = f.readlines()
        for line in lines:
            parts = line.split()
            if len(parts) < 3:
                continue
            device, mount, fstype = parts[0], parts[1], parts[2]
            # /proc/mounts octal-escapes UTF-8 bytes (\040 space etc.);
            # unicode_escape yields Latin-1 codepoints, so re-encode
            mount = (
                mount.encode("latin-1")
                .decode("unicode_escape")
                .encode("latin-1")
                .decode("utf-8", "surrogateescape")
            )
            if fstype in _PSEUDO_FS or mount in seen:
                continue
            try:
                usage = shutil.disk_usage(mount)
            except OSError:
                continue
            if usage.total == 0:
                continue  # ref skips zero-capacity disks
            seen.add(mount)
            vols.append(
                Volume(
                    name=os.path.basename(device) or device,
                    mount_point=mount,
                    total_bytes_capacity=usage.total,
                    total_bytes_available=usage.free,
                    disk_type=_disk_type(device),
                    filesystem=fstype,
                    is_system=(mount == "/"),
                )
            )
    if not vols:  # non-Linux fallback: root filesystem only
        usage = shutil.disk_usage(os.path.abspath(os.sep))
        vols.append(
            Volume(
                name="Root",
                mount_point=os.path.abspath(os.sep),
                total_bytes_capacity=usage.total,
                total_bytes_available=usage.free,
                is_system=True,
            )
        )
    return vols

