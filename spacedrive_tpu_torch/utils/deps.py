"""Dependency and license inventory (the reference's deps-generator).

Counterpart of `spacedrive_tpu/utils/deps.py` (ref:crates/deps-generator
/src/main.rs, which emits every dependency with its license for the
interface's credits screen), over this package's two dependency planes:

- **Python packages** this package imports at run time, resolved live
  through importlib.metadata (name, version, license from the metadata
  or the trove classifiers); packages not installed are left out;
- **native libraries**: the C libraries loaded through ctypes (cairo,
  freetype, libheif, librsvg, FFmpeg's libav*, sqlite) and the CUDA
  runtime K1's extension runs on, resolved to the library on this host,
  with their upstream licenses from a curated table.

`python -m spacedrive_tpu_torch licenses` prints the JSON.
"""

from __future__ import annotations

import ctypes.util
import importlib.metadata as md
from typing import Any

#: the packages this package imports at run time (stdlib excluded); the
#: optional ones degrade a feature when absent
PYTHON_DEPS = [
    "torch", "numpy", "Pillow", "cryptography", "opencv-python",
    "opencv-python-headless", "scikit-learn",
]

#: ctypes-loaded C libraries; license strings per the upstream projects
NATIVE_DEPS = [
    ("cairo", "LGPL-2.1 OR MPL-1.1", "PDF/SVG rasterization"),
    ("freetype", "FTL OR GPL-2.0", "embedded PDF font glyphs"),
    ("heif", "LGPL-3.0", "HEIF/HEIC decode"),
    ("rsvg-2", "LGPL-2.1", "SVG rendering"),
    ("avformat", "LGPL-2.1", "video demux (FFmpeg)"),
    ("avcodec", "LGPL-2.1", "video decode (FFmpeg)"),
    ("avutil", "LGPL-2.1", "FFmpeg utilities"),
    ("swscale", "LGPL-2.1", "frame scaling (FFmpeg)"),
    ("sqlite3", "Public Domain", "library database"),
    ("cudart", "NVIDIA CUDA Toolkit EULA", "CUDA runtime (the BLAKE3 chunk kernel)"),
]


def _license_of(dist: md.Distribution) -> str:
    meta = dist.metadata
    lic = (meta.get("License-Expression") or meta.get("License") or "").strip()
    if lic and lic.upper() != "UNKNOWN" and len(lic) < 120:
        return lic
    for classifier in meta.get_all("Classifier") or []:
        if classifier.startswith("License ::"):
            return classifier.split("::")[-1].strip()
    return "unknown"


def collect() -> dict[str, Any]:
    python: list[dict[str, str]] = []
    for name in PYTHON_DEPS:
        try:
            dist = md.distribution(name)
        except md.PackageNotFoundError:
            continue
        python.append({
            "name": dist.metadata["Name"] or name,
            "version": dist.version,
            "license": _license_of(dist),
        })
    native: list[dict[str, str]] = []
    for lib, license_, role in NATIVE_DEPS:
        path = ctypes.util.find_library(lib)
        native.append({
            "name": lib,
            "resolved": path or "not present (feature degrades)",
            "license": license_,
            "role": role,
        })
    return {"python": python, "native": native}
