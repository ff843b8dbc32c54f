"""The video decode frontend: FFmpeg's libraries through a small C library.

Counterpart of the video half of `spacedrive_tpu/native/__init__.py`
(`load_video`, `video_available`, `video_frame`, `video_meta`) over the
port's owned copy of its C source, `ops/csrc/movie_decoder.c`
(ref:crates/ffmpeg/src/movie_decoder.rs:32-629: the preferred video
stream with embedded cover art first, a seek ~10% in, the display
matrix's rotation, RGBA through swscale).

The library is compiled with the system C compiler the first time a
frame or a probe is asked for (never at import), into
`spacedrive_tpu_torch/_build/movie_decoder_<source digest>.so`, linked
with libavformat, libavcodec, libavutil and libswscale. Where those
libraries or their headers are not found, `video_available()` is false
and callers take the cv2 path (object/media/thumbnail/host.py). Where
they are found and the build fails, NativeBuildError is raised with the
compiler's output, on that call and every later one: the frontend never
falls back silently.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import sysconfig
import threading

import numpy as np

from .build import NativeBuildError, built_path, compile_shared

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "ops", "csrc",
                    "movie_decoder.c")
AV_LIBS = ("avformat", "avcodec", "avutil", "swscale")
AV_HEADERS = ("libavformat/avformat.h", "libavcodec/avcodec.h", "libavutil/display.h",
              "libavutil/imgutils.h", "libswscale/swscale.h")

_lock = threading.Lock()
#: the load's outcome once decided: [CDLL], [None] (libav absent) or
#: [NativeBuildError] (libav present, the build failed)
_outcome: list = []


def _include_dir() -> str | None:
    """The include directory holding every libav header, or None."""
    multiarch = sysconfig.get_config_var("MULTIARCH")
    dirs = [d for var in ("CPATH", "C_INCLUDE_PATH")
            for d in os.environ.get(var, "").split(os.pathsep) if d]
    dirs += ["/usr/local/include", "/usr/include", "/usr/include/ffmpeg"]
    if multiarch:
        dirs.append(f"/usr/include/{multiarch}")
    for d in dirs:
        if all(os.path.exists(os.path.join(d, h)) for h in AV_HEADERS):
            return d
    return None


def libav_present() -> bool:
    """libav's four libraries and their headers are all found."""
    return all(ctypes.util.find_library(n) for n in AV_LIBS) and _include_dir() is not None


def _load() -> ctypes.CDLL | None:
    if not libav_present():
        return None
    so = built_path(_SRC, "movie_decoder")
    if not os.path.exists(so):
        compile_shared(_SRC, so, (f"-I{_include_dir()}", *(f"-l{n}" for n in AV_LIBS), "-lm"))
    lib = ctypes.CDLL(so)
    lib.sd_video_frame.restype = ctypes.c_int
    lib.sd_video_frame.argtypes = [
        ctypes.c_char_p, ctypes.c_double,
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.sd_video_meta.restype = ctypes.c_int
    lib.sd_video_meta.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.sd_video_free.restype = None
    lib.sd_video_free.argtypes = [ctypes.c_void_p]
    return lib


def load_video() -> ctypes.CDLL | None:
    """The frontend, built on first use; None where libav is absent.
    Raises NativeBuildError where libav is present and the build
    failed."""
    with _lock:
        if not _outcome:
            try:
                _outcome.append(_load())
            except NativeBuildError as exc:
                _outcome.append(exc)
        got = _outcome[0]
    if isinstance(got, NativeBuildError):
        raise got
    return got


def video_available() -> bool:
    return load_video() is not None


def video_frame(path: str, seek_fraction: float = 0.1):
    """(rgba HxWx4 uint8, rotation_degrees, is_cover), or None where the
    frontend is unavailable; raises ValueError on a file it cannot
    decode."""
    lib = load_video()
    if lib is None:
        return None
    buf = ctypes.c_void_p()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rot = ctypes.c_int()
    cover = ctypes.c_int()
    err = ctypes.create_string_buffer(256)
    rc = lib.sd_video_frame(
        os.fsencode(path), seek_fraction, ctypes.byref(buf),
        ctypes.byref(w), ctypes.byref(h), ctypes.byref(rot),
        ctypes.byref(cover), err, len(err),
    )
    if rc != 0:
        raise ValueError(f"video decode failed: {err.value.decode(errors='replace')}")
    try:
        n = w.value * h.value * 4
        arr = np.frombuffer(ctypes.string_at(buf.value, n), np.uint8
                            ).reshape(h.value, w.value, 4).copy()
    finally:
        lib.sd_video_free(buf)
    return arr, rot.value, bool(cover.value)


def video_meta(path: str) -> dict | None:
    """{duration_seconds, fps, width, height, frame_count, codec}, or None
    where the frontend is unavailable; raises ValueError on a file it
    cannot probe."""
    lib = load_video()
    if lib is None:
        return None
    dur = ctypes.c_double()
    fps = ctypes.c_double()
    w = ctypes.c_int()
    h = ctypes.c_int()
    frames = ctypes.c_int64()
    codec = ctypes.create_string_buffer(64)
    rc = lib.sd_video_meta(
        os.fsencode(path), ctypes.byref(dur), ctypes.byref(fps),
        ctypes.byref(w), ctypes.byref(h), ctypes.byref(frames),
        codec, len(codec),
    )
    if rc != 0:
        raise ValueError(f"video probe failed: {path}")
    return {
        "duration_seconds": dur.value, "fps": fps.value,
        "width": w.value, "height": h.value,
        "frame_count": int(frames.value),
        "codec": codec.value.decode(errors="replace"),
    }
