"""EXIF / media metadata extraction.

Counterpart of `spacedrive_tpu/object/media/media_data.py`:
`ImageMetadata` (ref:crates/media-metadata/src/image/mod.rs:27-47:
resolution, date_taken, location, camera_data, artist, description,
copyright, exif_version), extracted with PIL, and `VideoMetadata`
(ref:crates/media-metadata/src/video.rs; the reference ships a stub,
this reads the stream's facts), probed through the native FFmpeg
frontend (native/video.py) first and cv2 second. The packed columns come
from the port's MessagePack codec and equal the JAX package's bytes.
"""

from __future__ import annotations

import datetime as _dt
import logging
import os
from dataclasses import asdict, dataclass, field
from typing import Any

from ...utils.msgpack_codec import packb

logger = logging.getLogger(__name__)

ORIENTATION_NORMAL = 1


@dataclass
class MediaLocation:
    latitude: float
    longitude: float
    altitude: float | None = None
    direction: float | None = None

    def plus_code(self) -> str:
        """Open Location Code of this position
        (ref:crates/media-metadata/src/image/geographic/pluscodes.rs)."""
        return encode_plus_code(self.latitude, self.longitude)


@dataclass
class CameraData:
    device_make: str | None = None
    device_model: str | None = None
    focal_length: float | None = None
    shutter_speed: str | None = None
    iso: int | None = None
    aperture: float | None = None
    flash: bool | None = None
    lens_make: str | None = None
    lens_model: str | None = None
    orientation: int = ORIENTATION_NORMAL


@dataclass
class ImageMetadata:
    resolution: tuple[int, int] = (0, 0)
    date_taken: str | None = None
    epoch_time: int | None = None
    location: MediaLocation | None = None
    camera_data: CameraData = field(default_factory=CameraData)
    artist: str | None = None
    description: str | None = None
    copyright: str | None = None
    exif_version: str | None = None

    @classmethod
    def from_path(cls, path: str | os.PathLike) -> "ImageMetadata | None":
        """The image's metadata; None when PIL cannot open it or its
        EXIF is malformed (the caller vouches "nothing extractable")."""
        from PIL import ExifTags, Image

        try:
            with Image.open(path) as im:
                meta = cls(resolution=(im.width, im.height))
                exif = im.getexif()
                if not exif:
                    return meta
                tags = {ExifTags.TAGS.get(k, k): v for k, v in exif.items()}
                try:
                    ifd = {ExifTags.TAGS.get(k, k): v
                           for k, v in exif.get_ifd(ExifTags.IFD.Exif).items()}
                except Exception:  # noqa: BLE001 - no readable Exif IFD
                    ifd = {}

                dt = ifd.get("DateTimeOriginal") or tags.get("DateTime")
                if isinstance(dt, str):
                    meta.date_taken = dt
                    try:
                        parsed = _dt.datetime.strptime(dt, "%Y:%m:%d %H:%M:%S")
                        meta.epoch_time = int(parsed.timestamp())
                    except ValueError:
                        pass
                meta.artist = _s(tags.get("Artist"))
                meta.description = _s(tags.get("ImageDescription"))
                meta.copyright = _s(tags.get("Copyright"))
                ev = ifd.get("ExifVersion")
                if isinstance(ev, bytes):
                    meta.exif_version = ev.decode("ascii", "ignore")
                cam = meta.camera_data
                cam.device_make = _s(tags.get("Make"))
                cam.device_model = _s(tags.get("Model"))
                cam.orientation = int(tags.get("Orientation") or ORIENTATION_NORMAL)
                cam.lens_make = _s(ifd.get("LensMake"))
                cam.lens_model = _s(ifd.get("LensModel"))
                fl = ifd.get("FocalLength")
                cam.focal_length = float(fl) if fl is not None else None
                ap = ifd.get("FNumber")
                cam.aperture = float(ap) if ap is not None else None
                iso = ifd.get("ISOSpeedRatings")
                cam.iso = int(iso) if isinstance(iso, (int, float)) else None
                flash = ifd.get("Flash")
                cam.flash = bool(int(flash) & 1) if isinstance(flash, (int, float)) else None

                meta.location = _gps(exif)
                return meta
        except Exception as e:  # noqa: BLE001 - a file PIL cannot parse has no metadata
            logger.debug("exif extraction failed for %s: %s", path, e)
            return None

    def to_row(self, object_id: int) -> dict[str, Any]:
        """The media_data row (ref:schema.prisma:281-310)."""
        return {
            "resolution": packb(list(self.resolution)),
            "media_date": packb(self.date_taken),
            "media_location": packb(asdict(self.location)) if self.location else None,
            "camera_data": packb(asdict(self.camera_data)),
            "artist": self.artist,
            "description": self.description,
            "copyright": self.copyright,
            "exif_version": self.exif_version,
            "epoch_time": self.epoch_time,
            "object_id": object_id,
        }


@dataclass
class VideoMetadata:
    """A video's stream facts: resolution, duration, fps, frame count and
    codec."""

    resolution: tuple[int, int] = (0, 0)
    duration_seconds: float | None = None
    fps: float | None = None
    frame_count: int | None = None
    codec: str | None = None

    @classmethod
    def from_path(cls, path: str | os.PathLike) -> "VideoMetadata | None":
        """The native probe first (real codec names and the container's
        duration, ref:crates/ffmpeg), cv2 where it is unavailable or
        cannot probe the file; None when neither reads a resolution (the
        caller vouches "nothing extractable"). A failed frontend build
        raises NativeBuildError."""
        from ...native.video import video_meta

        try:
            meta = video_meta(os.fspath(path))
        except ValueError:
            meta = None
        if meta is not None and meta["width"] and meta["height"]:
            return cls(
                resolution=(meta["width"], meta["height"]),
                duration_seconds=meta["duration_seconds"] or None,
                fps=meta["fps"] or None,
                frame_count=meta["frame_count"] or None,
                codec=meta["codec"] or None,
            )
        try:
            import cv2
        except ImportError:
            return None
        cap = cv2.VideoCapture(os.fspath(path))
        try:
            if not cap.isOpened():
                return None
            w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH) or 0)
            h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT) or 0)
            fps = float(cap.get(cv2.CAP_PROP_FPS) or 0) or None
            frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0) or None
            fourcc = int(cap.get(cv2.CAP_PROP_FOURCC) or 0)
            codec = ("".join(chr((fourcc >> (8 * i)) & 0xFF) for i in range(4)).strip() or None
                     if fourcc else None)
            duration = (frames / fps) if frames and fps else None
            if not (w and h):
                return None
            return cls(resolution=(w, h), duration_seconds=duration, fps=fps,
                       frame_count=frames, codec=codec)
        finally:
            cap.release()

    def to_row(self, object_id: int) -> dict[str, Any]:
        """The media_data row: the resolution blob as for images; the
        video facts ride the camera_data slot as a typed dict."""
        return {
            "resolution": packb(list(self.resolution)),
            "camera_data": packb({
                "video": True,
                "duration_seconds": self.duration_seconds,
                "fps": self.fps,
                "frame_count": self.frame_count,
                "codec": self.codec,
            }),
            "object_id": object_id,
        }


def _s(v: Any) -> str | None:
    return str(v).strip("\x00 ").strip() if v is not None else None


def _gps(exif) -> MediaLocation | None:
    from PIL import ExifTags

    try:
        gps_raw = exif.get_ifd(ExifTags.IFD.GPSInfo)
        if not gps_raw:
            return None
        gps = {ExifTags.GPSTAGS.get(k, k): v for k, v in gps_raw.items()}
        lat = _dms(gps.get("GPSLatitude"), gps.get("GPSLatitudeRef", "N"))
        lon = _dms(gps.get("GPSLongitude"), gps.get("GPSLongitudeRef", "E"))
        if lat is None or lon is None:
            return None
        alt = gps.get("GPSAltitude")
        return MediaLocation(latitude=lat, longitude=lon,
                             altitude=float(alt) if alt is not None else None)
    except Exception:  # noqa: BLE001 - malformed GPS tags mean no location
        return None


def _dms(value, ref: str) -> float | None:
    if not value or len(value) != 3:
        return None
    deg = float(value[0]) + float(value[1]) / 60 + float(value[2]) / 3600
    if ref in ("S", "W"):
        deg = -deg
    return deg


# --- Open Location Code (plus codes), parity with
# ref:crates/media-metadata/src/image/geographic/pluscodes.rs ---

_OLC_ALPHABET = "23456789CFGHJMPQRVWX"


def encode_plus_code(lat: float, lon: float, code_length: int = 10) -> str:
    lat = min(90.0, max(-90.0, lat)) + 90.0
    lon = (lon + 180.0) % 360.0
    code = ""
    lat_res, lon_res = 400.0, 400.0
    for i in range(code_length // 2):
        lat_res /= 20.0
        lon_res /= 20.0
        code += _OLC_ALPHABET[min(19, int(lat / lat_res))]
        lat -= int(lat / lat_res) * lat_res
        code += _OLC_ALPHABET[min(19, int(lon / lon_res))]
        lon -= int(lon / lon_res) * lon_res
        if i == 3:
            code += "+"
    if "+" not in code:
        code += "+"
    return code
