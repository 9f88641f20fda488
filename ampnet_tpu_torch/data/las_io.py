"""Minimal LAS 1.2–1.4 point-cloud codec (pure NumPy, vectorized), the port's
own copy of ``ampnet_tpu/data/las_io.py``.

The reference depends on ``laspy`` for LAS I/O (``1_get_windows_split.py:36``,
``2_preprocessing_filter_norm.py:38``); that package is not part of this
environment, so the framework ships its own codec. Reading is a single
``np.frombuffer`` with a structured dtype per point format — effectively memcpy
speed — covering the fields the pipeline needs (x/y/z, intensity, classification,
RGB, NIR, plus HeightAboveGround via extra bytes). Writing emits LAS 1.4 with point
format 3 (what the reference writes for PDAL compatibility, ``:112``) or format 8
(native NIR).

Supported point formats: 0, 1, 2, 3, 6, 7, 8. LAZ compression is out of scope.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

_POINT_DTYPES: Dict[int, np.dtype] = {}


def _base_legacy():
    return [
        ("x", "<i4"),
        ("y", "<i4"),
        ("z", "<i4"),
        ("intensity", "<u2"),
        ("flags", "u1"),
        ("classification", "u1"),
        ("scan_angle", "i1"),
        ("user_data", "u1"),
        ("point_source", "<u2"),
    ]


def _base_14():
    return [
        ("x", "<i4"),
        ("y", "<i4"),
        ("z", "<i4"),
        ("intensity", "<u2"),
        ("returns", "u1"),
        ("flags", "u1"),
        ("classification", "u1"),
        ("user_data", "u1"),
        ("scan_angle", "<i2"),
        ("point_source", "<u2"),
        ("gps_time", "<f8"),
    ]


_POINT_DTYPES[0] = np.dtype(_base_legacy())
_POINT_DTYPES[1] = np.dtype(_base_legacy() + [("gps_time", "<f8")])
_POINT_DTYPES[2] = np.dtype(_base_legacy() + [("red", "<u2"), ("green", "<u2"), ("blue", "<u2")])
_POINT_DTYPES[3] = np.dtype(
    _base_legacy()
    + [("gps_time", "<f8"), ("red", "<u2"), ("green", "<u2"), ("blue", "<u2")]
)
_POINT_DTYPES[6] = np.dtype(_base_14())
_POINT_DTYPES[7] = np.dtype(_base_14() + [("red", "<u2"), ("green", "<u2"), ("blue", "<u2")])
_POINT_DTYPES[8] = np.dtype(
    _base_14()
    + [("red", "<u2"), ("green", "<u2"), ("blue", "<u2"), ("nir", "<u2")]
)


@dataclass
class LasCloud:
    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    intensity: np.ndarray
    classification: np.ndarray
    red: Optional[np.ndarray] = None
    green: Optional[np.ndarray] = None
    blue: Optional[np.ndarray] = None
    nir: Optional[np.ndarray] = None
    extra: Dict[str, np.ndarray] = field(default_factory=dict)
    point_format: int = 3

    def __len__(self):
        return len(self.x)

    @property
    def height_above_ground(self) -> Optional[np.ndarray]:
        return self.extra.get("HeightAboveGround")


def read_las(path: str, mmap: bool = False) -> LasCloud:
    """Read a LAS file. With ``mmap=True`` the point records are memory-mapped
    instead of copied into RAM — field access still materializes per-field arrays,
    but GB-scale tiles never get a second whole-file copy."""
    if mmap:
        data = np.memmap(path, dtype=np.uint8, mode="r")
        header_bytes = bytes(data[:512].tobytes())
    else:
        with open(path, "rb") as f:
            data = f.read()
        header_bytes = data
    if bytes(header_bytes[:4]) != b"LASF":
        raise ValueError(f"{path}: not a LAS file")
    return _parse_las(path, data, header_bytes)


def _parse_las(path: str, data, header_bytes) -> LasCloud:
    point_offset = struct.unpack_from("<I", header_bytes, 96)[0]
    # make sure header + VLR region is plain bytes (mmap gives only a prefix)
    hb = (
        header_bytes
        if len(header_bytes) >= point_offset
        else bytes(np.asarray(data[:point_offset]).tobytes())
    )
    ver_minor = hb[25]
    header_size = struct.unpack_from("<H", hb, 94)[0]
    fmt_byte = hb[104]
    if fmt_byte & 0x80:
        raise ValueError(f"{path}: LAZ-compressed files are not supported")
    point_format = fmt_byte & 0x3F
    record_len = struct.unpack_from("<H", hb, 105)[0]
    n_points = struct.unpack_from("<I", hb, 107)[0]
    if ver_minor >= 4 and header_size >= 375:
        n64 = struct.unpack_from("<Q", hb, 247)[0]
        if n64:
            n_points = n64
    scales = struct.unpack_from("<3d", hb, 131)
    offsets = struct.unpack_from("<3d", hb, 155)

    if point_format not in _POINT_DTYPES:
        raise ValueError(f"{path}: unsupported point format {point_format}")
    base = _POINT_DTYPES[point_format]
    extra_bytes = record_len - base.itemsize
    if extra_bytes < 0:
        raise ValueError(f"{path}: record length {record_len} < format size {base.itemsize}")
    fields = dict(names=list(base.names), formats=[base[n] for n in base.names],
                  offsets=[base.fields[n][1] for n in base.names], itemsize=record_len)
    dtype = np.dtype(fields)
    raw = np.frombuffer(data, dtype=dtype, count=n_points, offset=point_offset)

    cls = raw["classification"]
    if point_format < 6:
        cls = cls & 0x1F  # legacy formats pack flags into the upper 3 bits

    cloud = LasCloud(
        x=raw["x"] * scales[0] + offsets[0],
        y=raw["y"] * scales[1] + offsets[1],
        z=raw["z"] * scales[2] + offsets[2],
        intensity=raw["intensity"].astype(np.float64),
        classification=cls.astype(np.int64),
        point_format=point_format,
    )
    for c in ("red", "green", "blue", "nir"):
        if c in (base.names or ()):
            setattr(cloud, c, raw[c].astype(np.float64))

    # extra bytes: the PDAL HAG stage appends a float64/float32 HeightAboveGround
    # dimension; recover it via the Extra Bytes VLR if present
    if extra_bytes > 0:
        name, fmt = _find_extra_dim(hb, header_size, point_offset)
        if name and np.dtype(fmt).itemsize <= extra_bytes:
            ex = np.frombuffer(
                data,
                dtype=np.dtype(dict(names=[name], formats=[fmt],
                                    offsets=[base.itemsize], itemsize=record_len)),
                count=n_points,
                offset=point_offset,
            )
            cloud.extra[name] = ex[name].astype(np.float64)
    return cloud


_EB_TYPES = {9: "<f4", 10: "<f8", 29: "<f8"}


def _find_extra_dim(data: bytes, header_size: int, point_offset: int):
    """Scan VLRs for an Extra Bytes record (record id 4) and return its first dim."""
    pos = header_size
    while pos + 54 <= point_offset:
        record_id = struct.unpack_from("<H", data, pos + 18)[0]
        rec_len = struct.unpack_from("<H", data, pos + 20)[0]
        if record_id == 4 and rec_len >= 192:
            desc = data[pos + 54 : pos + 54 + 192]
            data_type = desc[2]
            name = desc[4:36].split(b"\0")[0].decode("ascii", "ignore")
            return name, _EB_TYPES.get(data_type, "<f8")
        pos += 54 + rec_len
    return None, None


def write_las(path: str, cloud: LasCloud, point_format: Optional[int] = None,
              scale: float = 0.001) -> None:
    fmt = point_format if point_format is not None else (8 if cloud.nir is not None else 3)
    if fmt not in _POINT_DTYPES:
        raise ValueError(f"unsupported point format {fmt}")
    dtype = _POINT_DTYPES[fmt]
    n = len(cloud)

    offsets = (float(np.min(cloud.x)), float(np.min(cloud.y)), float(np.min(cloud.z)))
    rec = np.zeros(n, dtype=dtype)
    rec["x"] = np.round((cloud.x - offsets[0]) / scale).astype(np.int64)
    rec["y"] = np.round((cloud.y - offsets[1]) / scale).astype(np.int64)
    rec["z"] = np.round((cloud.z - offsets[2]) / scale).astype(np.int64)
    rec["intensity"] = np.clip(cloud.intensity, 0, 65535).astype(np.uint16)
    cls = np.asarray(cloud.classification).astype(np.uint8)
    rec["classification"] = (cls & 0x1F) if fmt < 6 else cls
    for c in ("red", "green", "blue", "nir"):
        if c in dtype.names and getattr(cloud, c) is not None:
            rec[c] = np.clip(getattr(cloud, c), 0, 65535).astype(np.uint16)

    header_size = 375
    header = bytearray(header_size)
    header[0:4] = b"LASF"
    header[24] = 1
    header[25] = 4
    struct.pack_into("<H", header, 94, header_size)
    struct.pack_into("<I", header, 96, header_size)  # points follow immediately
    struct.pack_into("<I", header, 100, 0)  # no VLRs
    header[104] = fmt
    struct.pack_into("<H", header, 105, dtype.itemsize)
    struct.pack_into("<I", header, 107, min(n, 0xFFFFFFFF) if fmt < 6 else 0)
    struct.pack_into("<3d", header, 131, scale, scale, scale)
    struct.pack_into("<3d", header, 155, *offsets)
    struct.pack_into(
        "<6d",
        header,
        179,
        float(np.max(cloud.x)), float(np.min(cloud.x)),
        float(np.max(cloud.y)), float(np.min(cloud.y)),
        float(np.max(cloud.z)), float(np.min(cloud.z)),
    )
    struct.pack_into("<Q", header, 247, n)

    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(rec.tobytes())
