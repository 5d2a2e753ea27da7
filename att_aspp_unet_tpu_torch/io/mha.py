"""MetaImage (.mha) reader/writer.

The MetaIO format used by the ACOUSLIC-AI challenge data (a copy of
``att_aspp_unet_tpu/io/mha.py``): a text header (``Key = Value`` lines, data order
x-fastest) followed by a raw or zlib-deflated pixel blob.

Only the single-file ``ElementDataFile = LOCAL`` layout is supported — that is
what ``.mha`` means (as opposed to ``.mhd`` + ``.raw``), and it is the only
layout the challenge uses.

Inflate/deflate use Python's ``zlib``.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

# MetaIO ElementType <-> numpy dtype
_MET_TO_DTYPE = {
    "MET_CHAR": np.int8,
    "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16,
    "MET_USHORT": np.uint16,
    "MET_INT": np.int32,
    "MET_UINT": np.uint32,
    "MET_LONG": np.int64,
    "MET_ULONG": np.uint64,
    "MET_LONG_LONG": np.int64,
    "MET_ULONG_LONG": np.uint64,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}
_DTYPE_TO_MET = {
    np.dtype(np.int8): "MET_CHAR",
    np.dtype(np.uint8): "MET_UCHAR",
    np.dtype(np.int16): "MET_SHORT",
    np.dtype(np.uint16): "MET_USHORT",
    np.dtype(np.int32): "MET_INT",
    np.dtype(np.uint32): "MET_UINT",
    np.dtype(np.int64): "MET_LONG_LONG",
    np.dtype(np.uint64): "MET_ULONG_LONG",
    np.dtype(np.float32): "MET_FLOAT",
    np.dtype(np.float64): "MET_DOUBLE",
}


@dataclass
class MetaImage:
    """An N-D image with MetaIO metadata.

    ``array`` is indexed slowest-first (z, y, x) like
    ``SimpleITK.GetArrayFromImage``; ``spacing``/``offset`` are stored in
    MetaIO (x, y, z) order like ``GetSpacing``.
    """

    array: np.ndarray
    spacing: Tuple[float, ...] = (1.0, 1.0, 1.0)
    offset: Tuple[float, ...] = (0.0, 0.0, 0.0)
    transform: Optional[np.ndarray] = None       # row-major (ndim*ndim,)
    extra_keys: Dict[str, str] = field(default_factory=dict)

    @property
    def size(self) -> Tuple[int, ...]:
        """DimSize in MetaIO (x, y, z) order."""
        return tuple(reversed(self.array.shape))

    def copy_information(self, other: "MetaImage") -> None:
        """Copy spacing/offset/transform from another image (the equivalent of
        ``sitk.Image.CopyInformation`` used when writing outputs that must
        inherit the input geometry)."""
        self.spacing = other.spacing
        self.offset = other.offset
        self.transform = None if other.transform is None else other.transform.copy()


def _parse_value(key: str, value: str):
    return value.strip()


def read_mha(path) -> MetaImage:
    """Read a .mha file (LOCAL data, raw or zlib-compressed)."""
    raw = Path(path).read_bytes()

    # --- parse the text header line by line until ElementDataFile ---
    header: Dict[str, str] = {}
    pos = 0
    while True:
        nl = raw.find(b"\n", pos)
        if nl < 0:
            raise ValueError(f"{path}: no ElementDataFile key found")
        line = raw[pos:nl].decode("ascii", errors="replace").strip()
        pos = nl + 1
        if not line:
            continue
        if "=" not in line:
            raise ValueError(f"{path}: malformed header line {line!r}")
        key, value = (s.strip() for s in line.split("=", 1))
        header[key] = value
        if key == "ElementDataFile":
            break

    if header.get("ObjectType", "Image") != "Image":
        raise ValueError(f"{path}: ObjectType {header.get('ObjectType')!r} unsupported")
    if header["ElementDataFile"].upper() != "LOCAL":
        raise ValueError(f"{path}: only ElementDataFile=LOCAL (.mha) is supported")
    if "DimSize" not in header:
        raise ValueError(f"{path}: header has no DimSize key")

    try:
        ndims = int(header.get("NDims", "3"))
        dim_size = tuple(int(v) for v in header["DimSize"].split())
    except ValueError as e:
        raise ValueError(f"{path}: unparsable NDims/DimSize: {e}") from None
    if len(dim_size) != ndims:
        raise ValueError(f"{path}: DimSize {dim_size} does not match NDims {ndims}")
    met = header.get("ElementType", "MET_UCHAR")
    # multi-channel files may spell the type MET_<T>_ARRAY (MetaIO's array
    # form); the element layout is identical
    met_base = met[: -len("_ARRAY")] if met.endswith("_ARRAY") else met
    if met_base not in _MET_TO_DTYPE:
        raise ValueError(f"{path}: ElementType {met!r} unsupported")
    dtype = np.dtype(_MET_TO_DTYPE[met_base])
    n_channels = int(header.get("ElementNumberOfChannels", "1"))

    byte_order_msb = header.get("BinaryDataByteOrderMSB", header.get("ElementByteOrderMSB", "False"))
    big_endian = byte_order_msb.strip().lower() == "true"

    n_elems = int(np.prod(dim_size)) * n_channels
    n_bytes = n_elems * dtype.itemsize

    binary = header.get("BinaryData", "True").strip().lower() != "false"
    compressed = header.get("CompressedData", "False").strip().lower() == "true"
    blob = raw[pos:]
    if not binary:
        # ASCII payload: whitespace-separated element values (MetaIO's
        # BinaryData=False mode); byte order / compression don't apply
        try:
            arr = np.array(blob.split(), dtype=dtype)
        except (ValueError, OverflowError) as e:
            # numpy 2.x raises OverflowError (not ValueError) for integer
            # tokens outside the element type's range, e.g. "300" as
            # MET_UCHAR — keep the path-prefixed error contract either way
            raise ValueError(f"{path}: bad ASCII data: {e}") from None
        if arr.size < n_elems:
            raise ValueError(
                f"{path}: ASCII data has {arr.size} values, expected {n_elems}")
        arr = arr[:n_elems]
    else:
        if compressed:
            declared = header.get("CompressedDataSize")
            if declared is not None:
                try:
                    declared = int(declared)
                except ValueError:
                    raise ValueError(
                        f"{path}: unparsable CompressedDataSize "
                        f"{declared!r}") from None
                if declared > len(blob):
                    raise ValueError(
                        f"{path}: CompressedDataSize {declared} exceeds the "
                        f"{len(blob)} bytes present (truncated file?)")
                blob = blob[:declared]
            try:
                data = _inflate(blob, n_bytes)
            except zlib.error as e:
                raise ValueError(f"{path}: corrupt zlib stream: {e}") from None
            # ITK may write multiple zlib streams for >4GB data; not needed here.
            if len(data) < n_bytes:
                raise ValueError(f"{path}: decompressed {len(data)} < expected {n_bytes} bytes")
            data = data[:n_bytes]
        else:
            if len(blob) < n_bytes:
                raise ValueError(f"{path}: data blob {len(blob)} < expected {n_bytes} bytes")
            data = blob[:n_bytes]

        arr = np.frombuffer(data, dtype=dtype, count=n_elems)
        if big_endian:
            arr = arr.byteswap().view(arr.dtype.newbyteorder("="))
    # MetaIO stores x fastest → numpy shape is reversed DimSize.
    shape = tuple(reversed(dim_size))
    if n_channels > 1:
        shape = shape + (n_channels,)
    arr = arr.reshape(shape).copy()

    spacing = header.get("ElementSpacing", header.get("ElementSize"))
    spacing_t = tuple(float(v) for v in spacing.split()) if spacing else (1.0,) * ndims
    offset = header.get("Offset", header.get("Position", header.get("Origin")))
    offset_t = tuple(float(v) for v in offset.split()) if offset else (0.0,) * ndims
    transform = header.get("TransformMatrix", header.get("Rotation", header.get("Orientation")))
    transform_a = (
        np.array([float(v) for v in transform.split()], dtype=np.float64)
        if transform else None
    )

    known = {
        "ObjectType", "NDims", "DimSize", "ElementType", "ElementSpacing",
        "ElementSize", "Offset", "Position", "Origin", "TransformMatrix",
        "Rotation", "Orientation", "CompressedData", "CompressedDataSize",
        "ElementDataFile", "BinaryData", "BinaryDataByteOrderMSB",
        "ElementByteOrderMSB", "ElementNumberOfChannels", "HeaderSize",
        "AnatomicalOrientation", "CenterOfRotation",
    }
    extra = {k: v for k, v in header.items() if k not in known}

    return MetaImage(array=arr, spacing=spacing_t, offset=offset_t,
                     transform=transform_a, extra_keys=extra)


def write_mha(path, image: MetaImage, compressed: bool = True,
              compression_level: int = 6) -> None:
    """Write a .mha file (LOCAL data).

    Explicit element type, spacing, optional zlib compression.
    """
    arr = np.ascontiguousarray(image.array)
    ndims = arr.ndim
    dtype = arr.dtype
    if dtype not in _DTYPE_TO_MET:
        raise ValueError(f"dtype {dtype} unsupported for MetaImage")

    dim_size = " ".join(str(s) for s in reversed(arr.shape))
    spacing = image.spacing if len(image.spacing) == ndims else (1.0,) * ndims
    offset = image.offset if len(image.offset) == ndims else (0.0,) * ndims
    if image.transform is not None and image.transform.size == ndims * ndims:
        transform = image.transform
    else:
        transform = np.eye(ndims, dtype=np.float64).ravel()

    lines = [
        "ObjectType = Image",
        f"NDims = {ndims}",
        "BinaryData = True",
        "BinaryDataByteOrderMSB = False",
        f"CompressedData = {'True' if compressed else 'False'}",
    ]
    payload = None
    if compressed:
        payload = _deflate(arr.tobytes(), compression_level)
        lines.append(f"CompressedDataSize = {len(payload)}")
    lines += [
        "TransformMatrix = " + " ".join(_fmt(v) for v in transform),
        "Offset = " + " ".join(_fmt(v) for v in offset),
        "CenterOfRotation = " + " ".join(_fmt(0.0) for _ in range(ndims)),
        "ElementSpacing = " + " ".join(_fmt(v) for v in spacing),
        f"DimSize = {dim_size}",
        f"ElementType = {_DTYPE_TO_MET[dtype]}",
        "ElementDataFile = LOCAL",
    ]
    for k, v in image.extra_keys.items():
        lines.insert(-1, f"{k} = {v}")

    header = ("\n".join(lines) + "\n").encode("ascii")
    with open(path, "wb") as f:
        f.write(header)
        if payload is not None:
            f.write(payload)
        else:
            # stream the array's own buffer instead of copying it
            arr.tofile(f)


def _fmt(v: float) -> str:
    s = f"{float(v):.10g}"
    return s


def _inflate(blob: bytes, n_bytes: int) -> bytes:
    return zlib.decompress(blob, bufsize=max(n_bytes, 1))


def _deflate(data: bytes, level: int) -> bytes:
    return zlib.compress(data, level)
