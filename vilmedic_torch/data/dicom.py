"""DICOM reader for single-frame images (port of ``data/dicom.py``: a
struct parser, no pydicom).

Part-10 files in implicit VR little endian, explicit VR little or big
endian, and the compressed transfer syntaxes real archives ship: JPEG
Lossless SOF3 (``...4.57`` / ``...4.70``, the MIMIC-CXR encoding) and RLE
Lossless (``...5``) through the port's native codecs
(:mod:`.dicom_codecs`), JPEG Baseline / Extended / 2000 through Pillow,
imported inside that one function. Undefined-length sequences are
skipped; encapsulated pixel data is a Basic Offset Table, then fragments
that concatenate (one frame). MONOCHROME1/2, signed
``PixelRepresentation``, rescale slope / intercept and linear windowing
(WindowCenter / WindowWidth) follow pydicom's ``apply_voi_lut``.
:func:`dicom_to_uint8` is the reference's ``(max(img, 0) / img.max()) *
255`` uint8 pipeline, bitwise the JAX package's.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np

_EXPLICIT_LONG_VRS = {b"OB", b"OW", b"OF", b"SQ", b"UT", b"UN", b"OD", b"OL", b"UC", b"UR"}

IMPLICIT_LE = "1.2.840.10008.1.2"
EXPLICIT_LE = "1.2.840.10008.1.2.1"
EXPLICIT_BE = "1.2.840.10008.1.2.2"
JPEG_BASELINE = "1.2.840.10008.1.2.4.50"
JPEG_EXTENDED = "1.2.840.10008.1.2.4.51"
JPEG_LOSSLESS_57 = "1.2.840.10008.1.2.4.57"
JPEG_LOSSLESS_70 = "1.2.840.10008.1.2.4.70"
JPEG2000_LOSSLESS = "1.2.840.10008.1.2.4.90"
JPEG2000 = "1.2.840.10008.1.2.4.91"
RLE_LOSSLESS = "1.2.840.10008.1.2.5"
ENCAPSULATED = {JPEG_BASELINE, JPEG_EXTENDED, JPEG_LOSSLESS_57, JPEG_LOSSLESS_70,
                JPEG2000_LOSSLESS, JPEG2000, RLE_LOSSLESS}

# (group, element) tags we care about
TAG_TRANSFER_SYNTAX = (0x0002, 0x0010)
TAG_ROWS = (0x0028, 0x0010)
TAG_COLS = (0x0028, 0x0011)
TAG_BITS_ALLOCATED = (0x0028, 0x0100)
TAG_PIXEL_REPRESENTATION = (0x0028, 0x0103)
TAG_PHOTOMETRIC = (0x0028, 0x0004)
TAG_SAMPLES_PER_PIXEL = (0x0028, 0x0002)
TAG_WINDOW_CENTER = (0x0028, 0x1050)
TAG_WINDOW_WIDTH = (0x0028, 0x1051)
TAG_RESCALE_INTERCEPT = (0x0028, 0x1052)
TAG_RESCALE_SLOPE = (0x0028, 0x1053)
TAG_PIXEL_DATA = (0x7FE0, 0x0010)


class DicomError(ValueError):
    pass


def _read_elements(buf: bytes, offset: int, explicit: bool, little: bool,
                   stop_group: Optional[int] = None):
    """Yield (tag, vr, value_bytes, next_offset)."""
    endian = "<" if little else ">"
    n = len(buf)
    while offset + 8 <= n:
        group, elem = struct.unpack_from(endian + "HH", buf, offset)
        if stop_group is not None and group != stop_group:
            return
        offset += 4
        if explicit:
            vr = buf[offset: offset + 2]
            if vr in _EXPLICIT_LONG_VRS:
                length = struct.unpack_from(endian + "I", buf, offset + 4)[0]
                offset += 8
            else:
                length = struct.unpack_from(endian + "H", buf, offset + 2)[0]
                offset += 4
        else:
            vr = b"UN"
            length = struct.unpack_from(endian + "I", buf, offset)[0]
            offset += 4
        if length == 0xFFFFFFFF:
            if (group, elem) == TAG_PIXEL_DATA:
                # encapsulated pixel data: caller parses the fragment items
                yield (group, elem), vr, None, offset
                return
            # undefined-length sequence: skip to its delimitation item
            offset = _skip_undefined_sequence(buf, offset, explicit, endian)
            continue
        value = buf[offset: offset + length]
        offset += length
        yield (group, elem), vr, value, offset


def _skip_undefined_sequence(buf: bytes, offset: int, explicit: bool,
                             endian: str) -> int:
    """Skip an undefined-length SQ: walk (FFFE,E000) items (parsing their
    contents with the file's VR convention, recursing into nested undefined
    sequences) until the (FFFE,E0DD) sequence delimiter."""
    n = len(buf)
    while offset + 8 <= n:
        group, elem = struct.unpack_from(endian + "HH", buf, offset)
        length = struct.unpack_from(endian + "I", buf, offset + 4)[0]
        offset += 8
        if (group, elem) == (0xFFFE, 0xE0DD):
            return offset
        if (group, elem) != (0xFFFE, 0xE000):
            return n  # malformed; bail to the end
        if length == 0xFFFFFFFF:
            offset = _skip_item_elements(buf, offset, explicit, endian)
        else:
            offset += length
    return offset


def _skip_item_elements(buf: bytes, offset: int, explicit: bool,
                        endian: str) -> int:
    """Skip the elements of an undefined-length item until (FFFE,E00D)."""
    n = len(buf)
    while offset + 8 <= n:
        group, elem = struct.unpack_from(endian + "HH", buf, offset)
        if (group, elem) == (0xFFFE, 0xE00D):
            return offset + 8
        offset += 4
        if explicit:
            vr = buf[offset: offset + 2]
            if vr in _EXPLICIT_LONG_VRS:
                length = struct.unpack_from(endian + "I", buf, offset + 4)[0]
                offset += 8
            else:
                length = struct.unpack_from(endian + "H", buf, offset + 2)[0]
                offset += 4
        else:
            length = struct.unpack_from(endian + "I", buf, offset)[0]
            offset += 4
        if length == 0xFFFFFFFF:  # nested undefined SQ
            offset = _skip_undefined_sequence(buf, offset, explicit, endian)
        else:
            offset += length
    return offset


def _parse_fragments(buf: bytes, offset: int, endian: str):
    """Encapsulated PixelData items -> (fragments list, next offset). The first
    item is the Basic Offset Table (possibly empty)."""
    n = len(buf)
    fragments = []
    first = True
    while offset + 8 <= n:
        group, elem = struct.unpack_from(endian + "HH", buf, offset)
        length = struct.unpack_from(endian + "I", buf, offset + 4)[0]
        offset += 8
        if (group, elem) == (0xFFFE, 0xE0DD):
            break
        if (group, elem) != (0xFFFE, 0xE000):
            raise DicomError("malformed encapsulated pixel data")
        item = buf[offset: offset + length]
        offset += length
        if first:
            first = False  # Basic Offset Table — ignored (single frame)
            continue
        fragments.append(item)
    return fragments, offset


def _decode_encapsulated(fragments, transfer_syntax: str, attrs: Dict[str, Any],
                         little: bool) -> "np.ndarray":
    data = b"".join(fragments)  # single-frame: fragments concatenate
    if transfer_syntax in (JPEG_LOSSLESS_57, JPEG_LOSSLESS_70):
        from .dicom_codecs import decode_jpeg_lossless

        arr, _prec = decode_jpeg_lossless(data)
        if attrs.get("BitsAllocated", 16) == 8:
            arr = arr.astype(np.uint8)
        if attrs.get("PixelRepresentation") == 1:
            arr = arr.astype(np.int16)
        return arr
    if transfer_syntax == RLE_LOSSLESS:
        from .dicom_codecs import decode_rle_segment

        rows, cols = attrs["Rows"], attrs["Columns"]
        nseg = struct.unpack_from("<I", data, 0)[0]
        offsets = struct.unpack_from("<15I", data, 4)
        plane = rows * cols
        segs = []
        for i in range(nseg):
            start = offsets[i]
            end = offsets[i + 1] if i + 1 < nseg and offsets[i + 1] else len(data)
            segs.append(decode_rle_segment(data[start:end], plane))
        bits = attrs.get("BitsAllocated", 16)
        spp = attrs.get("SamplesPerPixel", 1)
        if bits == 8:
            arr = np.stack(segs, axis=-1) if spp > 1 else segs[0]
            arr = arr.reshape((rows, cols) if spp == 1 else (rows, cols, spp))
            return arr
        # 16-bit: per sample, segment pairs are (MSB, LSB)
        out = (segs[0].astype(np.uint16) << 8) | segs[1].astype(np.uint16)
        if attrs.get("PixelRepresentation") == 1:
            out = out.astype(np.int16)
        return out.reshape(rows, cols)
    # JPEG baseline / extended / 2000 -> Pillow
    import io

    from PIL import Image

    try:
        img = Image.open(io.BytesIO(data))
        return np.asarray(img)
    except Exception as e:
        raise DicomError(
            f"transfer syntax {transfer_syntax} not decodable by Pillow: {e}"
        )


def _decode_str(value: bytes) -> str:
    return value.decode("ascii", errors="ignore").strip("\x00 ").strip()


def _first_float(value: bytes) -> Optional[float]:
    s = _decode_str(value)
    if not s:
        return None
    return float(s.split("\\")[0])


def read_dicom(path: str) -> Tuple[np.ndarray, Dict[str, Any]]:
    """Read a DICOM file, returning (pixel_array, attrs)."""
    with open(path, "rb") as f:
        buf = f.read()

    if len(buf) < 132 or buf[128:132] != b"DICM":
        raise DicomError(f"{path}: not a Part-10 DICOM file")

    # File meta group (0002) is always explicit VR little endian.
    transfer_syntax = EXPLICIT_LE
    offset = 132
    for tag, _vr, value, offset in _read_elements(buf, offset, True, True, stop_group=0x0002):
        if tag == TAG_TRANSFER_SYNTAX:
            transfer_syntax = _decode_str(value)

    encapsulated = transfer_syntax in ENCAPSULATED
    if transfer_syntax == IMPLICIT_LE:
        explicit, little = False, True
    elif transfer_syntax == EXPLICIT_BE:
        explicit, little = True, False
    elif transfer_syntax == EXPLICIT_LE or encapsulated:
        explicit, little = True, True  # encapsulated syntaxes are explicit LE
    else:
        raise DicomError(f"{path}: transfer syntax {transfer_syntax} not supported")

    attrs: Dict[str, Any] = {"SamplesPerPixel": 1, "PixelRepresentation": 0, "BitsAllocated": 16}
    pixel_bytes = None
    for tag, _vr, value, offset in _read_elements(buf, offset, explicit, little):
        if tag == TAG_ROWS:
            attrs["Rows"] = struct.unpack(("<" if little else ">") + "H", value[:2])[0]
        elif tag == TAG_COLS:
            attrs["Columns"] = struct.unpack(("<" if little else ">") + "H", value[:2])[0]
        elif tag == TAG_BITS_ALLOCATED:
            attrs["BitsAllocated"] = struct.unpack(("<" if little else ">") + "H", value[:2])[0]
        elif tag == TAG_PIXEL_REPRESENTATION:
            attrs["PixelRepresentation"] = struct.unpack(("<" if little else ">") + "H",
                                                         value[:2])[0]
        elif tag == TAG_SAMPLES_PER_PIXEL:
            attrs["SamplesPerPixel"] = struct.unpack(("<" if little else ">") + "H", value[:2])[0]
        elif tag == TAG_PHOTOMETRIC:
            attrs["PhotometricInterpretation"] = _decode_str(value)
        elif tag == TAG_WINDOW_CENTER:
            attrs["WindowCenter"] = _first_float(value)
        elif tag == TAG_WINDOW_WIDTH:
            attrs["WindowWidth"] = _first_float(value)
        elif tag == TAG_RESCALE_INTERCEPT:
            attrs["RescaleIntercept"] = _first_float(value)
        elif tag == TAG_RESCALE_SLOPE:
            attrs["RescaleSlope"] = _first_float(value)
        elif tag == TAG_PIXEL_DATA:
            if value is None:  # undefined length -> encapsulated fragments
                fragments, _ = _parse_fragments(
                    buf, offset, "<" if little else ">"
                )
                arr = _decode_encapsulated(fragments, transfer_syntax, attrs, little)
                return np.ascontiguousarray(arr), attrs
            pixel_bytes = value
            break

    if pixel_bytes is None or "Rows" not in attrs or "Columns" not in attrs:
        raise DicomError(f"{path}: missing PixelData or dimensions")

    bits = attrs["BitsAllocated"]
    signed = attrs["PixelRepresentation"] == 1
    if bits == 8:
        dtype = np.int8 if signed else np.uint8
    elif bits == 16:
        dtype = np.int16 if signed else np.uint16
    else:
        raise DicomError(f"{path}: BitsAllocated={bits} not supported")
    dtype = np.dtype(dtype).newbyteorder("<" if little else ">")

    count = attrs["Rows"] * attrs["Columns"] * attrs["SamplesPerPixel"]
    arr = np.frombuffer(pixel_bytes, dtype=dtype, count=count)
    if attrs["SamplesPerPixel"] == 1:
        arr = arr.reshape(attrs["Rows"], attrs["Columns"])
    else:
        arr = arr.reshape(attrs["Rows"], attrs["Columns"], attrs["SamplesPerPixel"])
    return np.ascontiguousarray(arr), attrs


def apply_windowing(img: np.ndarray, attrs: Dict[str, Any]) -> np.ndarray:
    """Linear VOI windowing (pydicom ``apply_voi_lut`` WINDOW semantics)."""
    img = img.astype(np.float64)
    slope = attrs.get("RescaleSlope") or 1.0
    intercept = attrs.get("RescaleIntercept") or 0.0
    img = img * slope + intercept

    center, width = attrs.get("WindowCenter"), attrs.get("WindowWidth")
    if center is not None and width is not None and width > 1:
        lo = center - 0.5 - (width - 1) / 2
        hi = center - 0.5 + (width - 1) / 2
        img = np.clip(img, lo, hi)

    if attrs.get("PhotometricInterpretation") == "MONOCHROME1":
        img = img.max() - img
    return img


def dicom_to_uint8(path: str) -> np.ndarray:
    """Full reference-parity pipeline: read, window, then
    ``(max(img,0)/img.max())*255`` -> uint8 (reference ImageDataset.py:126-134)."""
    arr, attrs = read_dicom(path)
    img = apply_windowing(arr, attrs) if attrs.get("WindowWidth") else arr.astype(np.float64)
    mx = img.max()
    if mx <= 0:
        return np.zeros_like(img, dtype=np.uint8)
    img = (np.maximum(img, 0) / mx) * 255.0
    return img.astype(np.uint8)
