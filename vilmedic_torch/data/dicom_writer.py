"""Writes single-frame Part-10 DICOM files of a 16-bit image (12 bits
stored), for synthetic data: explicit VR little or big endian, implicit VR
little endian, JPEG lossless (SOF3, selection value 1) and RLE lossless,
the last two encapsulated in any number of fragments after an empty or
one-entry Basic Offset Table. MONOCHROME1 / 2, signed pixels, windowing and
rescale elements are optional. The encoders are vectorized in numpy.
:mod:`.dicom` reads every file written here.
"""

from __future__ import annotations

import struct

import numpy as np

from .dicom import EXPLICIT_BE, EXPLICIT_LE, IMPLICIT_LE, JPEG_LOSSLESS_70

_LONG_VRS = (b"OB", b"OW", b"SQ", b"UN", b"UT")


def dicom_element(group: int, elem: int, vr: bytes, value: bytes, implicit=False,
                  big=False) -> bytes:
    """One data element: explicit VR (little or big endian) or implicit VR."""
    e = ">" if big else "<"
    if len(value) % 2:
        value += b" " if vr in (b"CS", b"DS", b"SH", b"LO") else b"\x00"
    head = struct.pack(e + "HH", group, elem)
    if implicit:
        return head + struct.pack(e + "I", len(value)) + value
    if vr in _LONG_VRS:
        return head + vr + b"\x00\x00" + struct.pack(e + "I", len(value)) + value
    return head + vr + struct.pack(e + "H", len(value)) + value


def jpeg_lossless_sv1(img) -> bytes:
    """A JPEG lossless (SOF3, selection value 1: the left neighbour, the one
    above in the first column) codestream of a (H, W) uint16 image at 16 bits
    of precision, with one Huffman table of 17 five-bit codes (category k has
    code k), vectorized."""
    h, w = img.shape
    x = img.astype(np.int64)
    pred = np.empty_like(x)
    pred[:, 1:] = x[:, :-1]
    pred[1:, 0] = x[:-1, 0]
    pred[0, 0] = 1 << 15
    diff = ((x - pred + 32768) % 65536 - 32768).ravel()
    mag = np.abs(diff)
    ssss = np.frexp(mag.astype(np.float64))[1].astype(np.int64)  # bit length, 0 for 0
    extra_len = np.where(ssss == 16, 0, ssss)
    extra = np.where(diff > 0, diff, diff + (1 << ssss) - 1) & ((1 << extra_len) - 1)
    length = 5 + extra_len
    value = (ssss << extra_len) | extra
    chunks = []
    for s in range(0, len(value), 1 << 20):  # 32 bits a sample: bound the memory
        v, n = value[s: s + (1 << 20)], length[s: s + (1 << 20)]
        bits = np.unpackbits(v.astype(">u4").view(np.uint8)).reshape(-1, 32)
        chunks.append(bits[np.arange(32) >= (32 - n)[:, None]])
    bits = np.concatenate(chunks)
    bits = np.concatenate([bits, np.ones((-len(bits)) % 8, np.uint8)])  # pad with 1s
    payload = np.packbits(bits)
    ff = np.flatnonzero(payload == 0xFF)
    payload = np.insert(payload, ff + 1, 0)  # byte stuffing
    dht = bytes([0x00]) + bytes([0, 0, 0, 0, 17] + [0] * 11) + bytes(range(17))
    sof = struct.pack(">BHHB", 16, h, w, 1) + bytes([1, 0x11, 0])
    sos = bytes([1, 1, 0x00, 1, 0, 0x00])
    return (b"\xff\xd8" + b"\xff\xc4" + struct.pack(">H", len(dht) + 2) + dht
            + b"\xff\xc3" + struct.pack(">H", len(sof) + 2) + sof
            + b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos
            + payload.tobytes() + b"\xff\xd9")


def packbits_literal(data) -> bytes:
    """PackBits of literal runs of at most 128 bytes (valid RLE segments,
    DICOM PS3.5 G.3.1), vectorized."""
    data = np.frombuffer(bytes(data), np.uint8)
    full = len(data) // 128
    body = np.concatenate([np.full((full, 1), 127, np.uint8),
                           data[:full * 128].reshape(full, 128)], axis=1).ravel()
    tail = data[full * 128:]
    out = body.tobytes() + (bytes([len(tail) - 1]) + tail.tobytes() if len(tail) else b"")
    return out + (b"\x80" if len(out) % 2 else b"")  # no-op byte to an even length


def rle_frame(img) -> bytes:
    """An RLE Lossless frame of a (H, W) uint16 image: the 64-byte header,
    then the MSB and LSB segments."""
    seg0 = packbits_literal((img >> 8).astype("uint8").tobytes())
    seg1 = packbits_literal((img & 0xFF).astype("uint8").tobytes())
    return (struct.pack("<I", 2) + struct.pack("<15I", 64, 64 + len(seg0), *([0] * 13))
            + seg0 + seg1)


def write_dicom(path: str, pixels, syntax: str, photometric: str = "MONOCHROME2",
                window=None, signed: bool = False, rescale=None, big_endian: bool = False,
                fragments: int = 1, offset_table: bool = False) -> None:
    """A Part-10 file of a (H, W) 16-bit image (12 bits stored) in
    ``syntax``: explicit VR little endian (or big endian with
    ``big_endian``), implicit VR little endian, JPEG lossless SV1 or RLE
    (encapsulated: a Basic Offset Table, empty or with one entry, then the
    codestream in ``fragments`` pieces). ``window`` (center, width) and
    ``rescale`` (slope, intercept) add those elements."""
    rows, cols = pixels.shape
    implicit = syntax == IMPLICIT_LE
    big = big_endian and syntax == EXPLICIT_LE
    ts = EXPLICIT_BE if big else syntax
    meta = dicom_element(0x0002, 0x0010, b"UI", ts.encode() + b"\x00")
    e = ">" if big else "<"

    def el(g, n, vr, value):
        return dicom_element(g, n, vr, value, implicit=implicit, big=big)

    body = el(0x0028, 0x0002, b"US", struct.pack(e + "H", 1))
    body += el(0x0028, 0x0004, b"CS", photometric.encode())
    body += el(0x0028, 0x0010, b"US", struct.pack(e + "H", rows))
    body += el(0x0028, 0x0011, b"US", struct.pack(e + "H", cols))
    body += el(0x0028, 0x0100, b"US", struct.pack(e + "H", 16))
    body += el(0x0028, 0x0101, b"US", struct.pack(e + "H", 12))
    body += el(0x0028, 0x0103, b"US", struct.pack(e + "H", 1 if signed else 0))
    if window is not None:
        body += el(0x0028, 0x1050, b"DS", f"{window[0]}".encode())
        body += el(0x0028, 0x1051, b"DS", f"{window[1]}".encode())
    if rescale is not None:
        body += el(0x0028, 0x1052, b"DS", f"{rescale[1]}".encode())
        body += el(0x0028, 0x1053, b"DS", f"{rescale[0]}".encode())
    dtype = np.dtype(np.int16 if signed else np.uint16).newbyteorder(e)
    if syntax in (EXPLICIT_LE, IMPLICIT_LE):
        body += el(0x7FE0, 0x0010, b"OW", pixels.astype(dtype).tobytes())
    else:
        frame = jpeg_lossless_sv1(pixels) if syntax == JPEG_LOSSLESS_70 else rle_frame(pixels)
        bot = struct.pack("<I", 0) if offset_table else b""
        body += struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\x00\x00" + struct.pack("<I", 0xFFFFFFFF)
        body += struct.pack("<HHI", 0xFFFE, 0xE000, len(bot)) + bot
        step = -(-len(frame) // fragments)
        step += step % 2  # even pieces: only the last one is padded
        for s in range(0, len(frame), step):
            piece = frame[s: s + step]
            piece += b"\x00" * (len(piece) % 2)
            body += struct.pack("<HHI", 0xFFFE, 0xE000, len(piece)) + piece
        body += struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)
