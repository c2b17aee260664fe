"""TensorBoard event-file writer and reader, with no TensorBoard import.

The port's own copy of ``vitsom_tpu/utils/tb_writer.py``: TensorBoard's
on-disk format is a sequence of length-prefixed, crc32c-masked protobuf
``Event`` records, and this module hand-encodes the three message shapes
the trainer emits (the file_version header, scalar summaries, PNG image
summaries). For the same scalars, images and wall time its records are
the JAX package's, byte for byte. Where the JAX package encodes the PNG
with PIL, this copy encodes it with ``zlib`` alone (``_encode_png``), with
PIL's own choices, so the bytes are the same; the port imports no PIL.

Record framing (tensorflow/core/lib/io/record_writer.cc):
    uint64 length | uint32 masked_crc32c(length_bytes) | data |
    uint32 masked_crc32c(data)
Proto field numbers (tensorflow/core/util/event.proto, summary.proto):
    Event: wall_time=1 (double), step=2 (int64), file_version=3 (string),
           summary=5 (message)
    Summary: value=1 (repeated message)
    Summary.Value: tag=1 (string), simple_value=2 (float), image=4 (message)
    Summary.Image: height=1, width=2, colorspace=3,
                   encoded_image_string=4 (bytes)
"""

from __future__ import annotations

import os
import socket
import struct
import time
import zlib

import numpy as np

# ---------------------------------------------------------------------------
# crc32c (Castagnoli, table-driven) + TF record masking
# ---------------------------------------------------------------------------

_CRC_TABLES = None


def _crc_tables():
    """[16, 256] slicing tables: TABLES[k][b] = CRC contribution of byte b
    followed by k zero bytes (reflected Castagnoli)."""
    global _CRC_TABLES
    if _CRC_TABLES is None:
        poly = 0x82F63B78  # reversed Castagnoli polynomial
        t = np.empty((16, 256), dtype=np.uint32)
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            t[0, i] = c
        for k in range(1, 16):
            t[k] = t[0][t[k - 1] & 0xFF] ^ (t[k - 1] >> 8)
        _CRC_TABLES = t
    return _CRC_TABLES


def crc32c(data: bytes) -> int:
    """Slicing-by-16 CRC32C: bytes 4..15 of each 16-byte chunk do not
    depend on the running crc, so their table lookups run vectorised in
    numpy and only 4 lookups a chunk stay in the Python loop."""
    t = _crc_tables()
    crc = 0xFFFFFFFF
    arr = np.frombuffer(data, dtype=np.uint8)
    n16 = len(arr) // 16
    if n16:
        chunks = arr[: n16 * 16].reshape(n16, 16)
        indep = np.zeros(n16, dtype=np.uint32)
        for j in range(4, 16):
            indep ^= t[15 - j][chunks[:, j]]
        # .tolist() converts to python ints once (uint32 numpy scalars
        # overflow-warn on the rotate in _masked_crc)
        c0, c1, c2, c3 = (chunks[:, j].tolist() for j in range(4))
        indep_l = indep.tolist()
        t15, t14, t13, t12 = (t[k].tolist() for k in (15, 14, 13, 12))
        for i in range(n16):
            crc = (
                t15[(crc ^ c0[i]) & 0xFF]
                ^ t14[((crc >> 8) ^ c1[i]) & 0xFF]
                ^ t13[((crc >> 16) ^ c2[i]) & 0xFF]
                ^ t12[(crc >> 24) ^ c3[i]]
                ^ indep_l[i]
            )
        arr = arr[n16 * 16:]
    tail_table = t[0].tolist()
    for b in arr.tolist():
        crc = (tail_table[(crc ^ b) & 0xFF] ^ (crc >> 8)) & 0xFFFFFFFF
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# minimal protobuf wire encoding
# ---------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _double_field(field: int, value: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", value)


def _float_field(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", value)


def _int_field(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _bytes_field(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def _string_field(field: int, value: str) -> bytes:
    return _bytes_field(field, value.encode("utf-8"))


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    summary_value = _string_field(1, tag) + _float_field(2, float(value))
    summary = _bytes_field(1, summary_value)
    return (
        _double_field(1, wall_time)
        + _int_field(2, int(step))
        + _bytes_field(5, summary)
    )


def _image_event(
    tag: str, png: bytes, h: int, w: int, colorspace: int, step: int,
    wall_time: float,
) -> bytes:
    image = (
        _int_field(1, h)
        + _int_field(2, w)
        + _int_field(3, colorspace)
        + _bytes_field(4, png)
    )
    summary_value = _string_field(1, tag) + _bytes_field(4, image)
    summary = _bytes_field(1, summary_value)
    return (
        _double_field(1, wall_time)
        + _int_field(2, int(step))
        + _bytes_field(5, summary)
    )


def _file_version_event(wall_time: float) -> bytes:
    return _double_field(1, wall_time) + _string_field(3, "brain.Event:2")


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


class EventFileWriter:
    """Append-only TensorBoard event file (the subset of
    ``torch.utils.tensorboard.SummaryWriter`` the trainer uses)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}.{os.getpid()}.v2"
        )
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._write_record(_file_version_event(time.time()))
        self.flush()

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, global_step: int) -> None:
        self._write_record(_scalar_event(tag, value, global_step, time.time()))

    def add_image(self, tag: str, image, global_step: int, dataformats="HWC"):
        """image: HWC float [0,1] (or HW) numpy array, encoded as PNG."""
        arr = np.asarray(image)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        if dataformats == "CHW":
            arr = np.transpose(arr, (1, 2, 0))
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        h, w, c = arr.shape
        png = _encode_png(arr)
        colorspace = {1: 1, 3: 3, 4: 4}[c]
        self._write_record(
            _image_event(tag, png, h, w, colorspace, global_step, time.time())
        )

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png_filter(arr: np.ndarray) -> bytes:
    """PNG's filtered scanlines of an HWC uint8 array, each row's filter
    chosen as PIL's encoder chooses it: the least sum of |filtered byte|
    (a byte read as signed) among None, then Up, Sub and Paeth in that
    order, a later one only when strictly less (PIL tries Average only when
    asked to optimise)."""
    h, w, c = arr.shape
    cur = arr.reshape(h, w * c).astype(np.int16)
    up = np.zeros_like(cur)
    up[1:] = cur[:-1]
    left = np.zeros_like(cur)
    left[:, c:] = cur[:, :-c]
    upleft = np.zeros_like(cur)
    upleft[:, c:] = up[:, :-c]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    filtered = [(cur - pred).astype(np.uint8) for pred in (0, up, left, paeth)]
    costs = [np.minimum(f, 256 - f.astype(np.int32)).sum(axis=1) for f in filtered]
    kind = np.zeros(h, np.uint8)  # None
    best_cost, best = costs[0], filtered[0]
    for code, f, cost in zip((2, 1, 4), filtered[1:], costs[1:]):
        better = cost < best_cost
        kind = np.where(better, code, kind).astype(np.uint8)
        best_cost = np.where(better, cost, best_cost)
        best = np.where(better[:, None], f, best)
    return np.concatenate([kind[:, None], best], axis=1).tobytes()


def _encode_png(arr: np.ndarray) -> bytes:
    """PNG of an HWC uint8 array (1, 3 or 4 channels), byte for byte what
    PIL's ``Image.save(format="PNG")`` writes: PIL's row filters
    (``_png_filter``), deflate at level 6, memLevel 9, ``Z_FILTERED``, and
    IDAT chunks of max(65536, 4 * width) bytes."""
    h, w, c = arr.shape
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    data = co.compress(_png_filter(arr)) + co.flush()
    color_type = {1: 0, 3: 2, 4: 6}[c]
    block = max(65536, 4 * w)
    return b"".join(
        [b"\x89PNG\r\n\x1a\n",
         _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))]
        + [_png_chunk(b"IDAT", data[i:i + block]) for i in range(0, len(data), block)]
        + [_png_chunk(b"IEND", b"")])


# ---------------------------------------------------------------------------
# reader: parses files this module (or TF/torch) wrote
# ---------------------------------------------------------------------------


def read_records(path: str):
    """The payloads of an event file's records, in order. Validates each
    record's CRCs (so a writer bug can't silently pass a test)."""
    out = []
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        (length,) = struct.unpack_from("<Q", data, off)
        (hcrc,) = struct.unpack_from("<I", data, off + 8)
        if _masked_crc(data[off : off + 8]) != hcrc:
            raise ValueError(f"bad header crc at offset {off}")
        payload = data[off + 12 : off + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, off + 12 + length)
        if _masked_crc(payload) != pcrc:
            raise ValueError(f"bad payload crc at offset {off}")
        out.append(payload)
        off += 12 + length + 4
    return out


def read_scalar_events(path: str):
    """Parse scalar events from an event file -> list of (tag, step, value)."""
    return [(tag, step, value) for payload in read_records(path)
            for tag, step, value in _parse_event(payload) if value is not None]


def read_tags(path: str):
    """Every summary of an event file, scalar or image -> list of (tag, step)."""
    return [(tag, step) for payload in read_records(path)
            for tag, step, _ in _parse_event(payload)]


def _read_varint(buf: bytes, off: int):
    n = shift = 0
    while True:
        b = buf[off]
        off += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, off
        shift += 7


def _parse_fields(buf: bytes):
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        field, wt = key >> 3, key & 7
        if wt == 0:
            val, off = _read_varint(buf, off)
        elif wt == 1:
            val = buf[off : off + 8]
            off += 8
        elif wt == 2:
            ln, off = _read_varint(buf, off)
            val = buf[off : off + ln]
            off += ln
        elif wt == 5:
            val = buf[off : off + 4]
            off += 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, val


def _parse_event(payload: bytes):
    """(tag, step, simple_value, or None for an image) of each summary."""
    step = 0
    rows = []
    for field, wt, val in _parse_fields(payload):
        if field == 2 and wt == 0:
            step = val
        elif field == 5 and wt == 2:  # summary
            for f2, w2, v2 in _parse_fields(val):
                if f2 == 1 and w2 == 2:  # Summary.Value
                    tag, simple, image = None, None, False
                    for f3, w3, v3 in _parse_fields(v2):
                        if f3 == 1 and w3 == 2:
                            tag = v3.decode("utf-8")
                        elif f3 == 2 and w3 == 5:
                            (simple,) = struct.unpack("<f", v3)
                        elif f3 == 4 and w3 == 2:
                            image = True
                    if tag is not None and (simple is not None or image):
                        rows.append((tag, step, simple))
    return rows
