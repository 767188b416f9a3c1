"""TFRecord IO without TensorFlow.

Reference capability: python/ray/data/read_api.py read_tfrecord /
datasource/tfrecords_datasource.py (which imports TF or pyarrow's
codec). Neither ships in this image, and neither is needed: a TFRecord
file is length-prefixed framing (u64 length + masked-crc32c of the
length + payload + masked-crc32c of the payload), and the payloads are
``tf.train.Example`` protos — three nested messages over five wire
types. Both are implemented here directly, so TFRecord datasets written
by TF pipelines read straight into Dataset blocks and vice versa.

Feature mapping per Example (column-oriented on the block side):
int64_list -> np.int64, float_list -> np.float32, bytes_list -> object
(bytes). Single-element lists flatten to scalars; multi-element lists
stay as per-row arrays (object column).
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Iterator, List

import numpy as np

# --- crc32c (Castagnoli), table-driven; masked per the TFRecord spec --

_POLY = 0x82F63B78
_T = [[0] * 256 for _ in range(8)]
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _T[0][_i] = _c
for _i in range(256):
    _c = _T[0][_i]
    for _k in range(1, 8):
        _c = _T[0][_c & 0xFF] ^ (_c >> 8)
        _T[_k][_i] = _c

try:                      # native wheel when the environment has one
    import crc32c as _crc32c_native
except ImportError:
    _crc32c_native = None


def _crc32c(data: bytes) -> int:
    if _crc32c_native is not None:
        return _crc32c_native.crc32c(data)
    # slice-by-8: one loop iteration per 8 bytes instead of per byte —
    # a per-byte pure-python CRC otherwise dominates TFRecord IO
    crc = 0xFFFFFFFF
    t0, t1, t2, t3, t4, t5, t6, t7 = _T
    n8 = len(data) - (len(data) % 8)
    i = 0
    while i < n8:
        crc ^= int.from_bytes(data[i:i + 4], "little")
        hi = int.from_bytes(data[i + 4:i + 8], "little")
        crc = (t7[crc & 0xFF] ^ t6[(crc >> 8) & 0xFF]
               ^ t5[(crc >> 16) & 0xFF] ^ t4[(crc >> 24) & 0xFF]
               ^ t3[hi & 0xFF] ^ t2[(hi >> 8) & 0xFF]
               ^ t1[(hi >> 16) & 0xFF] ^ t0[(hi >> 24) & 0xFF])
        i += 8
    for b in data[n8:]:
        crc = t0[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- protobuf wire helpers -------------------------------------------

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


def _read_varint(buf: memoryview, off: int):
    shift = n = 0
    while True:
        b = buf[off]
        off += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, off
        shift += 7


def _ld(field: int, payload: bytes) -> bytes:
    """length-delimited field"""
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def _fields(buf: memoryview) -> Iterator[tuple]:
    """(field_number, wire_type, value) over one message."""
    off = 0
    while off < len(buf):
        key, off = _read_varint(buf, off)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, off = _read_varint(buf, off)
        elif wt == 2:
            ln, off = _read_varint(buf, off)
            v = buf[off:off + ln]
            off += ln
        elif wt == 5:
            v = bytes(buf[off:off + 4])
            off += 4
        elif wt == 1:
            v = bytes(buf[off:off + 8])
            off += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


# --- tf.train.Example ------------------------------------------------

def encode_example(row: Dict[str, Any]) -> bytes:
    feats = bytearray()
    for name, value in row.items():
        if isinstance(value, np.ndarray) and value.ndim == 0:
            value = value.item()
        values = value if isinstance(value, (list, tuple, np.ndarray)) \
            else [value]
        if len(values):
            first = values[0]
        elif isinstance(value, np.ndarray):
            # EMPTY array: keep the feature KIND from the dtype so a
            # fixed-schema TF parser downstream doesn't see a kind flip
            first = (b"" if value.dtype.kind in "SUO"
                     else 0.0 if value.dtype.kind == "f" else 0)
        else:
            first = 0    # empty plain list: int64_list by convention
        if isinstance(first, (bytes, str)):
            payload = b"".join(
                _ld(1, v.encode() if isinstance(v, str) else bytes(v))
                for v in values)
            feature = _ld(1, payload)                 # bytes_list
        elif isinstance(first, (float, np.floating)):
            packed = struct.pack(f"<{len(values)}f",
                                 *[float(v) for v in values])
            feature = _ld(2, _ld(1, packed))          # float_list
        else:
            packed = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF)
                              for v in values)
            feature = _ld(3, _ld(1, packed))          # int64_list
        entry = _ld(1, name.encode()) + _ld(2, feature)
        feats += _ld(1, entry)                        # map entry
    return _ld(1, bytes(feats))                       # Example.features


def decode_example(data) -> Dict[str, Any]:
    row: Dict[str, Any] = {}
    for f, _wt, features in _fields(memoryview(data)):
        if f != 1:
            continue
        for f2, _w2, entry in _fields(features):
            if f2 != 1:
                continue
            name, feature = None, None
            for f3, _w3, v3 in _fields(entry):
                if f3 == 1:
                    name = bytes(v3).decode()
                elif f3 == 2:
                    feature = v3
            if name is None or feature is None:
                continue
            row[name] = _decode_feature(feature)
    return row


def _decode_feature(feature: memoryview):
    for kind, _wt, body in _fields(feature):
        if kind == 1:      # bytes_list
            return [bytes(v) for f, _w, v in _fields(body) if f == 1]
        if kind == 2:      # float_list (packed or repeated)
            vals: List[float] = []
            for f, wt, v in _fields(body):
                if f != 1:
                    continue
                if wt == 2:
                    vals += list(np.frombuffer(v, "<f4"))
                else:
                    vals.append(struct.unpack("<f", v)[0])
            return vals
        if kind == 3:      # int64_list (packed or repeated)
            vals = []
            for f, wt, v in _fields(body):
                if f != 1:
                    continue
                if wt == 2:
                    off = 0
                    while off < len(v):
                        n, off = _read_varint(v, off)
                        if n >= 1 << 63:
                            n -= 1 << 64
                        vals.append(n)
                else:
                    if v >= 1 << 63:
                        v -= 1 << 64
                    vals.append(v)
            return vals
    return []


# --- record framing ---------------------------------------------------

def read_records(path: str, *, verify_crc: bool = True
                 ) -> Iterator[bytes]:
    with open(path, "rb") as f:
        while True:
            hdr = f.read(12)
            if len(hdr) < 12:
                return
            (n,) = struct.unpack("<Q", hdr[:8])
            if verify_crc:
                (crc,) = struct.unpack("<I", hdr[8:])
                if _masked_crc(hdr[:8]) != crc:
                    raise ValueError(f"{path}: corrupt length crc")
            data = f.read(n)
            if len(data) < n:
                raise ValueError(f"{path}: truncated record")
            trailer = f.read(4)
            if len(trailer) < 4:
                raise ValueError(f"{path}: truncated record trailer")
            (dcrc,) = struct.unpack("<I", trailer)
            if verify_crc and _masked_crc(data) != dcrc:
                raise ValueError(f"{path}: corrupt data crc")
            yield data


def write_records(path: str, records: Iterator[bytes]) -> int:
    n = 0
    with open(path, "wb") as f:
        for rec in records:
            hdr = struct.pack("<Q", len(rec))
            f.write(hdr)
            f.write(struct.pack("<I", _masked_crc(hdr)))
            f.write(rec)
            f.write(struct.pack("<I", _masked_crc(rec)))
            n += 1
    return n


# --- row <-> column glue ----------------------------------------------

def rows_to_block(rows: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Decoded example rows -> a column block. A column whose every
    row has EXACTLY one value flattens to a typed scalar column;
    variable-length (or partially-missing) features — the normal case
    in TF datasets — stay an object column of per-row typed arrays."""
    cols: Dict[str, list] = {}
    for r in rows:
        for k in r:
            cols.setdefault(k, [])
    for r in rows:
        for k, vals in cols.items():
            vals.append(list(r.get(k, [])))
    out = {}
    for k, vals in cols.items():
        sample = next((v[0] for v in vals if v), None)
        if sample is None:
            out[k] = np.array([None] * len(vals), dtype=object)
            continue
        if isinstance(sample, (float, np.floating)):
            dt = np.float32
        elif isinstance(sample, bytes):
            dt = None
        else:
            dt = np.int64
        if all(len(v) == 1 for v in vals):
            flat = [v[0] for v in vals]
            out[k] = np.array(flat, dtype=object) if dt is None \
                else np.asarray(flat, dtype=dt)
        elif dt is None:
            out[k] = np.array(vals, dtype=object)
        else:
            col = np.empty(len(vals), dtype=object)
            for i, v in enumerate(vals):
                col[i] = np.asarray(v, dtype=dt)
            out[k] = col
    return out
