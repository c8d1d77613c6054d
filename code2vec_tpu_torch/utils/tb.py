"""Dependency-free TensorBoard scalar writer.

The port's copy of code2vec_tpu/utils/tb.py (`ScalarWriter` and its
masked CRC32C framing), for `train --tensorboard` (config.use_tensorboard,
written under `config.tensorboard_dir`). The reference's `--tensorboard`
flag attaches a Keras TensorBoard callback (reference: config.py:42-43,
keras_model.py:158-163); with no TensorFlow here the event-file format is
produced directly: a TFRecord stream (length + masked CRC32C framing) of
hand-encoded `Event` protobuf messages containing scalar `Summary`
values. Files written here load in stock TensorBoard. `read_scalars`
decodes such a file back into its (tag, step, value) stream, checking
every record's CRCs (the port's own: the tests and chip_smoke.py read
the trainer's event files with it, no `tensorboard` package needed).

Wire format notes (protobuf encoding, stable since proto2):
  Event:   wall_time=1 (double), step=2 (int64), file_version=3 (string),
           summary=5 (message)
  Summary: value=1 (repeated message); Value: tag=1 (string),
           simple_value=2 (float)
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import List, Optional, Tuple

# ---------------------------------------------------------------- crc32c

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ----------------------------------------------------------- proto encode

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


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int, *, file_version: Optional[str] = None,
           scalar: Optional[tuple] = None) -> bytes:
    msg = bytearray()
    msg += _varint((1 << 3) | 1) + struct.pack("<d", wall_time)
    msg += _varint((2 << 3) | 0) + _varint(step)
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode())
    if scalar is not None:
        tag, value = scalar
        val = (_field_bytes(1, tag.encode())
               + _varint((2 << 3) | 5) + struct.pack("<f", float(value)))
        msg += _field_bytes(5, _field_bytes(1, val))
    return bytes(msg)


class ScalarWriter:
    """Appends scalar events to one `events.out.tfevents.*` file.

    Lifecycle: usable as a context manager; `close()` is idempotent and
    flushes first, so the trainer can close it in a `finally` (a crash or
    the NaN-halt raise must not lose the tail of the event stream) while
    any later defensive close stays harmless."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}")
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab")
        self._write(_event(time.time(), 0, file_version="brain.Event:2"))

    def _write(self, record: bytes) -> None:
        header = struct.pack("<Q", len(record))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(record)
        self._f.write(struct.pack("<I", _masked_crc(record)))

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), int(step), scalar=(tag, value)))

    def flush(self) -> None:
        if not self._f.closed:
            self._f.flush()

    @property
    def closed(self) -> bool:
        return self._f.closed

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self) -> "ScalarWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False


# ----------------------------------------------------------- proto decode

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of one protobuf message: value is
    an int (varint), bytes (length-delimited) or the raw 4/8 bytes."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _read_varint(buf, i)
        elif wire == 1:
            value, i = buf[i:i + 8], i + 8
        elif wire == 2:
            n, i = _read_varint(buf, i)
            value, i = buf[i:i + n], i + n
        elif wire == 5:
            value, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield num, wire, value


def read_scalars(path: str) -> List[Tuple[str, int, float]]:
    """Every scalar event of an event file as (tag, step, value), in file
    order. Raises ValueError on a record whose CRC does not match."""
    with open(path, "rb") as f:
        data = f.read()
    out: List[Tuple[str, int, float]] = []
    i = 0
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        (crc,) = struct.unpack("<I", data[i + 8:i + 12])
        record = data[i + 12:i + 12 + n]
        (rcrc,) = struct.unpack("<I", data[i + 12 + n:i + 16 + n])
        if crc != _masked_crc(header) or rcrc != _masked_crc(record):
            raise ValueError(f"{path}: bad record CRC at byte {i}")
        i += 16 + n
        step = 0
        for num, _wire, value in _fields(record):
            if num == 2:
                step = value
            elif num == 5:
                for _n, _w, val in _fields(value):
                    tag, scalar = None, None
                    for vn, _vw, vv in _fields(val):
                        if vn == 1:
                            tag = vv.decode()
                        elif vn == 2:
                            (scalar,) = struct.unpack("<f", vv)
                    if tag is not None and scalar is not None:
                        out.append((tag, step, scalar))
    return out
