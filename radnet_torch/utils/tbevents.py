"""TensorBoard event files without TensorFlow.

The reference streams training scalars to TensorBoard: ``write_log``
builds ``tf.Summary`` protos and hands them to the ``TensorBoard``
callback's writer (train.py:72-79, 258-260, 408-424, 607-630;
cont_train.py:60-67).  This environment ships no TensorFlow, so earlier
rounds replaced the event stream with ``metrics.jsonl`` + an HTML
dashboard.  That replacement stays, but the deviation itself is closed
here: scalar TensorBoard *event files* need only three tiny protobuf
messages (``Event``, ``Summary``, ``Summary.Value`` carrying
``simple_value``) and TFRecord framing (length + masked CRC32C), all of
which this module hand-encodes with zero dependencies.  Files written by
:class:`EventWriter` load in stock TensorBoard (verified in
``tests/test_tbevents.py`` against ``tensorboard``'s own
``event_file_loader``).

Wire format notes (kept exactly to TF's conventions):

* TFRecord framing per record: ``uint64le length`` + ``uint32le
  masked_crc32c(length_bytes)`` + ``payload`` + ``uint32le
  masked_crc32c(payload)``.
* CRC32C is the Castagnoli polynomial (reflected ``0x82F63B78``); the
  mask is ``((crc >> 15) | (crc << 17)) + 0xa282ead8 (mod 2**32)``.
* ``Event`` proto fields: 1 ``wall_time`` (double), 2 ``step`` (int64),
  3 ``file_version`` (string), 5 ``summary`` (message).  ``Summary``
  field 1 is repeated ``Value``; ``Value`` field 1 is ``tag`` (string),
  field 2 ``simple_value`` (float).
* The first record of every file is the version sentinel event
  ``file_version="brain.Event:2"``.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time

# --------------------------------------------------------------------------- #
# CRC32C (Castagnoli), table-driven, pure Python.
# --------------------------------------------------------------------------- #

_CRC_TABLE = []
for _i in range(256):
    _crc = _i
    for _ in range(8):
        _crc = (_crc >> 1) ^ (0x82F63B78 if _crc & 1 else 0)
    _CRC_TABLE.append(_crc)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------------------------- #
# Minimal protobuf wire encoding.
# --------------------------------------------------------------------------- #


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


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _int64(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value & 0xFFFFFFFFFFFFFFFF)


def _bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _summary_value(tag: str, value: float) -> bytes:
    return _bytes(1, tag.encode("utf-8")) + _float(2, float(value))


def scalar_event(step: int, scalars: dict[str, float], wall_time: float) -> bytes:
    """Serialized ``Event`` proto carrying one ``Summary`` with one
    ``simple_value`` per tag (the shape write_log emits, train.py:72-79)."""
    summary = b"".join(
        _bytes(1, _summary_value(t, v)) for t, v in scalars.items()
    )
    return _double(1, wall_time) + _int64(2, int(step)) + _bytes(5, summary)


def version_event(wall_time: float) -> bytes:
    return _double(1, wall_time) + _bytes(3, b"brain.Event:2")


def frame_record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", masked_crc32c(header))
        + payload
        + struct.pack("<I", masked_crc32c(payload))
    )


# --------------------------------------------------------------------------- #
# Writer.
# --------------------------------------------------------------------------- #


class EventWriter:
    """Append-only scalar event writer, TensorBoard-compatible.

    Creates ``events.out.tfevents.<time>.<hostname>`` inside ``logdir``
    (the glob TensorBoard discovers runs by) and leads with the
    ``brain.Event:2`` version record, like ``tf.summary.FileWriter``.
    Thread-safe; writes are flushed per call (the reference flushes per
    summary too, train.py:79).
    """

    def __init__(self, logdir: str) -> None:
        os.makedirs(logdir, exist_ok=True)
        now = time.time()
        host = socket.gethostname() or "localhost"
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{now:.6f}.{host}"
        )
        self._lock = threading.Lock()
        self._file = open(self.path, "ab")
        self._file.write(frame_record(version_event(now)))
        self._file.flush()

    def add_scalars(
        self, step: int, scalars: dict[str, float], wall_time: float | None = None
    ) -> None:
        if not scalars:
            return
        payload = scalar_event(
            step,
            scalars,
            time.time() if wall_time is None else wall_time,
        )
        with self._lock:
            if self._file.closed:
                return
            self._file.write(frame_record(payload))
            self._file.flush()

    def close(self) -> None:
        with self._lock:
            if not self._file.closed:
                self._file.close()
