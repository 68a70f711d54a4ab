"""Minimal TensorBoard-compatible scalar writer (a copy of
``ml_recipe_tpu/train/writer.py``) — pure Python, no TF.

Parity target: reference trainer.py:183-192,215-219 (rank-0-only
``SummaryWriter`` whose dir is wiped per experiment, ``add_scalar`` per loss
head and LR each optimizer step).

Writes standard TFRecord event files (``events.out.tfevents.*``) readable by
TensorBoard: each record is
``[len u64][masked_crc32c(len) u32][payload][masked_crc32c(payload) u32]``
and the payload is a hand-encoded ``tensorflow.Event`` protobuf
(wall_time=1:double, step=2:int64, summary=5 with repeated Value{tag=1,
simple_value=2}). Hand-encoding avoids a protobuf dependency for the three
fields we need.
"""

from __future__ import annotations

import os
import shutil
import socket
import struct
import time
from typing import Optional

_CRC_TABLE = None


def _crc32c_table():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
            table.append(crc)
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc32c_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(value: int) -> bytes:
    out = bytearray()
    value &= (1 << 64) - 1
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _encode_event(wall_time: float, step: int, scalars: Optional[dict] = None,
                  file_version: Optional[str] = None) -> bytes:
    event = bytearray()
    event += _tag(1, 1) + struct.pack("<d", wall_time)  # wall_time: double
    if step:
        event += _tag(2, 0) + _varint(step)  # step: int64
    if file_version is not None:
        fv = file_version.encode()
        event += _tag(3, 2) + _varint(len(fv)) + fv
    if scalars:
        summary = bytearray()
        for name, value in scalars.items():
            tag_bytes = name.encode()
            val = bytearray()
            val += _tag(1, 2) + _varint(len(tag_bytes)) + tag_bytes  # Value.tag
            val += _tag(2, 5) + struct.pack("<f", float(value))  # simple_value
            summary += _tag(1, 2) + _varint(len(val)) + bytes(val)  # Summary.value
        event += _tag(5, 2) + _varint(len(summary)) + bytes(summary)  # Event.summary
    return bytes(event)


def _record(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


class SummaryWriter:
    """Append-only scalar event writer; API subset of torch's SummaryWriter."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        fname = (
            f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}.{os.getpid()}"
        )
        self._path = os.path.join(log_dir, fname)
        self._fh = open(self._path, "ab")
        self._fh.write(_record(_encode_event(time.time(), 0, file_version="brain.Event:2")))
        self._fh.flush()
        self._pending = 0

    def add_scalar(self, tag: str, value, global_step: int = 0) -> None:
        payload = _encode_event(time.time(), int(global_step), {tag: float(value)})
        self._fh.write(_record(payload))
        self._pending += 1
        if self._pending >= 512:  # bound event loss under SIGKILL/preemption
            self._fh.flush()
            self._pending = 0

    def flush(self) -> None:
        self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()


def init_writer(process_is_primary: bool, writer_dir) -> Optional[SummaryWriter]:
    """Primary-process-only writer whose dir is recreated per experiment
    (reference trainer.py:183-192 semantics, including the wipe warning)."""
    if writer_dir is None or not process_is_primary:
        return None
    import logging

    logging.getLogger(__name__).warning(
        f"Directory {writer_dir} will be cleaned before SummaryWriter "
        f"initialization. To prevent losing important information, use "
        f"different experiment names."
    )
    shutil.rmtree(writer_dir, ignore_errors=True)
    return SummaryWriter(log_dir=str(writer_dir))
