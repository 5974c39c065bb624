"""Chrome-trace timeline writer.

Copied from ``horovod_tpu/utils/timeline.py`` (reference parity:
horovod/common/timeline.h/.cc) — a JSON ``about:tracing`` file with one
row per tensor and spans for each phase of its life.  The reference's
phases are NEGOTIATE → QUEUE → MEMCPY_IN → COMM → MEMCPY_OUT; the port
has no negotiation and no separate fusion-buffer copies, so it writes one
phase per collective: ``COMM``, from the submission until the result is
ready (``ops/collective_ops.py``), plus ``CYCLE`` instants (one per
gradient flush of a training step) under
``HVD_TPU_TIMELINE_MARK_CYCLES``.  The JAX package names the same span
``XLA_COMM``; the port has no XLA and keeps the reference Horovod's own
phase name.  File format is identical, so the same chrome://tracing /
Perfetto workflow applies.

This Python writer is the only one: the JAX package's native core (and
its C++ writer thread) is not ported.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional


class Timeline:
    def __init__(self, filename: str, rank: int = 0):
        self._filename = filename
        self._rank = rank
        self._lock = threading.Lock()
        self._file = open(filename, "w")
        self._file.write("[\n")
        self._first = True
        self._t0 = time.monotonic_ns()
        self._closed = False
        self._emit(
            {
                "name": "process_name",
                "ph": "M",
                "pid": rank,
                "args": {"name": f"hvd_tpu rank {rank}"},
            }
        )

    def _now_us(self) -> float:
        return (time.monotonic_ns() - self._t0) / 1e3

    def _emit(self, event: dict) -> None:
        with self._lock:
            if self._closed:
                return
            if not self._first:
                self._file.write(",\n")
            self._first = False
            json.dump(event, self._file)

    def start(self, tensor_name: str, activity: str) -> None:
        """Reference: Timeline::ActivityStart."""
        self._emit(
            {
                "name": activity,
                "cat": "hvd_tpu",
                "ph": "B",
                "pid": self._rank,
                "tid": hash(tensor_name) % (1 << 31),
                "ts": self._now_us(),
                "args": {"tensor": tensor_name},
            }
        )

    def end(self, tensor_name: str, activity: str) -> None:
        """Reference: Timeline::ActivityEnd."""
        self._emit(
            {
                "name": activity,
                "cat": "hvd_tpu",
                "ph": "E",
                "pid": self._rank,
                "tid": hash(tensor_name) % (1 << 31),
                "ts": self._now_us(),
            }
        )

    def instant(self, name: str) -> None:
        """Reference: Timeline::MarkCycleStart (HOROVOD_TIMELINE_MARK_CYCLES)."""
        self._emit(
            {
                "name": name,
                "cat": "hvd_tpu",
                "ph": "i",
                "s": "g",
                "pid": self._rank,
                "ts": self._now_us(),
            }
        )

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._file.write("\n]\n")
            self._file.close()
