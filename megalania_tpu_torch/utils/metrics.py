"""Structured per-segment metrics (megalania_tpu/utils/metrics.py).

The reference program logs one stderr line per 100 moves
(src/main.c:97-99); a MetricsLogger collects structured records on the
host and can write both human-readable lines and JSONL.
"""
from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass, field
from typing import IO, List, Optional


@dataclass
class MetricsLogger:
    stream: Optional[IO] = None          # human-readable lines (e.g. stderr)
    jsonl_path: Optional[str] = None     # structured log, appended
    history: List[dict] = field(default_factory=list)
    t0: float = field(default_factory=time.time)

    def log(self, **record):
        record.setdefault("t", round(time.time() - self.t0, 3))
        self.history.append(record)
        if self.stream is not None:
            self.stream.write("  ".join(f"{k}={v}" for k, v in record.items())
                              + "\n")
            self.stream.flush()
        if self.jsonl_path:
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(record) + "\n")


def stderr_logger(jsonl_path: Optional[str] = None) -> MetricsLogger:
    return MetricsLogger(stream=sys.stderr, jsonl_path=jsonl_path)
