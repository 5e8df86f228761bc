"""Structured metrics logging, a copy of
``modelcompression_tpu/utils/logging.py`` (stdlib only): per-step metrics
to stdout and a JSONL file, no external services."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, jsonl_path: Optional[str] = None,
                 print_every: int = 10, stream=None):
        self.jsonl_path = jsonl_path
        self.print_every = print_every
        self.stream = stream or sys.stdout
        self._fh = None
        if jsonl_path:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)),
                        exist_ok=True)
            self._fh = open(jsonl_path, "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float],
            prefix: str = "train", force: bool = False) -> None:
        """Record one metrics row. ``print_every`` only rate-limits the
        periodic "train" stream; one-off records (eval, round summaries,
        resume, the final step of a run) pass ``force=True`` — and any
        non-"train" prefix prints unconditionally, so important records
        are never silently dropped when no JSONL file is configured."""
        rec = {"t": round(time.time() - self._t0, 3), "step": step,
               "prefix": prefix}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        show = (force or prefix != "train"
                or (self.print_every and step % self.print_every == 0))
        if show and self.print_every:
            parts = [f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in rec.items() if k not in ("t", "prefix")]
            print(f"[{prefix}] " + " ".join(parts), file=self.stream)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
