"""Structured per-epoch metrics logging (counterpart of
adnm_tpu/utils/logging.py): human-readable prints and a JSONL stream, in
place of the reference's print lines (train.py:115-202)."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional


def print_log(message: str):
    """Reference: Shanghai_metrics.py:10-12 (print + logging.info)."""
    print(message)
    logging.info(message)


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, **fields):
        fields.setdefault("ts", time.time())
        line = json.dumps(fields, default=float)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print_log(line)
