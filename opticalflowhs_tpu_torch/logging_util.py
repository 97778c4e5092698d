"""Structured logging / metrics emission, a copy of
opticalflowhs_tpu/logging_util.py (SURVEY.md §5.5).

The reference printed wall-clock with printf; here: stdlib logging for
human-facing messages plus a JSON-lines metrics appender whose records feed
RESULTS.json / BASELINE.md. Keep it boring — observability for a solver is
a metrics file, not a framework.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Mapping

_FORMAT = "%(asctime)s %(name)s %(levelname)s %(message)s"


def get_logger(name: str = "hsflow") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("HSFLOW_LOGLEVEL", "INFO").upper())
        logger.propagate = False
    return logger


def log_metrics(path: str, record: Mapping[str, Any]) -> None:
    """Append one JSON line (timestamped) to a metrics file."""
    rec = {"ts": time.time(), **record}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
