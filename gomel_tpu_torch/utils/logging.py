"""Structured logging: one process-wide logger with the process's rank in
every record and an optional JSON-lines mode for harvesting.

Counterpart of ``gomel_tpu/utils/logging.py``; the rank is the
``torch.distributed`` rank when a process group is initialised, else 0.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any

_LOGGER_NAME = "gomel_tpu_torch"


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload: dict[str, Any] = {
            "ts": round(time.time(), 3),
            "level": record.levelname,
            "process": getattr(record, "process_rank", None),
            "msg": record.getMessage(),
        }
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        extra = getattr(record, "fields", None)
        if extra:
            payload.update(extra)
        return json.dumps(payload)


class _ProcessFilter(logging.Filter):
    def filter(self, record: logging.LogRecord) -> bool:
        import torch.distributed as dist
        record.process_rank = (dist.get_rank() if dist.is_available()
                               and dist.is_initialized() else 0)
        return True


def get_logger(json_lines: bool | None = None) -> logging.Logger:
    """The process-wide logger. ``GOMEL_TPU_LOG_JSON=1`` switches to
    JSON-lines output and ``GOMEL_TPU_LOG_LEVEL`` sets the level, as for
    the JAX package's logger."""
    logger = logging.getLogger(_LOGGER_NAME)
    if logger.handlers:
        return logger
    if json_lines is None:
        json_lines = os.environ.get("GOMEL_TPU_LOG_JSON", "0") == "1"
    handler = logging.StreamHandler(sys.stderr)
    if json_lines:
        handler.setFormatter(_JsonFormatter())
    else:
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s p%(process_rank)s %(name)s: "
            "%(message)s"))
    handler.addFilter(_ProcessFilter())
    logger.addHandler(handler)
    logger.setLevel(os.environ.get("GOMEL_TPU_LOG_LEVEL", "INFO"))
    logger.propagate = False
    return logger


def log_event(event: str, **fields: Any) -> None:
    """Structured event helper: ``log_event("encode_done", frames=128)``."""
    get_logger().info(event, extra={"fields": fields})
