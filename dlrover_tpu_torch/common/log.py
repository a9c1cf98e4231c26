"""Structured logging for the PyTorch port (a copy of
``dlrover_tpu/common/log.py``, which this package may not import).

One shared logger with a rank/role-aware format: role comes from
``DLROVER_TPU_ROLE``, rank from ``RANK`` (torch.distributed's launcher)
or ``DLROVER_TPU_NODE_RANK``. ``DLROVER_TPU_LOG_JSON=1`` switches to
one JSON object per record.
"""

from __future__ import annotations

import json
import logging
import os
import sys

_FORMAT = (
    "[%(asctime)s] [%(levelname)s] [%(role_rank)s] "
    "[%(name)s:%(lineno)d] %(message)s"
)


def role_and_rank() -> tuple:
    """(role, rank) of this process from the environment; rank is -1
    when absent or unparsable. Read per call: a launcher may set the
    variables after import."""
    role = os.getenv("DLROVER_TPU_ROLE", "") or ""
    rank_s = os.getenv("RANK", os.getenv("DLROVER_TPU_NODE_RANK", ""))
    try:
        rank = int(rank_s)
    except ValueError:
        rank = -1
    return role, rank


def _role_rank() -> str:
    role, rank = role_and_rank()
    role = role or "-"
    return f"{role}/{rank}" if rank >= 0 else role


class _TextFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        record.role_rank = _role_rank()
        return super().format(record)


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        role, rank = role_and_rank()
        payload = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "line": record.lineno,
            "role": role or "-",
            "rank": rank,
            "pid": record.process,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload, default=str)


def _make_formatter() -> logging.Formatter:
    if os.getenv("DLROVER_TPU_LOG_JSON", "") == "1":
        return _JsonFormatter()
    return _TextFormatter(_FORMAT)


def _build_logger(name: str = "dlrover_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(os.getenv("DLROVER_TPU_LOG_LEVEL", "INFO").upper())
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(_make_formatter())
    logger.addHandler(handler)
    logger.propagate = False
    return logger


default_logger = _build_logger()


def get_logger(name: str) -> logging.Logger:
    """Child logger that inherits the default handler and format."""
    return default_logger.getChild(name)
