"""Two-mode logging (port of ``llmq_tpu/utils/logging.py``).

Workers log JSON lines to stdout (machine-tailable, ``| jq .``); CLI commands
log human-readable lines to stderr so stdout stays clean for JSONL results.
``LLMQ_LOG_FORMAT=json`` forces the structured format everywhere; structured
records carry ``worker_id`` / ``job_id`` / ``trace_id`` whenever the logging
call attached them (a worker's logger attaches its ``worker_id``).
"""

from __future__ import annotations

import json
import logging
import os
import sys
from datetime import datetime, timezone
from typing import Optional

#: Correlation attrs promoted into structured entries when present on a
#: record (set via ``extra={...}`` or a ``LoggerAdapter``).
CONTEXT_FIELDS = ("worker_id", "job_id", "trace_id")


class JsonLineFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": datetime.now(timezone.utc).isoformat(),
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        for field in CONTEXT_FIELDS:
            value = getattr(record, field, None)
            if value is not None:
                entry[field] = value
        if record.exc_info:
            entry["exc"] = self.formatException(record.exc_info)
        return json.dumps(entry, default=str)


def setup_logging(*, structured: bool = False, level: Optional[str] = None) -> None:
    """Configure root logging. ``structured=True`` -> JSON lines on stdout
    (worker mode); else human format on stderr (CLI mode).
    ``LLMQ_LOG_FORMAT=json`` forces structured regardless of the caller;
    ``level`` defaults to ``LLMQ_LOG_LEVEL`` (``Config.log_level``)."""
    if os.environ.get("LLMQ_LOG_FORMAT", "").lower() == "json":
        structured = True
    if level is None:
        from llmq_tpu_torch.core.config import get_config

        level = get_config().log_level
    root = logging.getLogger()
    root.setLevel(level.upper())
    for h in list(root.handlers):
        root.removeHandler(h)
    if structured:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(JsonLineFormatter())
    else:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)-7s %(name)s: %(message)s",
                              datefmt="%H:%M:%S")
        )
    root.addHandler(handler)
