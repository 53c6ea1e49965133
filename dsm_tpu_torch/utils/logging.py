"""Logging with style presets (counterpart of ``dsm_tpu/utils/logging.py``):
compact, pretty and verbose formatters with level icons, a JSON mode, and an
optional rotating file under ``log_dir``."""

from __future__ import annotations

import json
import logging
import logging.handlers
import os
import sys
import time
from typing import Optional

_ICONS = {
    logging.DEBUG: "·",
    logging.INFO: "✓",
    logging.WARNING: "⚠",
    logging.ERROR: "✗",
    logging.CRITICAL: "‼",
}
_COLORS = {
    logging.DEBUG: "\x1b[2m",
    logging.INFO: "\x1b[32m",
    logging.WARNING: "\x1b[33m",
    logging.ERROR: "\x1b[31m",
    logging.CRITICAL: "\x1b[41m",
}
_RESET = "\x1b[0m"


class StyleFormatter(logging.Formatter):
    def __init__(self, style: str = "compact", color: Optional[bool] = None):
        super().__init__()
        self.style_name = style
        self.color = sys.stderr.isatty() if color is None else color

    def format(self, record: logging.LogRecord) -> str:
        icon = _ICONS.get(record.levelno, "?")
        if self.color:
            icon = _COLORS.get(record.levelno, "") + icon + _RESET
        msg = record.getMessage()
        if record.exc_info:
            msg += "\n" + self.formatException(record.exc_info)
        if self.style_name == "compact":
            return f"{icon} {msg}"
        ts = time.strftime("%H:%M:%S", time.localtime(record.created))
        if self.style_name == "pretty":
            return f"{ts} {icon} [{record.name}] {msg}"
        return (
            f"{ts}.{int(record.msecs):03d} {icon} {record.levelname:<7} "
            f"{record.name} ({record.filename}:{record.lineno}) {msg}"
        )


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        return json.dumps(
            {
                "ts": record.created,
                "level": record.levelname,
                "target": record.name,
                "message": record.getMessage(),
            }
        )


def setup_logging(
    style: str = "compact",
    level: int = logging.INFO,
    log_dir: Optional[str] = None,
    instance_name: str = "dsm-tpu",
    max_bytes: int = 64 * 2**20,
    backups: int = 7,
) -> None:
    root = logging.getLogger()
    root.setLevel(level)
    root.handlers.clear()
    console = logging.StreamHandler(sys.stderr)
    console.setFormatter(
        JsonFormatter() if style == "json" else StyleFormatter(style)
    )
    root.addHandler(console)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.handlers.RotatingFileHandler(
            os.path.join(log_dir, f"{instance_name}.log"),
            maxBytes=max_bytes,
            backupCount=backups,
        )
        fh.setFormatter(StyleFormatter("verbose", color=False))
        root.addHandler(fh)
