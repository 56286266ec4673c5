"""File + console logger with elapsed-time prefixes (counterpart:
``bpx/utils/logging.py``)."""

from __future__ import annotations

import dataclasses
import json
import logging
import sys
import time
from typing import Any, Optional


class ElapsedFormatter(logging.Formatter):
    """Prefix every record with level and elapsed wall time."""

    def __init__(self):
        super().__init__()
        self.start = time.time()

    def format(self, record):
        elapsed = int(record.created - self.start)
        mins, secs = divmod(elapsed, 60)
        hrs, mins = divmod(mins, 60)
        prefix = f"{record.levelname} - {hrs:02d}:{mins:02d}:{secs:02d}"
        message = record.getMessage().replace("\n", f"\n{prefix} - ")
        return f"{prefix} - {message}"


def create_logger(filepath: Optional[str] = None,
                  config: Any = None,
                  name: str = "bpx_torch") -> logging.Logger:
    """File handler at DEBUG + console at INFO; dumps the config at
    creation."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    for handler in list(logger.handlers):
        handler.close()
    logger.handlers.clear()
    logger.propagate = False

    fmt = ElapsedFormatter()
    console = logging.StreamHandler(sys.stdout)
    console.setLevel(logging.INFO)
    console.setFormatter(fmt)
    logger.addHandler(console)

    if filepath:
        fh = logging.FileHandler(filepath, mode="a")
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)

    if config is not None:
        try:
            dump = json.dumps(dataclasses.asdict(config), indent=2,
                              default=str)
        except TypeError:
            dump = repr(config)
        logger.debug("config:\n%s", dump)
    return logger
