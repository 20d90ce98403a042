"""Training logger (replaces the reference's loguru sinks, reference
utils/misc.py:295-326).

Port of ``dropclip_tpu/core/logging.py``. The port trains in one process,
so there is no process index to gate on: the logger writes to stderr and,
with ``save_dir``, to a file there.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

_FMT = "%(asctime)s | %(levelname)-7s | %(name)s - %(message)s"


def setup_logger(name: str = "dropclip",
                 save_dir: Optional[str] = None,
                 filename: str = "train.log",
                 level: int = logging.INFO) -> logging.Logger:
    """A logger with a stderr sink and, with ``save_dir``, a file sink.
    Each call replaces the logger's sinks, so a second run in one process
    logs to its own directory and to the current stderr."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    sh = logging.StreamHandler(stream=sys.stderr)
    sh.setFormatter(logging.Formatter(_FMT))
    logger.addHandler(sh)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, filename))
        fh.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(fh)
    return logger
