"""Training logger (replaces the reference's loguru sinks, reference
utils/misc.py:295-326).

Port of ``dropclip_tpu/core/logging.py``: the logger writes to stderr
and, with ``save_dir``, to a file there. The JAX package emits on process
0 only; the port's trainer gives rank 0 the stderr sink and ``train.log``
and every other rank a file of its own (``stderr=False``).
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
                 level: int = logging.INFO,
                 stderr: bool = True) -> logging.Logger:
    """A logger with a stderr sink (unless ``stderr`` is False) and, with
    ``save_dir``, a file sink. Each call replaces the logger's sinks, so a
    second run in one process logs to its own directory and to the
    current stderr."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    if stderr:
        sh = logging.StreamHandler(stream=sys.stderr)
        sh.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(sh)
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(save_dir, filename))
        fh.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(fh)
    return logger
