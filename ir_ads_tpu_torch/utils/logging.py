"""``get_logger``: one stdout handler, and a file handler when a path is
given (counterpart of ir_ads_tpu/utils/logging.py's ``get_logger``)."""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional


def get_logger(log_file: Optional[str] = None,
               name: str = "ir_ads_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    if logger.handlers:
        return logger
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_file:
        os.makedirs(os.path.dirname(str(log_file)) or ".", exist_ok=True)
        fh = logging.FileHandler(str(log_file))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
