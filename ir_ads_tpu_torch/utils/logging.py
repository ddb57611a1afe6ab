"""``get_logger``: one stdout handler, and a file handler when a path is
given; ``ScalarWriter``: scalars as ``scalars.jsonl`` lines, and to
TensorBoard where ``torch.utils.tensorboard`` imports.  Counterpart of
ir_ads_tpu/utils/logging.py, with the same line form
(``{"tag", "value", "step", "ts"}``).  One difference: TensorBoard is left
out where TensorFlow is installed, since torch's writer then imports
TensorFlow, which may import JAX, and the port imports no JAX."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import logging
import os
import sys
import time
from typing import Iterator, Optional


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


@contextlib.contextmanager
def log_to_file(logger: logging.Logger, log_file: str) -> Iterator[logging.Logger]:
    """``logger`` also writes to ``log_file`` inside the block (``get_logger``
    adds its file only to a logger without handlers, so a second run in one
    process would otherwise log to no file of its own)."""
    os.makedirs(os.path.dirname(str(log_file)) or ".", exist_ok=True)
    fh = logging.FileHandler(str(log_file))
    fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
    logger.addHandler(fh)
    try:
        yield logger
    finally:
        logger.removeHandler(fh)
        fh.close()


class ScalarWriter:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        if importlib.util.find_spec("tensorflow") is None:
            try:  # optional TensorBoard
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:
                pass

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": float(value), "step": int(step), "ts": time.time()}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
