"""Leveled logging, copied from `hetu_tpu/utils/logging.py` (the port
keeps its own copy so it never imports the JAX package).  The level is
`HETU_TPU_LOG_LEVEL` (INFO by default), as in the reference."""
from __future__ import annotations

import logging
import os
import sys

_FMT = "[%(asctime)s %(name)s %(levelname).1s] %(message)s"


def get_logger(name: str = "hetu_tpu_torch") -> logging.Logger:
    logger = logging.getLogger(f"hetu_tpu_torch.{name}")
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT, datefmt="%H:%M:%S"))
        logger.addHandler(h)
        logger.setLevel(os.environ.get("HETU_TPU_LOG_LEVEL", "INFO"))
        logger.propagate = False
    return logger
