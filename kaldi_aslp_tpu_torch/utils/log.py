"""Logging with Kaldi-style severity and verbose levels.

Replacement for the KALDI_LOG/KALDI_WARN/KALDI_ERR/KALDI_VLOG
macro family (reference: src/base/kaldi-error.h).

The part of kaldi_aslp_tpu/utils/log.py the port uses so far
(``get_logger``, ``set_verbose_level``).
"""

from __future__ import annotations

import logging
import sys

_VERBOSE_LEVEL = 0

_FORMAT = "%(levelname)s (%(name)s) %(message)s"


def set_verbose_level(level: int) -> None:
    """Equivalent of --verbose=N (the port logs nothing verbose yet)."""
    global _VERBOSE_LEVEL
    _VERBOSE_LEVEL = int(level)


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logging.getLogger().handlers and not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger
