"""Logging with Kaldi-style severity and verbose levels.

Replacement for the KALDI_LOG/KALDI_WARN/KALDI_ERR/KALDI_VLOG
macro family (reference: src/base/kaldi-error.h); port of
kaldi_aslp_tpu/utils/log.py (``get_logger``, ``set_verbose_level``,
``verbose_level``, ``vlog``, ``Timer``).
"""

from __future__ import annotations

import logging
import sys
import time

_VERBOSE_LEVEL = 0

_FORMAT = "%(levelname)s (%(name)s) %(message)s"


def set_verbose_level(level: int) -> None:
    """Equivalent of --verbose=N; gates vlog() calls."""
    global _VERBOSE_LEVEL
    _VERBOSE_LEVEL = int(level)


def verbose_level() -> int:
    return _VERBOSE_LEVEL


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logging.getLogger().handlers and not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def vlog(logger: logging.Logger, level: int, msg: str, *args) -> None:
    """KALDI_VLOG(level) equivalent: only prints if --verbose >= level."""
    if _VERBOSE_LEVEL >= level:
        logger.info(msg, *args)


class Timer:
    """Wall-clock timer (reference: src/base/timer.h)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._start = time.monotonic()

    def elapsed(self) -> float:
        return time.monotonic() - self._start
