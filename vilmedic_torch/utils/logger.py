"""Per-seed logging with a custom SETTINGS level and colour console
formatting (a copy of ``utils/logger.py`` of the JAX package).

Each run logs under a logger named after its seed, with an extra
``SETTINGS`` level rendered as a banner, a coloured console handler, and a
plain file handler inside the checkpoint directory.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

SETTINGS_LEVEL = 21  # between INFO (20) and WARNING (30)

_ANSI = {
    "grey": "\x1b[38;21m",
    "green": "\x1b[32;21m",
    "yellow": "\x1b[33;21m",
    "red": "\x1b[31;21m",
    "bold_red": "\x1b[31;1m",
    "reset": "\x1b[0m",
}


def add_logging_level(level_name: str, level_num: int, method_name: Optional[str] = None):
    """Register a custom logging level (and a logger method of its name)."""
    method_name = method_name or level_name.lower()
    if hasattr(logging, level_name) and getattr(logging, level_name) == level_num:
        if hasattr(logging.getLoggerClass(), method_name):
            return
    if hasattr(logging, level_name) and getattr(logging, level_name) != level_num:
        raise AttributeError(f"{level_name} already defined in logging module")

    def log_for_level(self, message, *args, **kwargs):
        if self.isEnabledFor(level_num):
            self._log(level_num, message, args, **kwargs)

    def log_to_root(message, *args, **kwargs):
        logging.log(level_num, message, *args, **kwargs)

    logging.addLevelName(level_num, level_name)
    setattr(logging, level_name, level_num)
    setattr(logging.getLoggerClass(), method_name, log_for_level)
    setattr(logging, method_name, log_to_root)


class ColorFormatter(logging.Formatter):
    FORMAT = "%(asctime)s %(levelname)s %(message)s"
    SETTINGS_FORMAT = (
        "\n" + _ANSI["green"] + "===== %(message)s =====" + _ANSI["reset"]
    )

    LEVEL_COLORS = {
        logging.DEBUG: _ANSI["grey"],
        logging.INFO: _ANSI["grey"],
        logging.WARNING: _ANSI["yellow"],
        logging.ERROR: _ANSI["red"],
        logging.CRITICAL: _ANSI["bold_red"],
    }

    def format(self, record):
        if record.levelno == SETTINGS_LEVEL:
            fmt = self.SETTINGS_FORMAT
        else:
            color = self.LEVEL_COLORS.get(record.levelno, _ANSI["grey"])
            fmt = color + self.FORMAT + _ANSI["reset"]
        return logging.Formatter(fmt, datefmt="%H:%M:%S").format(record)


class PlainFormatter(logging.Formatter):
    def format(self, record):
        if record.levelno == SETTINGS_LEVEL:
            fmt = "\n===== %(message)s ====="
        else:
            fmt = "%(asctime)s %(levelname)s %(message)s"
        return logging.Formatter(fmt, datefmt="%H:%M:%S").format(record)


def set_logger(ckpt_dir: Optional[str], seed) -> logging.Logger:
    """Create the per-seed logger with console + file handlers."""
    add_logging_level("SETTINGS", SETTINGS_LEVEL)
    logger = logging.getLogger(str(seed))
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if logger.handlers:  # idempotent across repeated calls within one run…
        # …but a SECOND run in the same process with the same seed and a NEW
        # ckpt_dir must not keep logging (and dumping metric refs/hyps, which
        # land in get_logger_directory) into the previous run's directory —
        # rebind the file handler to the new directory.
        if ckpt_dir is not None:
            for handler in list(logger.handlers):
                if isinstance(handler, logging.FileHandler) and (
                    os.path.dirname(handler.baseFilename)
                    != os.path.abspath(ckpt_dir)
                ):
                    logger.removeHandler(handler)
                    handler.close()
        if any(isinstance(h, logging.FileHandler) for h in logger.handlers) or (
            ckpt_dir is None
        ):
            return logger
    else:
        console = logging.StreamHandler()
        console.setLevel(logging.DEBUG)
        console.setFormatter(ColorFormatter())
        logger.addHandler(console)

    if ckpt_dir is not None:
        os.makedirs(ckpt_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(ckpt_dir, f"{seed}.log"))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(PlainFormatter())
        logger.addHandler(fh)

    return logger


def get_logger_directory(logger: logging.Logger) -> str:
    """Directory of the logger's file handler (the working directory
    without one)."""
    for handler in logger.handlers:
        if isinstance(handler, logging.FileHandler):
            return os.path.dirname(handler.baseFilename)
    return os.getcwd()
