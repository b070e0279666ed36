"""Console + rotating file logging.

A copy of ``vqvae_speech_tpu/utils/logger.py`` (the port imports nothing of
the JAX package): capability-parity with reference
src/error_handling/console_logger.py:34-81 (ANSI-colored status levels) and
src/error_handling/logger_factory.py:35-60 (rotating file logs).
"""
import logging
import os
from logging.handlers import RotatingFileHandler

_COLORS = {
    "status": "\033[94m",     # blue
    "success": "\033[92m",    # green
    "warn": "\033[93m",       # yellow
    "error": "\033[91m",      # red
    "critical": "\033[95m",   # magenta
}
_END = "\033[0m"


class ConsoleLogger:
    """ANSI-colored leveled console output."""

    enabled = True

    @classmethod
    def _emit(cls, level, message):
        if not cls.enabled:
            return
        print(f"{_COLORS[level]}[{level.upper()}] {message}{_END}", flush=True)

    @classmethod
    def status(cls, message):
        cls._emit("status", message)

    @classmethod
    def success(cls, message):
        cls._emit("success", message)

    @classmethod
    def warn(cls, message):
        cls._emit("warn", message)

    @classmethod
    def error(cls, message):
        cls._emit("error", message)

    @classmethod
    def critical(cls, message):
        cls._emit("critical", message)



def create_file_logger(name: str, log_dir: str = "log",
                       max_bytes: int = 5 * 1024 * 1024,
                       backup_count: int = 3) -> logging.Logger:
    """Rotating file logger under ``log_dir`` (one file per logger name)."""
    os.makedirs(log_dir, exist_ok=True)
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = RotatingFileHandler(
            os.path.join(log_dir, f"{name}.log"),
            maxBytes=max_bytes, backupCount=backup_count)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger
