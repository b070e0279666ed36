"""Console logging.

A copy of ``ConsoleLogger`` from ``vqvae_speech_tpu/utils/logger.py`` (the
port imports nothing of the JAX package): capability-parity with reference
src/error_handling/console_logger.py:34-81 (ANSI-colored status levels).
"""

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

