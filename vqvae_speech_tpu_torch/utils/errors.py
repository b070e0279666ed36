"""Exception-contract decorator.

A copy of ``vqvae_speech_tpu/utils/errors.py`` (the port imports nothing of
the JAX package): reference src/error_handling/exception_decorators.py:34-55.
"""
from functools import wraps


class InvalidRaiseException(Exception):
    """Raised when a function throws an exception type it did not declare."""


def only_throws(E):
    """Declare that a function may only raise ``E``; anything else is
    converted into InvalidRaiseException (contract-checking aid)."""

    def decorator(f):
        @wraps(f)
        def wrapped(*args, **kwargs):
            try:
                return f(*args, **kwargs)
            except E:
                raise
            except InvalidRaiseException:
                raise
            except Exception as e:
                raise InvalidRaiseException(
                    f"got {e.__class__.__name__}, expected {E.__name__}, "
                    f"from {f.__name__}")

        return wrapped

    return decorator
