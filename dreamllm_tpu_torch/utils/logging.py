"""Logging for the port (a copy of what it needs from
``dreamllm_tpu/utils/logging.py``; the port imports nothing of that package).
One process, one card: loggers are rooted under ``dreamllm_tpu_torch`` so
they share whatever handlers the application installs there."""

from __future__ import annotations

import logging

_ROOT = "dreamllm_tpu_torch"


def get_logger(name: str = _ROOT) -> logging.Logger:
    """A logger under the package's namespace; a name from outside it is
    re-rooted so its records reach the package's handlers."""
    if name != _ROOT and not name.startswith(_ROOT + "."):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)
