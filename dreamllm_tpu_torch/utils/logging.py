"""Rank-aware logging (port of ``dreamllm_tpu/utils/logging.py``; the port
imports nothing of that package). Loggers are rooted under
``dreamllm_tpu_torch``; :func:`setup_logger` installs the handlers there:
rank 0 logs to stderr, and with a run directory to ``log_rank{r}.txt``
(every rank with ``rank_policy="all"``). :func:`warning_once` drops a
warning it has already given. The rank is ``torch.distributed``'s when a
process group is initialised, else 0.
"""

from __future__ import annotations

import logging
import os
import sys

_ROOT = "dreamllm_tpu_torch"
_seen_warnings: set[str] = set()


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_logger(name: str = _ROOT) -> logging.Logger:
    """A logger under the package's namespace; a name from outside it is
    re-rooted so its records reach the package's handlers."""
    if name != _ROOT and not name.startswith(_ROOT + "."):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)


def warning_once(msg: str, *args, logger_name: str = _ROOT):
    key = msg % args if args else msg
    if key not in _seen_warnings:
        _seen_warnings.add(key)
        logging.getLogger(logger_name).warning(msg, *args)


def setup_logger(
    run_dir: str | None = None,
    rank_policy: str = "main",
    level: int = logging.INFO,
) -> logging.Logger:
    rank = _process_index()
    logger = logging.getLogger(_ROOT)
    logger.setLevel(level)
    logger.handlers.clear()
    fmt = logging.Formatter(
        f"%(asctime)s [rank{rank}] %(levelname)s %(name)s: %(message)s",
        datefmt="%H:%M:%S",
    )
    if rank == 0:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(fmt)
        logger.addHandler(h)
    if run_dir and (rank == 0 or rank_policy == "all"):
        os.makedirs(run_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(run_dir, f"log_rank{rank}.txt"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    logger.propagate = False
    return logger
