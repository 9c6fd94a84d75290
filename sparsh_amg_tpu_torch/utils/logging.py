"""Structured logging (SURVEY.md §5.5: the reference printf's residual per
iteration and phase timings; here a std-logging logger plus a JSON-friendly
iteration record)."""
from __future__ import annotations

import logging


_ROOT = "sparsh_amg_tpu_torch"   # the port's package (the one change)


def get_logger(name: str = _ROOT) -> logging.Logger:
    """Package logger.  The handler lives on the package root; module
    loggers (children) propagate to it, so one
    ``get_logger().setLevel(logging.DEBUG)`` enables the per-iteration
    records everywhere (CLI --verbose does exactly that)."""
    root = logging.getLogger(_ROOT)
    if not root.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        root.addHandler(h)
        root.setLevel(logging.INFO)
    return logging.getLogger(name)


def iteration_log(iteration: int, relres: float, elapsed_s: float) -> dict:
    return {"iter": iteration, "relres": relres, "t": elapsed_s}
