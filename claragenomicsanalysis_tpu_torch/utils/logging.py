"""Logging (counterpart of ``claragenomicsanalysis_tpu/utils/logging.py``):
a thin stdlib-logging wrapper for the CLI's ``--log-level``."""

import logging


def initialize_logger(level: str = "INFO") -> logging.Logger:
    logger = logging.getLogger("claragenomicsanalysis_tpu_torch")
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(h)
    logger.setLevel(getattr(logging, level.upper()))
    return logger

