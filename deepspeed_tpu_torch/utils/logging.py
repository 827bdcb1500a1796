"""Rank-aware logging (port of ``deepspeed_tpu/utils/logging.py``).

The same ``logger`` / ``log_dist`` surface; the rank comes from
``torch.distributed`` when a process group is up, else 0.
"""

import functools
import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


@functools.lru_cache(None)
def _create_logger(name="deepspeed_tpu_torch", level=logging.INFO):
    logger_ = logging.getLogger(name)
    logger_.setLevel(level)
    logger_.propagate = False
    if not logger_.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(
            logging.Formatter(
                "[%(asctime)s] [%(levelname)s] [%(name)s:%(lineno)d] %(message)s"
            )
        )
        logger_.addHandler(handler)
    return logger_


logger = _create_logger(
    level=LOG_LEVELS.get(os.environ.get("DS_TPU_LOG_LEVEL", "info").lower(), logging.INFO)
)


def _process_index():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message, ranks=None, level=logging.INFO):
    """Log ``message`` only on the given process ranks (None / [-1] = all ranks)."""
    my_rank = _process_index()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")
