"""Rank-aware logging (counterpart of ``deepspeed_tpu/utils/logging.py``):
``log_dist`` logs on the listed ranks of ``torch.distributed`` (rank 0
when no process group is initialised)."""

import logging
import sys

class LoggerFactory:

    @staticmethod
    def create_logger(name=None, level=logging.INFO):
        """A logger with a standard formatter writing to stdout."""
        if name is None:
            raise ValueError("name for logger cannot be None")
        formatter = logging.Formatter(
            "[%(asctime)s] [%(levelname)s] "
            "[%(filename)s:%(lineno)d:%(funcName)s] %(message)s")
        logger_ = logging.getLogger(name)
        logger_.setLevel(level)
        logger_.propagate = False
        if not logger_.handlers:
            ch = logging.StreamHandler(stream=sys.stdout)
            ch.setLevel(level)
            ch.setFormatter(formatter)
            logger_.addHandler(ch)
        return logger_


logger = LoggerFactory.create_logger(name="DeepSpeedTorch",
                                     level=logging.INFO)


def _rank():
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message, ranks=None, level=logging.INFO):
    """Log *message* only on the listed ranks (-1 or None = all)."""
    if not ranks or -1 in ranks or _rank() in set(ranks):
        logger.log(level, f"[Rank {_rank()}] {message}")

