"""Per-output-directory run logs (port of `viditq_tpu/utils/logging.py`;
the reference logs to run.log / quant_inference_run.log in each output
directory, t2v/scripts/ptq.py:49-59)."""

from __future__ import annotations

import logging
import os
import subprocess
import sys


def setup_logger(save_dir: str, name: str = "run") -> logging.Logger:
    """A logger writing `<save_dir>/<name>.log` and stderr."""
    os.makedirs(save_dir, exist_ok=True)
    logger = logging.getLogger(f"viditq_torch.{name}")
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        h.close()
        logger.removeHandler(h)
    fh = logging.FileHandler(os.path.join(save_dir, f"{name}.log"))
    fh.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)s %(message)s"))
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(logging.Formatter("[viditq] %(message)s"))
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


def log_invocation(logger: logging.Logger, args) -> None:
    """Record the CLI arguments and the checkout's git revision."""
    try:
        rev = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))).stdout.strip() or "unknown"
    except OSError:
        rev = "unknown"
    logger.info("invocation: %s", {k: v for k, v in vars(args).items()
                                   if k != "fn"})
    logger.info("revision: %s", rev)
