"""Structured logging: timestamped file + stdout, uncaught-exception capture
— own copy of latent2im_tpu/utils/logging.py (the reference's
utils/logging.py:92-139), with the trace helper on ``torch.profiler``."""

from __future__ import annotations

import contextlib
import logging
import os
import sys


class MultilineFormatter(logging.Formatter):
    """Prefix every line of a multiline message with the timestamp header."""

    def format(self, record):
        header = self.formatTime(record, self.datefmt)
        msg = record.getMessage()
        if record.exc_info:
            msg += "\n" + self.formatException(record.exc_info)
        return "\n".join(f"{header} {line}" for line in msg.split("\n"))


def configure(filename: str, append: bool = False) -> None:
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    fmt = MultilineFormatter(datefmt="%Y-%m-%d %H:%M:%S")
    fh = logging.FileHandler(filename, mode="a" if append else "w")
    fh.setFormatter(fmt)
    root.addHandler(fh)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    root.addHandler(sh)

    def excepthook(exc_type, exc_value, tb):
        logging.error("uncaught exception", exc_info=(exc_type, exc_value, tb))

    sys.excepthook = excepthook


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """torch.profiler (CPU and, where there is a card, CUDA activity) around
    a region, exported as a Chrome trace into ``log_dir``; no-op when
    log_dir is empty."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    logging.info("profiler trace written to %s", path)
