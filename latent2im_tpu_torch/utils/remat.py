"""Rematerialization as the port uses it: ``torch.utils.checkpoint``, the
counterpart of the JAX package's ``jax.checkpoint`` (--remat_g,
--remat_towers)."""

from __future__ import annotations

import torch.utils.checkpoint as tuc


def checkpoint(fn, *args):
    """fn(*args), keeping only its inputs for the backward, which runs fn
    again to rebuild the rest. Non-reentrant, and without the early stop of
    the recompute, so the backward re-runs the whole region once: one extra
    forward, as jax.checkpoint's, and a kernel launch count per step that
    the region's forward fixes. The region must draw no noise from an
    explicit ``torch.Generator`` (the checkpoint restores the global RNG
    only): callers draw it before and pass it in."""
    with tuc.set_checkpoint_early_stop(False):
        return tuc.checkpoint(fn, *args, use_reentrant=False)
