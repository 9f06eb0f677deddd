"""Shared parallel hooks for the generator and discriminator forwards.

The counterpart of the JAX package's models/hooks.py. There,
parallel/spatial.py installs a sharding hint that GSPMD turns into a
partitioned program. PyTorch runs eagerly, one process per rank, so what is
installed here is the active **row plan** (parallel/spatial.py:RowPlan): the
spatial process group, this rank's index in it, its size n and
``min_rows_per_device``. ``models/stylegan2.py:Generator.synthesize``
consults it: a block whose height qualifies runs on this rank's rows with
halo exchanges, and ``spatial_boundary`` gathers the rows at the rgb output.

A second slot holds the data-axis gather of a data-parallel training step
(parallel/mesh.py:BatchGather): D's minibatch-stddev layer takes its
statistic over the global batch through it, as the JAX step does in
global-batch semantics.

A third holds the **tp plan** of tensor parallelism (parallel/tensor.py:
TpPlan, installed by ``tensor_parallel``): ``models/stylegan2.py:StyledConv``
runs its up-convs on this rank's output channels and its partner convs on
its input channels, around one all-reduce per block.

Nothing installed => single-process behaviour; every hook is identity.
"""

from __future__ import annotations

_PLAN = None
_BATCH = None
_TP = None
_TOKEN = 0  # bumped on every install/restore, as the JAX package's


def spatial_token() -> int:
    """Changes on every install and restore (it only ever increments), so a
    cache keyed on it never mixes work done under two plans."""
    return _TOKEN


def row_plan():
    """The installed row plan, or None."""
    return _PLAN


def spatial_constrain(x):
    """This rank's rows of a replicated activation [B, H, W, C] under the
    installed plan (the caller decided that its block runs on rows, by
    ``row_plan().shards_block``); x itself without a plan."""
    if _PLAN is None:
        return x
    return _PLAN.constrain(x)


def spatial_boundary(x):
    """The whole image from every rank's rows at the generator's rgb output
    (identity without a plan; called where the image is row-sharded)."""
    if _PLAN is None:
        return x
    return _PLAN.boundary(x)


def install(plan) -> tuple:
    """Install a row plan; returns the previous state for ``restore``."""
    global _PLAN, _TOKEN
    prev = (_PLAN,)
    _PLAN = plan
    _TOKEN += 1
    return prev


def restore(prev: tuple) -> None:
    global _PLAN, _TOKEN
    (_PLAN,) = prev
    _TOKEN += 1


def batch_gather():
    """The installed data-axis gather, or None."""
    return _BATCH


def install_batch(gather):
    """Install a data-axis gather; returns the previous one."""
    global _BATCH
    prev, _BATCH = _BATCH, gather
    return prev


def restore_batch(prev) -> None:
    global _BATCH
    _BATCH = prev


def tp_plan():
    """The installed tp plan, or None."""
    return _TP


def install_tp(plan):
    """Install a tp plan; returns the previous one."""
    global _TP
    prev, _TP = _TP, plan
    return prev


def restore_tp(prev) -> None:
    global _TP
    _TP = prev
