"""Spatial partitioning (sp) of StyleGAN2 synthesis over image rows — the
counterpart of the JAX package's parallel/spatial.py.

Data parallelism has nothing to shard at the B=1..2 that vis_w and eval run
at 1024 px; sp shards the activations' H axis over a 'spatial' mesh axis
instead. In JAX a sharding hint per block lets GSPMD partition every conv
and insert the halo exchanges. Here each rank is a process, so the row plan
(``RowPlan``, installed in models/hooks.py by ``spatial_partitioning``)
tells ``Generator.synthesize`` which rows are this rank's, and three
autograd functions do what GSPMD does:

- **Row slice** (``RowPlan.constrain``): where a block first qualifies —
  the JAX rule, ``h % n == 0 and h >= n * min_rows_per_device`` on the
  block's output height, and its input height divisible by n — the
  replicated activation and skip keep this rank's rows. Earlier blocks
  run replicated on every rank. The backward of a slice is the gradient of
  those rows alone; summed over 'spatial' (parallel/mesh.py:
  ``average_gradients``) it is the whole gradient.
- **Halo exchange** (``RowPlan.halo``, r rows): the forward fetches the
  previous rank's last r rows and the next rank's first r rows, zeros at the
  image's true top and bottom (the convs' zero padding). The backward sends
  the halo rows' gradients back to their owners, which add them to their
  edge rows.
- **Row gather** (``RowPlan.boundary``, at G's rgb output, JAX's
  ``_spatial_boundary``): the whole image on every spatial rank. Its
  backward returns this rank's rows of the incoming gradient, NOT a sum:
  every spatial rank computes the same loss on the same gathered image, so
  each holds the whole image gradient already, and a summing backward would
  count G's gradient n times.

Halo widths, per op of a block whose input is rows [a, b) of height H (the
output is rows [2a, 2b) of 2H), one row each (r = 1):

- up styled conv: ``conv_transpose2d`` (3 taps, stride 2) writes global row
  o from input rows i with 2i + k = o, k in 0..2; the 4-tap blur with pad
  (1, 1) reads rows p-1..p+2 of that for output row p. Output rows [2a, 2b)
  need input rows a-1..b: one halo row. On the extended input (local row 0
  = global a-1) the transposed conv's rows start at global 2a-2, so the blur
  takes y pads (1 - 2r, 1 - 2r) = (-1, -1), a crop, and x pads (1, 1).
- 3x3 styled conv (kernel #5): one halo row. The kernel's entry has no
  per-edge pads, so it gets x with its halo rows, pads those by its usual
  zero row, and the two output rows the halo produced are dropped (the
  noise is padded by zero rows to match). That spends 2 rows in h + 2 of
  the conv's work and keeps the kernel and its tiling checks as they are.
- ToRGB's skip ``upsample2d`` (up 2, 4 taps, pads (2, 1)): output row p
  reads zero-stuffed rows p-2..p+1, i.e. skip rows ceil((p-2)/2) ..
  floor((p+1)/2): rows a-1..b again, one halo row; on the extended skip the
  y pads become (2 - 2r, 1 - 2r) = (0, -1), x pads (2, 1).

ToRGB's 1x1 conv, the noise add and fused_act are row-local. Stored noise
maps are sliced to the rank's rows; fresh noise is drawn at the global shape
and sliced, so every rank and the single-process run see the same noise.

The other generator families (their forwards consult the same plan)
shard from the first block whose OUTPUT height qualifies, as the JAX
package's hook after each block, on NCHW rows (``dim=2``):

- PGGAN (model_256) and the GAN-zoo GNet: nearest x2 upsampling of rows
  [a, b) gives rows [2a, 2b), no halo; each 3x3 pad-1 conv takes one halo
  row each side and pads only the columns; the pixel norm (over channels),
  LeakyReLU and the 1x1 rgb heads are row-local.
- StyleGAN1: the 3x3 pad-1 convs and the [1,2,1]^2 blur (pad 1) take one
  halo row; the fused upsample (a stride-2 transposed conv of a 4x4 kernel,
  pad 1: output row o reads input rows (o + 1 - k) / 2, k = 0..3) makes rows
  [2a, 2b) from input rows a-1..b, one halo row, its output cropped to
  those rows; the noise maps are sliced to the rank's rows; AdaIN's
  instance norm needs each channel's mean and variance over the whole
  image: (sum x, sum x^2) of the rank's rows summed over the spatial ranks
  in one all-reduce (``RowPlan.sum_rows``, whose backward sums the
  gradients over the ranks again, since every rank normalises by the same
  sums).
"""

from __future__ import annotations

import contextlib

import torch

from ..models import hooks as _hooks
from . import mesh as meshlib


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, r, dim):
        ctx.plan, ctx.r, ctx.dim = plan, r, dim
        h = x.shape[dim]
        top, bottom = plan.exchange(x.narrow(dim, 0, r), x.narrow(dim, h - r, r))
        return torch.cat([top, x, bottom], dim)

    @staticmethod
    def backward(ctx, g):
        r, dim = ctx.r, ctx.dim
        h = g.shape[dim] - 2 * r
        from_prev, from_next = ctx.plan.exchange(g.narrow(dim, 0, r), g.narrow(dim, h + r, r))
        gx = g.narrow(dim, r, h).clone()
        gx.narrow(dim, 0, r).add_(from_prev)
        gx.narrow(dim, h - r, r).add_(from_next)
        return gx, None, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan, dim):
        ctx.plan, ctx.h, ctx.dim = plan, x.shape[dim], dim
        return meshlib.all_gather(plan.mesh, plan.axis, x, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.plan.index * ctx.h, ctx.h).contiguous(), None, None


class _SumRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, plan):
        ctx.plan = plan
        return meshlib.all_reduce(plan.mesh, t, plan.axis)

    @staticmethod
    def backward(ctx, g):
        # every rank normalises its rows by the same sum: the gradient of
        # each rank's share is the sum of every rank's
        return meshlib.all_reduce(ctx.plan.mesh, g.contiguous(), ctx.plan.axis), None


class RowPlan:
    """This rank's share of the image rows on ``mesh``'s ``axis``."""

    def __init__(self, mesh: meshlib.Mesh, axis: str = "spatial",
                 min_rows_per_device: int = 8):
        self.mesh, self.axis = mesh, axis
        self.n, self.index = int(mesh.shape[axis]), int(mesh.coords[axis])
        self.min_rows = int(min_rows_per_device)
        self.halo_bytes = self.gather_bytes = 0  # what crossed ranks, for the reports

    def qualifies(self, h: int) -> bool:
        """The JAX package's rule for sharding a height-h activation."""
        return h % self.n == 0 and h >= self.n * self.min_rows

    def shards_block(self, h_in: int) -> bool:
        """A synthesis block with input height h_in runs on rows."""
        return self.qualifies(2 * h_in) and h_in % self.n == 0

    def rows(self, h: int) -> tuple[int, int]:
        step = h // self.n
        return self.index * step, (self.index + 1) * step

    def constrain(self, x, dim: int = 1):
        """This rank's rows of a replicated tensor, rows along ``dim`` (1:
        NHWC, 2: NCHW)."""
        lo, hi = self.rows(x.shape[dim])
        return x.narrow(dim, lo, hi - lo).contiguous()

    def exchange(self, to_prev, to_next):
        self.halo_bytes += 2 * to_prev.numel() * to_prev.element_size()
        return meshlib.exchange(self.mesh, self.axis, to_prev.contiguous(),
                                to_next.contiguous())

    def halo(self, x, r: int = 1, dim: int = 1):
        """x's rows with r rows of each neighbour around them (zeros past
        the image's edges)."""
        return _Halo.apply(x, self, r, dim)

    def boundary(self, x, dim: int = 1):
        """The whole image from every rank's rows."""
        self.gather_bytes += x.numel() * x.element_size() * (self.n - 1)
        return _GatherRows.apply(x, self, dim)

    def sum_rows(self, t):
        """t summed over the spatial ranks (a statistic of the whole image
        from each rank's rows); differentiable."""
        return _SumRows.apply(t, self)


class spatial_partitioning:
    """Install a row plan for the generator forwards run inside the context.

    A class, not a generator context manager, so one instance is reusable
    across sequential with-blocks and nestable (the previous plan restores
    from a per-instance stack), as the JAX package's. ``plan`` is the row
    plan it installs (its byte counters read what crossed ranks)."""

    def __init__(self, mesh: meshlib.Mesh, axis: str = "spatial",
                 min_rows_per_device: int = 8):
        self.plan = RowPlan(mesh, axis, min_rows_per_device)
        self._stack = []

    def __enter__(self):
        self._stack.append(_hooks.install(self.plan))
        return self

    def __exit__(self, *exc):
        _hooks.restore(self._stack.pop())
        return False


def make_mesh_spatial(n_spatial: int | None = None, n_data: int = 1) -> meshlib.Mesh:
    """('data', 'spatial') mesh: batches shard over 'data', activation rows
    over 'spatial'. n_spatial=None takes every remaining rank."""
    if n_spatial is None:
        n_spatial = meshlib._world()[1] // n_data
    if n_spatial < 2:
        raise ValueError(
            f"spatial partitioning wants >= 2 devices on the 'spatial' "
            f"axis, got {n_spatial}"
        )
    return meshlib.make_mesh_2d(n_data=n_data, n_model=n_spatial,
                                axis_names=("data", "spatial"))


def spatial_editor(editor, walk_params, mesh: meshlib.Mesh,
                   min_rows_per_device: int = 8):
    """Spatial (optionally also data-parallel) inference setup, the sp
    analogue of ``mesh.replicate_editor`` -> (MeshEditor, walk, context).
    Callers run every editor program inside the context:

        ed, walk, sp = spatial_editor(ed, walk, make_mesh_spatial(2))
        with sp:
            imgs, a0, orig = ed.sweep(walk, z, panels)

    Every generator family of the port runs on rows."""
    ed, wp = meshlib.replicate_editor(editor, walk_params, mesh)
    return ed, wp, spatial_partitioning(mesh, min_rows_per_device=min_rows_per_device)


def setup_inference_mesh(opt, editor, walk_params):
    """The CLIs' device policy (vis_w / eval / serve): --sp_devices builds a
    (data x spatial) mesh and a spatial_partitioning context; otherwise
    --n_devices a data mesh; otherwise one process. -> (editor, walk_params,
    mesh, ctx); callers run every editor program inside ``with ctx:``."""
    n_dev = getattr(opt, "n_devices", None) or 1
    n_sp = getattr(opt, "sp_devices", None) or 1
    if n_sp > 1:
        mesh = make_mesh_spatial(n_spatial=n_sp, n_data=n_dev)
        ed, wp, ctx = spatial_editor(editor, walk_params, mesh)
        return ed, wp, mesh, ctx
    if n_dev > 1:
        mesh = meshlib.make_mesh(n_dev)
        ed, wp = meshlib.replicate_editor(editor, walk_params, mesh)
        return ed, wp, mesh, contextlib.nullcontext()
    return editor, walk_params, None, contextlib.nullcontext()
