"""Tensor parallelism (tp) of StyleGAN2 synthesis over a 'model' mesh axis —
the counterpart of the JAX package's ``stylegan2_tp_specs`` /
``frozen_tp_shardings`` (parallel/mesh.py there).

JAX shards the generator's parameters with NamedShardings and lets GSPMD
insert one psum per block. Here each rank is a process: ``shard_generator``
cuts the parameters that ``mesh.stylegan2_tp_specs`` shards to this rank's
slices, in place, and marks each sharded ``StyledConv`` with its role and
channels (``tp_shard``), so a rank holds only its slice of those weights.
The tp plan (``TpPlan``, installed in models/hooks.py by
``tensor_parallel``) carries the model group, and two Megatron operators
over it do what GSPMD does:

- ``copy_to_model``: identity forward, all-reduce backward. It goes where a
  replicated tensor enters a sharded conv (x and the style into an up-conv,
  the style into a partner conv): each rank's gradient of it covers only its
  own slice of the channels, and their sum is the whole gradient.
- ``reduce_from_model``: all-reduce forward, identity backward. It sums the
  partner conv's partial products and the partial sums of squares of its
  demodulation (one all-reduce of both, in f32). Every rank then holds the
  whole activation and computes the same loss, so the gradient that reaches
  each rank's partial is already the whole one.

Per block (Megatron's column/row alternation, as the specs say):

- the up-conv (``convs[2j]``) is column-parallel: it keeps output channels
  [lo, hi) of its weight and of ``activate.bias``, and runs its transposed
  conv, blur, noise and ``fused_leaky_relu`` on that slice. Its demodulation
  sums over all of Cin, which the rank holds: no collective.
- the partner 3x3 conv (``convs[2j + 1]``) is row-parallel: it keeps input
  channels [lo, hi) of its weight, takes those of x (the up-conv's output on
  this rank) and of s, runs ``ops.styled_conv3x3_partial`` (the kernel's
  product without its epilogue), ``reduce_from_model``, then
  ``ops.styled_conv3x3_epilogue`` with d from the summed sigma.

``conv1``, ``to_rgb1``, the ``to_rgbs``, the style MLP and the noise maps
stay whole and run replicated. A sharded G runs only under its plan (its
convs raise otherwise), so ``make_train_step(frozen_shardings=
mesh.frozen_tp_shardings(mesh, editor.frozen_params()))`` shards the
editor's G for that step, and the editor serves tp steps from then on. tp
combines with data parallelism (a (data x model) mesh, parallel/mesh.py:
make_mesh_2d) and not with spatial partitioning, as in JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models import hooks as _hooks
from . import mesh as meshlib


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return meshlib.all_reduce(ctx.mesh, g.contiguous(), ctx.axis), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axis, *parts):
        flat = meshlib.all_reduce(mesh, torch.cat([p.reshape(-1) for p in parts]), axis)
        out, off = [], 0
        for p in parts:
            out.append(flat[off:off + p.numel()].view_as(p))
            off += p.numel()
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *grads)


def copy_to_model(mesh: meshlib.Mesh, x, axis: str = "model"):
    """x as is; its gradient summed over the ``axis`` ranks."""
    return _CopyToModel.apply(x, mesh, axis)


def reduce_from_model(mesh: meshlib.Mesh, *parts, axis: str = "model") -> tuple:
    """Each of ``parts`` summed over the ``axis`` ranks, in one all-reduce
    (they share a dtype); identity backward."""
    return _ReduceFromModel.apply(mesh, axis, *parts)


class TpPlan:
    """This rank's share of the sharded convs' channels on ``mesh``'s
    ``axis``; ``reduced_bytes`` counts what its forward all-reduces sent."""

    def __init__(self, mesh: meshlib.Mesh, axis: str = "model"):
        self.mesh, self.axis = mesh, axis
        self.n, self.index = int(mesh.shape[axis]), int(mesh.coords[axis])
        self.reduced_bytes = 0

    def channels(self, c: int) -> tuple[int, int]:
        """This rank's channels [lo, hi) of c."""
        if c % self.n:
            raise ValueError(f"{c} channels do not divide the {self.n}-rank '{self.axis}' axis")
        step = c // self.n
        return self.index * step, (self.index + 1) * step

    def copy(self, x):
        return copy_to_model(self.mesh, x, self.axis)

    def reduce(self, *parts) -> tuple:
        self.reduced_bytes += sum(p.numel() * p.element_size() for p in parts)
        return reduce_from_model(self.mesh, *parts, axis=self.axis)


class Shard(NamedTuple):
    """A sharded conv's part on this rank: channels [lo, hi) of ``whole``,
    output channels for a "column" conv, input channels for a "row" one."""

    role: str
    lo: int
    hi: int
    whole: int


_ROLES = {meshlib.COUT: "column", meshlib.CIN: "row"}


@torch.no_grad()
def shard_generator(g, specs: dict, mesh: meshlib.Mesh, axis: str = "model"):
    """Cut each parameter of ``g`` that ``specs`` ({name: sharded axis or
    None}, mesh.stylegan2_tp_specs) shards to this rank's slice on its axis,
    in place, and set each sharded StyledConv's ``tp_shard`` from its
    weight's axis: "column" on Cout, "row" on Cin. A conv already cut to the
    same shard is left as it is; returns g."""
    plan = TpPlan(mesh, axis)
    params = dict(g.named_parameters())
    for name, dim in specs.items():
        if dim is None or not name.endswith(".conv.weight"):
            continue
        prefix = name[:-len(".conv.weight")]
        conv = g.get_submodule(prefix)
        if conv.tp_shard is not None:
            whole = conv.tp_shard.whole
            if conv.tp_shard != Shard(_ROLES[dim], *plan.channels(whole), whole):
                raise ValueError(f"{prefix} holds another layout's shard")
            continue
        whole = params[name].shape[dim]
        lo, hi = plan.channels(whole)
        bias = f"{prefix}.activate.bias"
        for k, d in ((name, dim), (bias, specs.get(bias))):
            if d is not None:
                params[k].data = params[k].data.narrow(d, lo, hi - lo).clone()
        conv.tp_shard = Shard(_ROLES[dim], lo, hi, whole)
    return g


class tensor_parallel:
    """Install a tp plan for the generator forwards run inside the context.

    A reusable, nestable class (the previous plan restores from a
    per-instance stack), as ``spatial.spatial_partitioning``. ``plan`` is
    the installed plan."""

    def __init__(self, mesh: meshlib.Mesh, axis: str = "model"):
        self.plan = TpPlan(mesh, axis)
        self._stack = []

    def __enter__(self):
        if _hooks.row_plan() is not None:
            raise ValueError("tensor parallelism does not combine with spatial partitioning")
        self._stack.append(_hooks.install_tp(self.plan))
        return self

    def __exit__(self, *exc):
        _hooks.restore_tp(self._stack.pop())
        return False
