"""Process mesh and data parallelism over ``torch.distributed`` — the
counterpart of the JAX package's parallel/mesh.py.

JAX drives every chip from one process and lets XLA insert the collectives.
PyTorch runs one process per rank (parallel/launch.py starts them), so this
module holds what those ranks share:

- ``Mesh``: the world's ranks as a (data x model|spatial) grid, rank =
  data_index * n_model + model_index, one process group per line of each
  axis; ``mesh.shape`` is indexed by axis name as JAX's is. A mesh built
  without a process group (one process) has none, and every collective
  below is then identity; in a group of one rank (a one-rank NCCL group)
  the collectives run.
- ``shard_batch`` / ``pad_to_devices``: this rank's slice of a host global
  batch (JAX ``shard_batch`` places the same slices on the chips).
- ``replicate`` / ``replicate_editor``: broadcast parameters from rank 0.
- ``MeshEditor``: the Editor's inference programs over a mesh. Every rank
  calls the same methods in the same order; the batch shards over 'data'
  (padded by repeating the last row), the results gather back over 'data'
  and the padding is sliced off, so every rank holds the global result.
- ``BatchGather``: the differentiable all-gather over 'data' that D's
  minibatch-stddev layer takes in a data-parallel step (models/hooks.py),
  so its groups span ranks as in the JAX step's global batch.
- ``average_gradients``: one all-reduce of the walk gradient, averaged over
  'data' and summed over 'spatial' (each spatial rank holds the gradient of
  its own rows, parallel/spatial.py).

The backend is an explicit choice (``choose_backend``): NCCL when every rank
has a card of its own, gloo when ranks share a card or run on the CPU. Gloo
takes CUDA tensors for all_reduce, broadcast and all_gather (PyTorch 2.11);
its send and recv do not, so the halo swaps cross through host copies
(``_to_wire``). NCCL moves only device tensors (``all_gather_into_tensor``,
``batch_isend_irecv``): a host tensor that crosses ranks under it (a stop
flag, Adam's step count) goes through this rank's card and back.
``Mesh.transport`` names the route.

- ``stylegan2_tp_specs`` / ``frozen_tp_shardings``: the tensor-parallel
  layout of the frozen towers on a (data x model) mesh, as JAX's, and the
  one place it is decided: ``make_train_step(frozen_shardings=)`` cuts G's
  parameters to this rank's slices by it, and sets each sharded conv's
  role, through parallel/tensor.py, which holds the Megatron operators.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..walks import walk_leaves

log = logging.getLogger(__name__)

# how long a rank waits in one collective; a run itself has no deadline
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=30)


def choose_backend(device_type: str, world_size: int, device_count: int) -> str:
    """NCCL when every rank has a card of its own; gloo when ranks share a
    card (NCCL refuses two ranks on one device) or run on the CPU."""
    if device_type == "cuda" and world_size <= device_count:
        return "nccl"
    return "gloo"


def _world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, device_type: str = "cuda") -> int:
    """Join the process group once per process -> this process's rank.

    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)
    wins when it is set; else ``coordinator`` ("host:port") with
    ``num_processes`` and ``process_id``; else one process, nothing to join.
    A CUDA rank takes card LOCAL_RANK (or its rank) modulo the card count.
    The backend is logged and kept in the group (``dist.get_backend()``)."""
    if dist.is_initialized():
        return dist.get_rank()
    env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if env:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        method = "env://"
    elif num_processes is not None and num_processes > 1:
        if coordinator is None or process_id is None:
            raise ValueError("num_processes > 1 needs coordinator and process_id")
        rank, world, method = int(process_id), int(num_processes), f"tcp://{coordinator}"
    else:
        return 0
    count = torch.cuda.device_count() if device_type == "cuda" else 0
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % count)
    backend = choose_backend(device_type, world, count)
    log.info("torch.distributed: rank %d of %d, backend %s", rank, world, backend)
    dist.init_process_group(backend, init_method=method, rank=rank, world_size=world,
                            timeout=COLLECTIVE_TIMEOUT)
    return rank


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's view of the (axis_names) grid of ranks."""

    axis_names: tuple[str, ...]
    shape: dict[str, int]
    coords: dict[str, int]
    groups: dict[str, object]  # axis -> ProcessGroup; None: nothing to cross
    members: dict[str, list[int]]  # axis -> global ranks of this rank's line
    rank: int
    backend: str | None
    # {"seconds", "bytes", "calls"} of the collectives when a caller measures
    # them: each is then timed between two device synchronisations
    stats: dict | None = None

    @property
    def is_main(self) -> bool:
        """Rank 0 writes the files, logs and reports."""
        return self.rank == 0

    @property
    def transport(self) -> str:
        """How a CUDA tensor crosses ranks."""
        if self.backend is None:
            return "local"
        if self.backend == "nccl":
            return "nccl (device)"
        return "gloo (all_reduce, broadcast, all_gather on the device; halo send/recv via host)"

    def data_slice(self, n: int) -> tuple[int, int]:
        """This rank's rows [lo, hi) of a global batch of n (n must divide)."""
        nd, i = self.shape.get("data", 1), self.coords.get("data", 0)
        if n % nd:
            raise ValueError(f"batch of {n} does not divide the {nd}-rank data axis")
        return i * (n // nd), (i + 1) * (n // nd)


def _build(sizes: tuple[int, ...], axis_names: tuple[str, ...]) -> Mesh:
    rank, world = _world()
    need = int(np.prod(sizes))
    if need != world:
        raise ValueError(f"the mesh takes {need} ranks and the world has {world}: "
                         f"launch exactly {need} (parallel/launch.py)")
    grid = np.arange(need).reshape(sizes)
    coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(rank, sizes))))
    backend = dist.get_backend() if dist.is_initialized() else None
    groups, members = {}, {}
    for ax, name in enumerate(axis_names):
        # every rank creates every group, in the same order (new_group's rule);
        # a one-rank world's axes are its own group
        lines = np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax])
        for line in lines:
            ranks = [int(r) for r in line]
            if len(ranks) > 1:
                g = dist.new_group(ranks)
            else:
                g = dist.group.WORLD if backend is not None and world == 1 else None
            if rank in ranks:
                groups[name], members[name] = g, ranks
    return Mesh(tuple(axis_names), dict(zip(axis_names, sizes)), coords, groups,
                members, rank, backend)


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D ('data',) mesh over every rank; n_devices must equal the world."""
    _, world = _world()
    n = world if n_devices is None else n_devices
    if n < 1 or n > world:
        raise ValueError(f"(data) mesh wants {n} devices, have {world}")
    return _build((n,), ("data",))


def make_mesh_2d(n_data: int | None = None, n_model: int = 1,
                 axis_names: tuple[str, str] = ("data", "model")) -> Mesh:
    """(data x model) grid of ranks; axis_names lets spatial.make_mesh_spatial
    name the second axis 'spatial'. The JAX package's errors."""
    _, world = _world()
    if n_data is None:
        n_data = world // n_model
    need = n_data * n_model
    if n_data < 1 or need > world:
        raise ValueError(
            f"({axis_names[0]} x {axis_names[1]}) mesh wants "
            f"{n_data}x{n_model} = {need} devices, have {world}"
        )
    return _build((n_data, n_model), tuple(axis_names))


# ---------------------------------------------------------------------------
# collectives (identity where there is no group to cross)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _measured(mesh: Mesh, t: torch.Tensor):
    """Add the collective's time and the bytes this rank sends to
    ``mesh.stats`` (when set)."""
    if mesh.stats is None:
        yield
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    yield
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    mesh.stats["seconds"] += time.perf_counter() - t0
    mesh.stats["bytes"] += t.numel() * t.element_size()
    mesh.stats["calls"] += 1


def _to_wire(mesh: Mesh, t: torch.Tensor, p2p: bool = False) -> torch.Tensor:
    """t where the backend takes it: NCCL only from a card (a host tensor
    goes to this rank's card), gloo's send and recv (``p2p``) only from the
    host (a CUDA tensor crosses through a host copy)."""
    t = t.contiguous()
    if mesh.backend == "nccl" and not t.is_cuda:
        return t.to(torch.cuda.current_device())
    if mesh.backend == "gloo" and p2p and t.is_cuda:
        return t.cpu()
    return t


def all_gather(mesh: Mesh, axis: str, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The tensors of the axis's ranks (equal shapes), in rank order,
    concatenated along ``dim``."""
    n = mesh.shape.get(axis, 1)
    if mesh.groups.get(axis) is None:
        return t
    with _measured(mesh, t):
        w = _to_wire(mesh, t)
        if mesh.backend == "nccl":
            out = w.new_empty((n,) + tuple(w.shape))
            dist.all_gather_into_tensor(out, w, group=mesh.groups[axis])
            parts = list(out.unbind(0))
        else:
            parts = [torch.empty_like(w) for _ in range(n)]
            dist.all_gather(parts, w, group=mesh.groups[axis])
        return torch.cat(parts, dim).to(t.device)


def all_reduce(mesh: Mesh, t: torch.Tensor, axis: str | None = None) -> torch.Tensor:
    """Sum over the axis's ranks (every rank of the mesh: axis None); a new
    tensor."""
    group = None if axis is None else mesh.groups.get(axis)
    if mesh.backend is None or (axis is not None and group is None):
        return t.clone()
    with _measured(mesh, t):
        w = _to_wire(mesh, t.clone())
        dist.all_reduce(w, group=group)
        return w.to(t.device)


def broadcast_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Overwrite t in place with rank 0's."""
    if mesh.backend is None:
        return t
    with _measured(mesh, t):
        w = _to_wire(mesh, t)
        dist.broadcast(w, src=0)
        if w is not t:
            t.copy_(w)
    return t


def broadcast_object(mesh: Mesh, obj=None):
    """Rank 0's picklable object on every rank."""
    if mesh.backend is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def exchange(mesh: Mesh, axis: str, to_prev: torch.Tensor, to_next: torch.Tensor):
    """Neighbour swap along ``axis``: send ``to_prev`` to the previous rank
    and ``to_next`` to the next -> (what the previous rank sent its next,
    what the next rank sent its previous); zeros where there is no
    neighbour. Point to point (``batch_isend_irecv``)."""
    n, i = mesh.shape[axis], mesh.coords[axis]
    ranks, group = mesh.members[axis], mesh.groups[axis]
    from_prev, from_next = torch.zeros_like(to_next), torch.zeros_like(to_prev)
    if n == 1:
        return from_prev, from_next
    with _measured(mesh, to_prev):
        send_p, send_n = _to_wire(mesh, to_prev, True), _to_wire(mesh, to_next, True)
        recv_p, recv_n = torch.zeros_like(send_n), torch.zeros_like(send_p)
        ops = []
        if i > 0:
            ops += [dist.P2POp(dist.isend, send_p, ranks[i - 1], group),
                    dist.P2POp(dist.irecv, recv_p, ranks[i - 1], group)]
        if i < n - 1:
            ops += [dist.P2POp(dist.isend, send_n, ranks[i + 1], group),
                    dist.P2POp(dist.irecv, recv_n, ranks[i + 1], group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv_p.to(to_prev.device), recv_n.to(to_prev.device)


# ---------------------------------------------------------------------------
# batches and parameters
# ---------------------------------------------------------------------------


def pad_to_devices(n: int, n_dev: int) -> int:
    """Round a global batch up so it divides the mesh."""
    return ((n + n_dev - 1) // n_dev) * n_dev


def _pad_rows(a, m: int, axis: int):
    """a with its last entry along ``axis`` repeated up to length m."""
    n = a.shape[axis]
    if n == m:
        return a
    if isinstance(a, torch.Tensor):
        last = a.narrow(axis, n - 1, 1)
        return torch.cat([a] + [last] * (m - n), axis)
    last = np.take(np.asarray(a), [n - 1], axis=axis)
    return np.concatenate([np.asarray(a), np.repeat(last, m - n, axis=axis)], axis)


def shard_batch(mesh: Mesh, host_batch, pad: bool = False, axis: int = 0):
    """This rank's slice along ``axis`` of a host global batch (numpy or a
    tensor, returned as the same type).

    The batch shards over the 'data' axis only (replicated over the other),
    so that is the divisibility rule; pad=True rounds it up to
    ``pad_to_devices`` by repeating the last row (inference over a ragged
    last batch: callers slice results back to the true length). Training
    batches must divide exactly: padded rows would bias gradients."""
    n_dev = int(mesh.shape.get("data", 1))
    n = host_batch.shape[axis]
    if n % n_dev:
        if not pad:
            raise ValueError(
                f"batch of {n} does not divide the {n_dev}-device mesh; "
                "pass pad=True (inference) or size batches as a multiple "
                "(training)"
            )
        host_batch = _pad_rows(host_batch, pad_to_devices(n, n_dev), axis)
    lo, hi = mesh.data_slice(host_batch.shape[axis])
    idx = [slice(None)] * host_batch.ndim
    idx[axis] = slice(lo, hi)
    return host_batch[tuple(idx)]


def _tensors(tree) -> list:
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, torch.optim.Optimizer):
        return [v for st in tree.state.values() for v in st.values()
                if isinstance(v, torch.Tensor)]
    return [t for t in walk_leaves(tree) if isinstance(t, torch.Tensor)]


@torch.no_grad()
def replicate(mesh: Mesh, tree):
    """Rank 0's values in every tensor of ``tree`` (a tensor, a walk dict
    or list, a module's parameters and buffers, or an optimizer's state),
    in place, one broadcast per device and dtype; returns tree."""
    if mesh.backend is None:
        return tree
    groups = {}
    for t in _tensors(tree):
        groups.setdefault((t.device, t.dtype), []).append(t)
    for ts in groups.values():
        flat = broadcast_(mesh, torch.cat([t.reshape(-1) for t in ts]))
        off = 0
        for t in ts:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
    return tree


def tree_bytes(tree) -> int:
    """The bytes of the tensors ``replicate`` would broadcast."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def replicate_editor(editor, walk_params, mesh: Mesh | None):
    """Data-parallel inference setup: the towers and the walk replicated
    from rank 0 -> (MeshEditor, walk). Callers then hand the MeshEditor
    host-shaped batches, which it shards over 'data' itself."""
    if mesh is None:
        return editor, walk_params
    for m in (editor.g, editor.reg, editor.vgg, editor.d):
        if m is not None:
            replicate(mesh, m)
    return MeshEditor(editor, mesh), replicate(mesh, walk_params)


# the sharded axis of each parameter of a sharded conv (rosinality layout:
# ModulatedConv2d.weight [1, Cout, Cin, k, k], FusedLeakyReLU.bias [Cout])
COUT, CIN = 1, 2


def stylegan2_tp_specs(g) -> dict[str, int | None]:
    """{parameter name: its sharded axis over 'model', or None (replicated)}
    for a models.stylegan2 Generator, the JAX package's
    ``stylegan2_tp_specs``: each up-conv (``convs.{2j}``) column-parallel,
    its weight on Cout and ``activate.bias`` with it; each partner conv
    (``convs.{2j+1}``) row-parallel, its weight on Cin; everything else
    replicated."""
    specs = dict.fromkeys((name for name, _ in g.named_parameters()), None)
    for i in range(len(g.convs)):
        if i % 2 == 0:
            specs[f"convs.{i}.conv.weight"] = COUT
            specs[f"convs.{i}.activate.bias"] = 0
        else:
            specs[f"convs.{i}.conv.weight"] = CIN
    return specs


@dataclasses.dataclass(frozen=True)
class TpShardings:
    """The frozen towers' tensor-parallel layout on a (data x model) mesh:
    ``specs[tower]`` maps parameter names to sharded axes (None: the tower
    replicates). parallel/tensor.py:shard_generator applies G's."""

    mesh: meshlib.Mesh
    specs: dict


def frozen_tp_shardings(mesh: meshlib.Mesh, frozen: dict) -> TpShardings:
    """The JAX package's ``frozen_tp_shardings`` for ``Editor.frozen_params()``
    on a (data x model) mesh: the StyleGAN2 generator tensor-shards over
    'model' (``stylegan2_tp_specs``), the other towers replicate.
    ``make_train_step(frozen_shardings=)`` takes the result."""
    from ..models import stylegan2 as sg2  # the models import the parallel hooks

    if "model" not in mesh.shape:
        raise ValueError(f"tensor parallelism needs a 'model' mesh axis, got {mesh.axis_names}")
    specs = {k: None for k in frozen}
    if isinstance(frozen.get("g"), sg2.Generator):
        specs["g"] = stylegan2_tp_specs(frozen["g"])
    return TpShardings(mesh, specs)


# ---------------------------------------------------------------------------
# data-parallel training
# ---------------------------------------------------------------------------


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        return all_gather(mesh, "data", x, 0)

    @staticmethod
    def backward(ctx, g):
        # every data rank's loss reaches this rank's rows through the
        # statistic: sum the cotangents, keep this rank's rows
        lo = ctx.mesh.coords["data"] * ctx.n
        return all_reduce(ctx.mesh, g, "data")[lo:lo + ctx.n], None


class BatchGather:
    """x [b, ...] -> (the global batch [n_data * b, ...], this rank's first
    row in it); differentiable. Installed in models/hooks.py by a
    data-parallel training step."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def __call__(self, x):
        return _GatherBatch.apply(x, self.mesh), self.mesh.coords["data"] * x.shape[0]


def average_gradients(mesh: Mesh, params) -> None:
    """In place: each tensor's .grad summed in one all-reduce, divided by
    the data axis: averaged over 'data', summed over 'spatial' (each spatial
    rank holds its rows' share), and not reduced over 'model' (under tensor
    parallelism every model rank holds the whole gradient already)."""
    if mesh.backend is None:
        return
    grads = [p.grad for p in params]
    axis = "data" if "model" in mesh.shape else None
    flat = all_reduce(mesh, torch.cat([g.reshape(-1) for g in grads]), axis)
    flat /= mesh.shape.get("data", 1)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def mean_over_data(mesh: Mesh, metrics: dict) -> dict:
    """0-dim metrics averaged over 'data' (one all-reduce)."""
    nd = mesh.shape.get("data", 1)
    if mesh.groups.get("data") is None:
        return metrics
    keys = sorted(metrics)
    v = all_reduce(mesh, torch.stack([metrics[k].float() for k in keys]), "data") / nd
    return dict(zip(keys, v.unbind(0)))


def any_rank(mesh: Mesh | None, flag: bool) -> bool:
    """True on every rank when it is true on one (a stop every rank agrees
    on, so no rank waits alone in a collective)."""
    if mesh is None or mesh.backend is None:
        return bool(flag)
    return bool(all_reduce(mesh, torch.tensor([float(flag)])).item() > 0)


# ---------------------------------------------------------------------------
# inference over a mesh
# ---------------------------------------------------------------------------


class MeshEditor:
    """An Editor's inference programs over a mesh, on host-shaped batches.

    Every rank calls the same methods in the same order. Batch arguments
    shard over 'data' with ``shard_batch(pad=True)``, the local Editor runs
    on the slice (inside the caller's spatial context, if any), and the
    results gather back over 'data' with the padding sliced off: every rank
    returns the global result. Everything else reads through to the Editor."""

    def __init__(self, editor, mesh: Mesh):
        self.editor, self.mesh = editor, mesh

    def __getattr__(self, name):
        return getattr(self.editor, name)

    def _shard(self, a, axis: int = 0):
        if a is None:
            return None
        if not isinstance(a, torch.Tensor):
            a = np.asarray(a, np.float32)
        return shard_batch(self.mesh, a, pad=True, axis=axis)

    def _gather(self, t, n: int, axis: int = 0):
        return all_gather(self.mesh, "data", t, axis).narrow(axis, 0, n)

    def synthesize(self, latent, noise_generator=None):
        """noise_generator draws the global batch's noise (as one process
        draws it), sliced per rank."""
        n = len(latent)
        noise = None
        if noise_generator is not None:
            glob = self.editor.make_noise(n, noise_generator)
            noise = None if glob is None else [self._shard(t) for t in glob]
        with torch.inference_mode():
            img = self.editor.synth(self.editor._tensor(self._shard(latent)), noise)
        return self._gather(img, n)

    def regress(self, img):
        return self._gather(self.editor.regress(self._shard(img)), len(img))

    def regress_all(self, img):
        return self._gather(self.editor.regress_all(self._shard(img)), len(img))

    def apply_alpha(self, walk_params, z, alpha_to_graph, given_w=None, index=None,
                    u8: bool = False):
        n = len(z)
        a = np.asarray(alpha_to_graph, np.float32) if not isinstance(
            alpha_to_graph, torch.Tensor) else alpha_to_graph
        if a.ndim == 0:
            a = a.reshape(1).repeat(n) if isinstance(a, torch.Tensor) else np.repeat(a, n)
        out = self.editor.apply_alpha(walk_params, self._shard(z), self._shard(a),
                                      given_w=self._shard(given_w), index=index, u8=u8)
        return tuple(self._gather(t, n) for t in out)

    def sweep(self, walk_params, z, panel_alphas, given_w=None, chunk=None,
              u8: bool = False):
        n = len(z)
        imgs, alpha_org, orig = self.editor.sweep(
            walk_params, self._shard(z), self._shard(panel_alphas, axis=1),
            given_w=self._shard(given_w), chunk=chunk, u8=u8)
        return self._gather(imgs, n, 1), self._gather(alpha_org, n), self._gather(orig, n)

    def apply_alpha_combine(self, walk_params, z, alphas_per_attr, indices, given_w=None):
        n = len(z)
        out = self.editor.apply_alpha_combine(
            walk_params, self._shard(z), [self._shard(a) for a in alphas_per_attr],
            indices, given_w=self._shard(given_w))
        return tuple(self._gather(t, n) for t in out)

    def sweep_combine(self, walk_params, z, panel_alphas, indices, given_w=None,
                      u8: bool = False):
        n = len(z)
        imgs, alpha_org, orig = self.editor.sweep_combine(
            walk_params, self._shard(z), panel_alphas, indices,
            given_w=self._shard(given_w), u8=u8)
        return self._gather(imgs, n, 2), self._gather(alpha_org, n), self._gather(orig, n)
