"""--updateGAN under a mesh (latent2im_tpu_torch/cli/train.py:
_make_gan_provider with a mesh) on the CPU, on two launched gloo ranks.

As in the JAX package (cli/train.py:260-371 there), rank 0 alone draws the
GAN's batches and runs its D step, G step and EMA on the whole
``--batch_size`` batch, then G and D reach every rank before the walk step.
Two runs of two iterations each, at the CLI tests' tiny size (32 px,
--dev_tiny) on seeded towers written as torch checkpoints (G and D,
ResNet-50, VGG19, read through --g_path / --reg_path / --vgg_path) and
--fixed_noise:

- ``--n_devices 2 --batch_size 2``: the walk trains on a global batch of 4,
  the GAN on 2. Held to one process running the same provider (batch 2)
  before a train_loop of global batch 4, and to the JAX package's CLI with
  ``--n_devices 2`` on two devices of the virtual CPU mesh.
- ``--sp_devices 2 --batch_size 2``: the GAN runs outside the walk step's
  row plan, on the whole image. Held to the one-process CLI run.

The two packages draw from their own random streams in three places, and
every run here takes the same numbers in each (``_same_draws``): the
initial walk (a seeded array, as tests/test_torch_geometric_cli.py), the
walk step's alphas (the face sampler declines its device form, so both
loops sample on the host from the same per-epoch RandomState), and the
gradient penalty's eps (JAX's, drawn from its CLI's PRNGKey(123) stream, in
place of the port's torch stream). z and the GAN's alphas come from the same
numpy streams already, and so do the real batches once both packages'
native paths are hidden (``latent2im_tpu.native`` and
``latent2im_tpu_torch.native``: their Loaders shuffle per epoch; the
fallbacks draw as the pure-Python loader does, tests/test_torch_gan_io.py).

Gates: against one process, the walk and G and D after two iterations
rtol 1e-4, atol 1e-6 (the walk gate of tests/test_torch_spatial.py);
against the JAX CLI, tests/test_engine.py's tp gates (loss rtol 2e-4; the
walk, G, its EMA and D rtol 1e-4, atol 1e-6); G and D equal bit for bit on
both ranks; the GAN checkpoints written by rank 0 alone.
"""

from __future__ import annotations

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

from latent2im_tpu_torch.parallel import launch as L
from test_torch_spatial import SPAWN_TIMEOUT, _cli_process, _no_tensorboard

SIZE = 32
MESH_RUNS = {"dp": ["--n_devices", "2"], "sp": ["--sp_devices", "2"]}


GAN_BATCH, ITERS = 2, 2


def _gan_argv(models_dir, world, samples, *extra):
    return ["--transform", "face", "--attrList", "Smiling", "--models_dir", models_dir,
            "--overwrite_config", "--num_samples", str(samples), "--batch_size",
            str(GAN_BATCH), "--n_epochs", str(ITERS), "--dev_tiny", "--resolution", str(SIZE),
            "--model_save_freq", "0", "--fixed_noise", "--updateGAN",
            "--real_data_dir", world["real"], *world["towers"], *extra]


def _towers(root):
    """Seeded 32 px towers as torch checkpoints -> the CLI flags that read
    them (the face regressor has CelebA's 40 outputs)."""
    from latent2im_tpu_torch.engine.build import TINY_CHANNELS
    from latent2im_tpu_torch.models import resnet as rn
    from latent2im_tpu_torch.models import stylegan2 as sg2
    from latent2im_tpu_torch.models import vgg as vggm

    gen = torch.Generator().manual_seed(0)
    g = sg2.Generator(SIZE, 32, 2, channels=TINY_CHANNELS, generator=gen)
    with torch.no_grad():
        for k, p in g.named_parameters():
            if k.endswith("noise.weight"):
                p.fill_(0.3)
    d = sg2.Discriminator(SIZE, channels=TINY_CHANNELS, generator=gen)
    torch.save({"g_ema": g.state_dict(), "d": d.state_dict()}, os.path.join(root, "g.pt"))
    torch.save(rn.ResNet50(num_outputs=40, generator=gen).state_dict(),
               os.path.join(root, "reg.pt"))
    torch.save(vggm.VGG19Features(generator=gen).state_dict(), os.path.join(root, "vgg.pt"))
    return ["--g_path", os.path.join(root, "g.pt"), "--reg_path", os.path.join(root, "reg.pt"),
            "--vgg_path", os.path.join(root, "vgg.pt")]


def _walk0(shape):
    return (0.02 * np.random.RandomState(3).randn(*shape)).astype(np.float32)


def _declined(*a, **kw):
    raise ValueError("the walk's alphas are drawn on the host")


@contextlib.contextmanager
def _same_draws(eps):
    """The port's CLI draws the JAX CLI's numbers (the module docstring):
    the seeded initial walk, host alphas, and ``eps`` (the penalty's
    weights per GAN step, in order)."""
    from latent2im_tpu_torch.cli import train as tcli
    from latent2im_tpu_torch.engine import build as tbuild
    from latent2im_tpu_torch.tasks import transforms as ttasks

    real_init = tbuild.init_walk
    it = iter(eps)

    def init_walk(*a, **kw):
        return {k: torch.from_numpy(_walk0(v.shape)) for k, v in real_init(*a, **kw).items()}

    def draw_eps(generator, b, device):
        return torch.from_numpy(next(it)).to(device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "latent2im_tpu_torch.native", None)  # the fallback's batches
        mp.setattr(tbuild, "init_walk", init_walk)
        mp.setattr(tcli, "draw_eps", draw_eps)
        mp.setattr(ttasks.FaceTransform, "train_alpha", _declined)
        yield


def _real_pngs(root):
    from latent2im_tpu_torch.utils import image as imgmod

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(0)
    for i, (h, w) in enumerate([(40, 36), (36, 48), (32, 32)]):
        with open(os.path.join(root, f"{i}.png"), "wb") as f:
            f.write(imgmod.png_bytes(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)))
    return root


def _state(m):
    return {k: v.detach().numpy().copy() for k, v in m.state_dict().items()}


def gan_rank(root, world):
    """Both mesh runs of cli.train on this rank -> {run: (walk, losses, G, D,
    broadcasts, GAN checkpoint writes by rank, G and D equal on every rank)}."""
    import warnings

    import torch.distributed as dist

    from latent2im_tpu_torch.cli import train as tcli
    from latent2im_tpu_torch.config import options
    from latent2im_tpu_torch.io import checkpoint as ckpt

    torch.set_num_threads(1)
    _no_tensorboard()
    warnings.simplefilter("ignore")
    made, saves = {}, []
    real_make, real_save = tcli._make_gan_provider, ckpt.save_gan

    def make(editor, *a, **kw):
        made["editor"] = editor
        made["provider"] = real_make(editor, *a, **kw)
        return made["provider"]

    def save(*a, **kw):
        saves.append(dist.get_rank())
        return real_save(*a, **kw)

    tcli._make_gan_provider, ckpt.save_gan = make, save
    out = {}
    try:
        for name, flags in MESH_RUNS.items():
            saves.clear()
            samples = 4 if name == "dp" else 2  # one iteration an epoch
            opt = options.TrainOptions().parse(
                _gan_argv(os.path.join(root, name), world, samples, *flags),
                print_opt=dist.get_rank() == 0)
            with _same_draws(world["eps"]):
                walk, hist = tcli.run(opt, device="cpu")
            ed = made["editor"]
            g, d = _state(ed.g), _state(ed.d)
            objs = [None] * dist.get_world_size()
            dist.all_gather_object(objs, (g, d, list(saves)))
            equal = all(np.array_equal(o[i][k], (g, d)[i][k]) for o in objs
                        for i in range(2) for k in (g, d)[i])
            out[name] = {"walk": walk["w"].numpy(), "hist": hist, "g": g, "d": d,
                         "broadcasts": made["provider"].broadcasts,
                         "param_bytes": sum(p.numel() * p.element_size()
                                            for m in (ed.g, ed.d) for p in m.parameters()),
                         "saves": sorted(r for o in objs for r in o[2]),
                         "equal_on_ranks": equal, "dir": opt.output_dir}
    finally:
        tcli._make_gan_provider, ckpt.save_gan = real_make, real_save
    return out


def _jax_eps(n):
    """The penalty's eps of the JAX CLI's first n GAN steps: its
    _make_gan_provider splits PRNGKey(123) once a step and its d_step draws
    U[0, 1) of [batch, 1, 1, 1] from the second key."""
    import jax

    key, out = jax.random.PRNGKey(123), []
    for _ in range(n):
        key, k1 = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(k1, (GAN_BATCH, 1, 1, 1)), np.float32))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("gan_mesh")
    return {"root": str(root), "real": _real_pngs(str(root / "real")),
            "towers": _towers(str(root)), "eps": _jax_eps(ITERS)}


@pytest.fixture(scope="module")
def ranks(world):
    return L.launch(gan_rank, (os.path.join(world["root"], "ranks"), world), world_size=2,
                    device="cpu", timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def jax_cli(world):
    """The JAX package's CLI, ``--n_devices 2`` (two devices of the virtual
    CPU mesh, a global walk batch of 4), on the same towers and draws ->
    (walk, losses, run dir)."""
    import jax.numpy as jnp

    from latent2im_tpu.cli import train as jcli
    from latent2im_tpu.config import options as joptions
    from latent2im_tpu.engine import build as jbuild
    from latent2im_tpu.tasks import transforms as jtasks

    real_init = jbuild.init_walk
    with _cli_process(), pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "latent2im_tpu.native", None)
        mp.setattr(jbuild, "init_walk", lambda *a, **kw: {
            k: jnp.asarray(_walk0(v.shape)) for k, v in real_init(*a, **kw).items()})
        mp.setattr(jtasks.FaceTransform, "train_alpha", _declined)
        opt = joptions.TrainOptions().parse(
            _gan_argv(os.path.join(world["root"], "jax"), world, 4, "--n_devices", "2"),
            print_opt=True)
        walk, hist = jcli.run(opt)
    return np.asarray(walk["w"]), hist, opt.output_dir


@pytest.fixture(scope="module")
def single(world):
    """One process: the dp run's provider (batch 2) before a train_loop of
    global batch 4, and the sp run's CLI run as it is."""
    from latent2im_tpu_torch.cli import train as tcli
    from latent2im_tpu_torch.config import options
    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.engine.train import train_loop
    from latent2im_tpu_torch.tasks.transforms import get_task, task_kwargs_from_options

    root = world["root"]
    out = {}
    with _cli_process(), _same_draws(world["eps"] * 2):
        opt = options.TrainOptions().parse(_gan_argv(os.path.join(root, "one_dp"), world, 4),
                                           print_opt=True)
        ed, walk, info = build_editor_from_options(opt, device="cpu")
        task = get_task(opt.transform, walk_type=opt.walk_type,
                        nsliders=len(info["attr_list"]), **task_kwargs_from_options(opt))
        provider = tcli._make_gan_provider(ed, opt, task, walk)
        try:
            walk, hist = train_loop(ed, task, walk, num_samples=4, batch_size=4, n_epochs=2,
                                    lr=opt.learning_rate, log_every=1, frozen_provider=provider)
        finally:
            provider.close()
        out["dp"] = {"walk": walk["w"].detach().numpy(), "hist": hist, "g": _state(ed.g),
                     "d": _state(ed.d)}
        made = {}
        real_make = tcli._make_gan_provider

        def make(editor, *a, **kw):
            made["editor"] = editor
            return real_make(editor, *a, **kw)

        tcli._make_gan_provider = make
        try:
            opt = options.TrainOptions().parse(
                _gan_argv(os.path.join(root, "one_sp"), world, 2), print_opt=True)
            walk, hist = tcli.run(opt, device="cpu")
        finally:
            tcli._make_gan_provider = real_make
        out["sp"] = {"walk": walk["w"].detach().numpy(), "hist": hist,
                     "g": _state(made["editor"].g), "d": _state(made["editor"].d),
                     "dir": opt.output_dir}
    return out


@pytest.mark.parametrize("name", sorted(MESH_RUNS))
def test_update_gan_on_a_mesh_matches_one_process(name, ranks, single):
    got, want = ranks[name], single[name]
    np.testing.assert_allclose(got["hist"], want["hist"], rtol=2e-4)
    np.testing.assert_allclose(got["walk"], want["walk"], rtol=1e-4, atol=1e-6)
    for tower in ("g", "d"):
        assert got[tower].keys() == want[tower].keys()
        for k in want[tower]:
            np.testing.assert_allclose(got[tower][k], want[tower][k], rtol=1e-4, atol=1e-6,
                                       err_msg=(tower, k))


@pytest.mark.parametrize("name", sorted(MESH_RUNS))
def test_update_gan_towers_equal_on_every_rank_and_rank_0_writes(name, ranks):
    """G and D bit for bit on both ranks after the last broadcast; the final
    GAN checkpoint written once, by rank 0; one broadcast at the start and
    one per iteration, each of G's and D's parameters."""
    got = ranks[name]
    assert got["equal_on_ranks"]
    assert got["saves"] == [0]
    assert os.path.isfile(os.path.join(got["dir"], "model_gan_2_final.ckpt"))
    assert len(got["broadcasts"]) == 3
    assert all(b["bytes"] == got["param_bytes"] and b["ms"] >= 0 for b in got["broadcasts"])


def test_update_gan_on_two_data_ranks_matches_the_jax_cli(ranks, jax_cli):
    """The dp run against the JAX CLI's ``--n_devices 2 --updateGAN``: the
    losses, the walk, and the final GAN checkpoint's live G, its EMA and D
    (both written in the JAX package's layout, read by its loader)."""
    from latent2im_tpu.io import checkpoint as jckpt

    got = ranks["dp"]
    jwalk, jhist, jdir = jax_cli
    assert len(got["hist"]) == len(jhist) == ITERS
    np.testing.assert_allclose(got["hist"], jhist, rtol=2e-4)
    np.testing.assert_allclose(got["walk"], jwalk, rtol=1e-4, atol=1e-6)
    name = f"model_gan_{ITERS}_final.ckpt"
    want = jckpt.load_gan_state(os.path.join(jdir, name))
    tree = jckpt.load_gan_state(os.path.join(got["dir"], name))
    for tower in ("g", "g_running", "d"):
        leaves = dict(_raw_leaves(tree[tower]))
        ref = dict(_raw_leaves(want[tower]))
        assert leaves.keys() == ref.keys() and len(ref) > 10, tower
        for k, v in ref.items():
            np.testing.assert_allclose(np.asarray(leaves[k]), np.asarray(v), rtol=1e-4,
                                       atol=1e-6, err_msg=(tower, k))


def _raw_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _raw_leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _raw_leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree
