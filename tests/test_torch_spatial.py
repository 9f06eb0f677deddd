"""Data and spatial parallelism of the port (latent2im_tpu_torch/parallel/)
against the single-process port and the JAX package's single-device
results, on the CPU.

Each mesh shape (data x spatial: 1x2, 2x1, 2x2, 1x4) is one group of gloo
processes started by ``parallel/launch.py`` (a FileStore rendezvous, one
torch thread each, a time limit on the whole run). The processes import this
module, which imports no JAX: they rebuild the world from a torch seed (the
32 px tiny-channel G and D, the full ResNet-50 and VGG19 at the JAX
package's init scales, non-zero noise weights), run every check of their
shape and return rank 0's numbers. The parent computes the single-process
port's numbers with the same code and the JAX package's from the same
towers through its own converters.

Tolerances (tests/test_spatial.py's, which holds the JAX package's meshes
to its single device): forward atol = rtol = 2e-5; one step's loss rtol
2e-4; the walk after Adam rtol 1e-4, atol 1e-6. The walk gradient before
Adam (Adam's first step is about lr * sign(g), so it says little about g):
within 1e-5 relative L2 of the single-process port, and within
tests/helpers.py:assert_close's CPU f32 gate of JAX's (the same z, alphas
and stored noise; 2.9e-6 relative L2 apart in one process). The halo
exchange's gradient is held in f64 to a
full-image conv; D's minibatch stddev at local batch 2, global 4 to JAX's
global-batch layer.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import pytest
import torch

from latent2im_tpu_torch.engine import train as T
from latent2im_tpu_torch.engine.editor import Editor, EditorConfig
from latent2im_tpu_torch.models import hooks
from latent2im_tpu_torch.models import resnet as rn
from latent2im_tpu_torch.models import stylegan2 as sg2
from latent2im_tpu_torch.models import vgg as vggm
from latent2im_tpu_torch.parallel import launch as L
from latent2im_tpu_torch.parallel import mesh as M
from latent2im_tpu_torch.parallel import spatial as S
from latent2im_tpu_torch.tasks.transforms import get_task
from latent2im_tpu_torch.walks import init_walk

SIZE, STYLE_DIM, LR = 32, 32, 1e-3
CHANNELS = {4: 16, 8: 16, 16: 8, 32: 8}
ATTR_LIST, ATTR_IDX, N_OUT = ("Smiling", "Young"), (31, 39), 40
TERMS = ("loss", "reg_loss", "content_loss", "gan_loss")
BATCH, RAGGED = 4, 3  # the step's global batch; the inference batch (pads under dp)
MIN_ROWS = 2
MESHES = ((1, 2), (2, 1), (2, 2), (1, 4))
PANELS = (-0.5, 0.5, 1.5)
GEO_TASKS = ("color", "zoom")
FWD = dict(rtol=2e-5, atol=2e-5)
SPAWN_TIMEOUT = 120.0


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def world(seed=0):
    """The port's towers, seeded (tests/test_torch_remat.py's world), and
    the inputs: (g, d, reg, vgg), walk0, z, sampled."""
    gen = torch.Generator().manual_seed(seed)
    g = sg2.Generator(SIZE, STYLE_DIM, 2, channels=CHANNELS, generator=gen)
    with torch.no_grad():
        for name, p in g.named_parameters():
            if name.endswith("noise.weight"):
                p.fill_(0.5)
    d = sg2.Discriminator(SIZE, channels=CHANNELS, generator=gen)
    reg = rn.ResNet50(num_outputs=N_OUT, generator=gen)
    vgg = vggm.VGG19Features(generator=gen)
    rng = np.random.RandomState(seed)
    walk0 = (0.05 * rng.randn(len(ATTR_LIST), sg2.n_latent(SIZE), STYLE_DIM)
             ).astype(np.float32)
    z = rng.randn(BATCH, STYLE_DIM).astype(np.float32)
    sampled = rng.uniform(0, 1, (BATCH, len(ATTR_LIST))).astype(np.float32)
    return (g, d, reg, vgg), walk0, z, sampled


def editor(towers, fixed_noise=True):
    g, d, reg, vgg = towers
    cfg = EditorConfig(attr_list=ATTR_LIST, attr_idx=ATTR_IDX, size=SIZE,
                       dim_z=STYLE_DIM, fixed_noise=fixed_noise)
    return Editor(cfg, g, reg, "cpu", vgg=vgg, d=d)


def _np(t):
    return t.detach().float().numpy().copy()


def _halo_f64(mesh, plan):
    """A 3x3 conv on this rank's rows with one halo row, in f64: its
    gathered output and the image gradient summed over 'spatial'."""
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(2, 16, 8, 3, dtype=torch.float64, generator=gen).requires_grad_()
    w = torch.randn(4, 3, 3, 3, dtype=torch.float64, generator=gen)
    c = torch.randn(2, 16, 8, 4, dtype=torch.float64, generator=gen)
    xe = plan.halo(plan.constrain(x))
    y = torch.nn.functional.conv2d(xe.permute(0, 3, 1, 2), w, padding=1)
    y = y.permute(0, 2, 3, 1)[:, 1:-1]
    (y * plan.constrain(c)).sum().backward()
    return plan.boundary(y.detach()).numpy(), M.all_reduce(mesh, x.grad, "spatial").numpy()


def _mbstd(mesh):
    """D's minibatch stddev over the global batch from this rank's rows:
    its gathered output and the feature gradient of a global loss."""
    gen = torch.Generator().manual_seed(11)
    feats = torch.randn(BATCH, 4, 4, 8, generator=gen)
    c = torch.randn(BATCH, 4, 4, 9, generator=gen)
    lo, hi = mesh.data_slice(BATCH)
    x = feats[lo:hi].clone().requires_grad_()
    prev = hooks.install_batch(M.BatchGather(mesh))
    try:
        out = sg2.minibatch_stddev(x)
    finally:
        hooks.restore_batch(prev)
    (out * c[lo:hi]).sum().backward()
    return (_np(M.all_gather(mesh, "data", out.detach(), 0)),
            _np(M.all_gather(mesh, "data", x.grad, 0)))


def run_all(n_data=None, n_sp=1, built=None):
    """Every check's numbers, on a (n_data x n_sp) mesh or (n_data None) in
    one process without one. built: world() made already."""
    torch.set_num_threads(1)
    towers, walk0, z, sampled = built or world()
    mesh, ctx, out = None, contextlib.nullcontext(), {}
    if n_data is not None:
        mesh = S.make_mesh_spatial(n_sp, n_data) if n_sp > 1 else M.make_mesh(n_data)
        if n_sp > 1:
            ctx = S.spatial_partitioning(mesh, min_rows_per_device=MIN_ROWS)
    ed = editor(towers)
    walk = {"w": torch.from_numpy(walk0.copy())}
    med = M.replicate_editor(ed, walk, mesh)[0]
    panels = np.stack([np.full((RAGGED, len(ATTR_LIST)), a, np.float32) for a in PANELS])
    with ctx:
        latent = ed.get_w(z[:RAGGED])
        out["synth"] = _np(med.synthesize(latent))
        out["synth_fresh"] = _np(med.synthesize(latent, torch.Generator().manual_seed(5)))
        edited, alpha_org, orig = med.apply_alpha(walk, z[:RAGGED], sampled[:RAGGED])
        out["apply_alpha"], out["alpha_org"], out["orig"] = map(_np, (edited, alpha_org, orig))
        out["sweep"] = _np(med.sweep(walk, z[:RAGGED], panels)[0])
        for name, fixed in (("step", True), ("step_fresh", False)):
            w = {"w": torch.from_numpy(walk0.copy()).requires_grad_()}
            step = T.make_train_step(editor(towers, fixed), get_task("face"),
                                     T.make_optimizer(w, LR), host_alpha=True, mesh=mesh)
            m = step(w, z, generator=torch.Generator().manual_seed(3), sampled=sampled)
            out[name] = ({k: float(m[k]) for k in TERMS}, _np(w["w"].grad), _np(w["w"]))
        for name in GEO_TASKS:  # per-sample colour sliders; a warp's mask
            ged = Editor(EditorConfig(attr_list=(name,), attr_idx=(0,), size=SIZE,
                                      dim_z=STYLE_DIM), towers[0], None, "cpu")
            w = init_walk("linear_w", STYLE_DIM, sg2.n_latent(SIZE), [name],
                          generator=torch.Generator().manual_seed(3))
            w, hist = T.geometric_train_loop(ged, get_task(name), w, num_samples=4,
                                             batch_size=4, n_epochs=2, lr=LR, log_every=1,
                                             mesh=mesh)
            out[name] = (hist, _np(w["w"]))
        if mesh is not None and n_sp > 1:
            out["halo"] = _halo_f64(mesh, ctx.plan)
            out["bytes"] = (ctx.plan.halo_bytes, ctx.plan.gather_bytes)
    if mesh is not None and n_data > 1:
        out["mbstd"] = _mbstd(mesh)
    return out


def run_meshes(shapes):
    """run_all on each (data x spatial) shape in turn, in one world."""
    built = world()
    return {shape: run_all(*shape, built=built) for shape in shapes}


@pytest.fixture(scope="module")
def single():
    with _one_thread():
        return run_all()


@contextlib.contextmanager
def _one_thread():
    n = torch.get_num_threads()
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's synthesis (stored noise), one step's loss terms and
    walk gradient (SGD at rate 1 leaves walk0 - grad) and the walk after
    one optax Adam step on that gradient, from the same towers."""
    import jax
    import jax.numpy as jnp
    import optax

    from latent2im_tpu.engine import train as jtrain
    from latent2im_tpu.engine.editor import Editor as JEditor
    from latent2im_tpu.engine.editor import EditorConfig as JEditorConfig
    from latent2im_tpu.io import torch_convert as tc
    from latent2im_tpu.models import stylegan2 as jsg2

    (g, d, reg, vgg), walk0, z, sampled = world()
    gt = tc.convert_stylegan2_generator(g.state_dict(), SIZE, n_mlp=2)
    cfg = JEditorConfig(latent="w", walk_kind="linear_w", attr_list=ATTR_LIST,
                        attr_idx=ATTR_IDX, size=SIZE, dim_z=STYLE_DIM,
                        alpha_mode="target", fixed_noise=True)
    ed = JEditor(cfg, gt, tc.convert_resnet50(reg.state_dict()),
                 vgg_params=tc.convert_vgg_features(vgg.state_dict(), "vgg19"),
                 d_params=tc.convert_stylegan2_discriminator(d.state_dict(), SIZE))
    latent = ed.get_w(jnp.asarray(z[:RAGGED]))
    synth = np.asarray(jax.jit(jsg2.synthesize)(gt, latent))
    walk = {"w": jnp.asarray(walk0)}
    sgd = optax.sgd(1.0)
    step = jtrain.make_train_step(ed, None, sgd, host_alpha=True)
    moved, _, m = step(walk, sgd.init(walk), jnp.asarray(z), jax.random.PRNGKey(0),
                       sampled=jnp.asarray(sampled))
    grad = walk0 - np.asarray(moved["w"])
    adam, walk = jtrain.make_optimizer(LR), {"w": jnp.asarray(walk0)}  # the step donated it
    upd, _ = adam.update({"w": jnp.asarray(grad)}, adam.init(walk), walk)
    after = np.asarray(optax.apply_updates(walk, upd)["w"])
    return {"synth": synth, "terms": {k: float(m[k]) for k in TERMS}, "grad": grad,
            "after": after}


def _mbstd_jax():
    import jax.numpy as jnp

    from latent2im_tpu.models import stylegan2 as jsg2

    gen = torch.Generator().manual_seed(11)
    feats = torch.randn(BATCH, 4, 4, 8, generator=gen)
    return np.asarray(jsg2.minibatch_stddev(jnp.asarray(feats.numpy())))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_synthesize_on_a_mesh_equals_one_process_and_jax(shape, ranks, single, jax_ref):
    got = ranks(shape[0] * shape[1])["engine"][shape]
    np.testing.assert_allclose(got["synth"], single["synth"], **FWD)
    np.testing.assert_allclose(got["synth"], jax_ref["synth"], **FWD)
    np.testing.assert_allclose(single["synth"], jax_ref["synth"], **FWD)
    # fresh noise is drawn at the global shape and sliced: the same images
    np.testing.assert_allclose(got["synth_fresh"], single["synth_fresh"], **FWD)
    assert np.abs(got["synth_fresh"] - got["synth"]).max() > 1e-2


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_apply_alpha_and_sweep_on_a_mesh_equal_one_process(shape, ranks, single):
    """At a batch of 3, which a data axis of 2 pads to 4 and slices back."""
    got = ranks(shape[0] * shape[1])["engine"][shape]
    for k in ("apply_alpha", "orig", "sweep"):
        assert got[k].shape == single[k].shape, k
        np.testing.assert_allclose(got[k], single[k], err_msg=k, **FWD)
    np.testing.assert_allclose(got["alpha_org"], single["alpha_org"], rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_train_step_on_a_mesh_equals_one_process_and_jax(shape, ranks, single, jax_ref):
    """Loss, walk gradient before Adam and walk after it; the gradient is
    averaged over 'data' and summed over 'spatial', counted once."""
    got = ranks(shape[0] * shape[1])["engine"][shape]
    for name in ("step", "step_fresh"):
        terms, grad, after = got[name]
        want_terms, want_grad, want_after = single[name]
        for k in TERMS:
            np.testing.assert_allclose(terms[k], want_terms[k], rtol=2e-4, err_msg=(name, k))
        assert rel_l2(grad, want_grad) < 1e-5, (name, rel_l2(grad, want_grad))
        np.testing.assert_allclose(after, want_after, rtol=1e-4, atol=1e-6)
    from helpers import assert_close

    terms, grad, after = got["step"]
    for k in TERMS:
        np.testing.assert_allclose(terms[k], jax_ref["terms"][k], rtol=2e-4, err_msg=k)
    assert_close(grad, jax_ref["grad"])  # the CPU f32 gate
    np.testing.assert_allclose(after, jax_ref["after"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_geometric_loop_on_a_mesh_equals_one_process(shape, ranks, single):
    """Two steps of the device-target loop (global batch 4): the colour
    task's per-sample sliders shard with the batch, and the masked L2 is
    the global batch's (its mask sum reduced over 'data')."""
    got = ranks(shape[0] * shape[1])["engine"][shape]
    for name in GEO_TASKS:
        np.testing.assert_allclose(got[name][0], single[name][0], rtol=2e-4, err_msg=name)
        np.testing.assert_allclose(got[name][1], single[name][1], rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_one_process_step_matches_the_jax_step(single, jax_ref):
    """The reference the meshes are held to, itself held to JAX."""
    from helpers import assert_close

    terms, grad, after = single["step"]
    for k in TERMS:
        np.testing.assert_allclose(terms[k], jax_ref["terms"][k], rtol=2e-4, err_msg=k)
    assert_close(grad, jax_ref["grad"])
    np.testing.assert_allclose(after, jax_ref["after"], rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_halo_exchange_gradient_in_f64(shape, ranks):
    """A 3x3 conv on row shards with halo rows: the gathered output and the
    gradient summed over 'spatial' equal the whole image's, in f64."""
    got = ranks(shape[0] * shape[1])["engine"][shape]["halo"]
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(2, 16, 8, 3, dtype=torch.float64, generator=gen).requires_grad_()
    w = torch.randn(4, 3, 3, 3, dtype=torch.float64, generator=gen)
    c = torch.randn(2, 16, 8, 4, dtype=torch.float64, generator=gen)
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)
    (y * c).sum().backward()
    np.testing.assert_allclose(got[0], y.detach().numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got[1], x.grad.numpy(), rtol=1e-12, atol=1e-12)
    halo, gather = ranks(shape[0] * shape[1])["engine"][shape]["bytes"]
    assert halo > 0 and gather > 0


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_minibatch_stddev_spans_the_data_ranks_as_jax(shape, ranks):
    """Local batch 2, global 4: the groups (i, i + 2) span the two data
    ranks, as the JAX step's global batch; the gradient reaches each rank's
    rows from every rank's loss."""
    out, grad = ranks(shape[0] * shape[1])["engine"][shape]["mbstd"]
    np.testing.assert_allclose(out, _mbstd_jax(), rtol=1e-6, atol=1e-6)
    gen = torch.Generator().manual_seed(11)
    feats = torch.randn(BATCH, 4, 4, 8, generator=gen).requires_grad_()
    c = torch.randn(BATCH, 4, 4, 9, generator=gen)
    (sg2.minibatch_stddev(feats) * c).sum().backward()
    np.testing.assert_allclose(grad, feats.grad.numpy(), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the CLIs over a mesh
# ---------------------------------------------------------------------------


def _train_argv(models_dir, batch, *extra):
    return ["--transform", "face", "--attrList", "Smiling", "--models_dir", models_dir,
            "--overwrite_config", "--num_samples", "4", "--batch_size", str(batch),
            "--n_epochs", "1", "--dev_tiny", "--resolution", str(SIZE),
            "--model_save_freq", "0", *extra]


def _no_tensorboard():
    """As on the card, which has none (importing it here pulls in TensorFlow)."""
    import sys

    sys.modules["torch.utils.tensorboard"] = None


def train_as_rank(argv):
    """cli.train.run on a launched rank -> rank 0's (walk, losses, run dir)."""
    import warnings

    import torch.distributed as dist

    from latent2im_tpu_torch.cli import train as tcli
    from latent2im_tpu_torch.config import options

    torch.set_num_threads(1)
    _no_tensorboard()
    warnings.simplefilter("ignore")
    opt = options.TrainOptions().parse(argv, print_opt=dist.get_rank() == 0)
    walk, hist = tcli.run(opt, device="cpu")
    return walk["w"].numpy(), hist, opt.output_dir


@contextlib.contextmanager
def _cli_process():
    """One torch thread, no TensorBoard, warnings quiet, and the root
    logger (which cli.train points at its log.txt) restored after."""
    import logging
    import sys
    import warnings

    root = logging.getLogger()
    saved = (list(root.handlers), root.level, sys.excepthook)
    with _one_thread(), pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        torch.set_num_threads(1)
        warnings.simplefilter("ignore")
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        try:
            yield
        finally:
            for h in list(root.handlers):
                root.removeHandler(h)
                h.close()
            for h in saved[0]:
                root.addHandler(h)
            root.setLevel(saved[1])
            sys.excepthook = saved[2]


@pytest.fixture(scope="module")
def single_runs(tmp_path_factory):
    """The single-process CLI runs the meshes are held to: a global batch of
    4 (one step) and of 2 (two steps; its run dir serves vis_w, eval and
    serve below)."""
    from latent2im_tpu_torch.cli import train as tcli
    from latent2im_tpu_torch.config import options

    tmp = tmp_path_factory.mktemp("single")
    out = {}
    with _cli_process():
        for batch in (4, 2):
            opt = options.TrainOptions().parse(
                _train_argv(str(tmp / f"b{batch}"), batch), print_opt=True)
            walk, hist = tcli.run(opt, device="cpu")
            out[batch] = (walk["w"].detach().numpy(), hist, opt.output_dir)
    return out


CLI_MESHES = {"2x1": (["--n_devices", "2"], 2, 4), "1x2": (["--sp_devices", "2"], 2, 2),
              "2x2": (["--n_devices", "2", "--sp_devices", "2"], 4, 4)}


@pytest.mark.parametrize("name", sorted(CLI_MESHES))
def test_train_cli_on_a_mesh_matches_one_process(name, single_runs, ranks):
    """--n_devices 2 (global batch 2 x 2), --sp_devices 2 and both, on
    launched ranks: the losses and the final walk are the single-process
    run's at the same global batch, and only rank 0 wrote the run's files."""
    flags, n, global_batch = CLI_MESHES[name]
    walk, hist, run_dir = ranks(n)["train"][name]
    want_walk, want_hist, want_dir = single_runs[global_batch]
    np.testing.assert_allclose(hist, want_hist, rtol=2e-4)
    np.testing.assert_allclose(walk, want_walk, rtol=1e-4, atol=1e-6)
    assert sorted(os.listdir(run_dir)) == sorted(os.listdir(want_dir))
    with open(os.path.join(run_dir, "log.txt")) as f:
        assert f.read().count("T, epc, bst, lss, alpha") == len(want_hist)


def _vis_opts(run_dir, out_dir, *extra):
    from latent2im_tpu_torch.config import options

    return options.VisOptions().parse(
        [os.path.join(run_dir, "opt.yml"), "--save_path_w",
         os.path.join(run_dir, "model_w_1_final_walk_module.ckpt"), "--output_dir",
         out_dir, "--num_samples", "3", "--num_panels", "3", *extra])


def _pngs(d):
    from PIL import Image

    return {f: np.asarray(Image.open(os.path.join(d, f)), np.int16)
            for f in sorted(os.listdir(d)) if f.endswith(".png")}


def test_vis_w_cli_launches_its_ranks_and_writes_what_one_process_writes(
        single_runs, tmp_path):
    """--sp_devices 2 launched by vis_w itself. The float images agree to
    2e-5; a uint8 value may move by one where that crosses a step."""
    from latent2im_tpu_torch.cli.vis_w import run as vis_run

    run_dir = single_runs[2][2]
    with _cli_process():
        one = vis_run(*_vis_opts(run_dir, str(tmp_path / "one")), device="cpu")
        two = vis_run(*_vis_opts(run_dir, str(tmp_path / "sp"), "--sp_devices", "2"),
                      device="cpu")
    got, want = _pngs(two), _pngs(one)
    assert sorted(got) == sorted(want) and len(want) == 3
    for f in want:
        assert np.abs(got[f] - want[f]).max() <= 1, f
    with open(os.path.join(one, "index.html")) as a, open(os.path.join(two, "index.html")) as b:
        assert a.read() == b.read()


def _eval(run_dir, out_dir, *extra):
    import json

    from latent2im_tpu_torch.cli import eval as ecli

    opt, conf = _vis_opts(run_dir, out_dir, "--num_samples", "1", *extra)
    ecli.run(opt, conf, device="cpu")
    if not os.path.isfile(os.path.join(out_dir, "eval_report.json")):
        return None  # a rank other than 0 writes nothing
    with open(os.path.join(out_dir, "eval_report.json")) as f:
        return json.load(f)


def test_eval_cli_on_ranks_reports_what_one_process_reports(single_runs, ranks, tmp_path):
    """--n_devices 2 over one sample (padded to 2, sliced back)."""
    run_dir = single_runs[2][2]
    with _cli_process():
        want = _eval(run_dir, str(tmp_path / "one"))
    got = ranks(2)["eval"]
    assert got.keys() == want.keys() and got["results"].keys() == want["results"].keys()
    for attr, r in want["results"].items():
        assert got["results"][attr]["bucket_counts"] == r["bucket_counts"]
        for k in ("identity_preservation", "attribute_preservation"):
            np.testing.assert_allclose(got["results"][attr][k], r[k], rtol=1e-4, atol=1e-6)


def _serve_opts(run_dir, *extra):
    from latent2im_tpu_torch.config import options

    vo = options.VisOptions()
    vo.parser.add_argument("--serve_batch", type=int, default=4)
    return vo.parse([os.path.join(run_dir, "opt.yml"), "--save_path_w",
                     os.path.join(run_dir, "model_w_1_final_walk_module.ckpt"),
                     "--num_panels", "3", *extra])


def _serve_requests(service):
    """/edit of 4 (through HTTP on localhost) and /sweep of 3 samples."""
    import json
    import threading
    import urllib.request

    from latent2im_tpu_torch.cli.serve import make_server

    z = np.random.RandomState(5).randn(4, service.dim_z).astype(np.float32)
    srv = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/edit",
            data=json.dumps({"z": z.tolist(), "alpha": 0.7}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            edit = json.loads(r.read())
    finally:
        srv.shutdown()
        thread.join(10)
    sweep = service.sweep({"z": z[:3].tolist()})
    return edit, sweep


def serve_as_rank(run_dir, extra):
    """One rank of cli.serve: rank 0 answers the requests, its heartbeats
    (every 20 ms here) interleaved with them, then closes -> (edit, sweep,
    heartbeats sent)."""
    from latent2im_tpu_torch.cli import serve as serve_mod

    torch.set_num_threads(1)
    serve_mod.HEARTBEAT_S = 0.02
    beats = [0]
    send = serve_mod._Broadcasting.heartbeat

    def counted(self):
        send(self)
        beats[0] += 1

    serve_mod._Broadcasting.heartbeat = counted
    service = serve_mod.build_service(*_serve_opts(run_dir, *extra), device="cpu")
    if not service.is_main:
        service.follow()
        return None
    try:
        edit, sweep = _serve_requests(service)
        end = time.monotonic() + 10.0
        while beats[0] < 2 and time.monotonic() < end:
            time.sleep(0.02)
        return edit, sweep, beats[0]
    finally:
        service.close()


def test_serve_over_a_mesh_answers_as_one_process(single_runs, ranks):
    """Rank 0 serves HTTP; each request's call and padded batch go to the
    other ranks, which follow until the service closes and skip the
    heartbeats that keep their wait inside the collective timeout."""
    from latent2im_tpu_torch.cli.serve import build_service
    from latent2im_tpu_torch.utils.image import png_decode_rgb as png_decode

    run_dir = single_runs[2][2]
    with _cli_process():
        want = _serve_requests(build_service(*_serve_opts(run_dir), device="cpu"))
    got = ranks(2)["serve"]
    import base64

    def imgs(out, key):
        flat = out[key] if key == "images" else [p for row in out[key] for p in row]
        return [png_decode(base64.b64decode(b)).astype(np.int16) for b in flat]

    for key, i in (("images", 0), ("panels", 1)):
        a, b = imgs(got[i], key), imgs(want[i], key)
        assert len(a) == len(b) > 0
        assert max(np.abs(x - y).max() for x, y in zip(a, b)) <= 1, key
    np.testing.assert_allclose(got[0]["alpha_org"], want[0]["alpha_org"], rtol=1e-4, atol=1e-5)
    assert got[2] >= 2  # heartbeats the followers skipped


# ---------------------------------------------------------------------------
# the launched worlds
# ---------------------------------------------------------------------------


def run_world(n, run_dir, root):
    """Everything that runs on n ranks, in one launched world: the engine
    checks of each mesh shape of n ranks, the training CLI on each of its
    meshes of n ranks, and on 2 ranks cli.eval at --n_devices 2 and
    cli.serve at --sp_devices 2 (each CLI builds its own mesh in turn)."""
    import warnings

    torch.set_num_threads(1)
    warnings.simplefilter("ignore")
    out = {"engine": run_meshes(tuple(s for s in MESHES if s[0] * s[1] == n))}
    out["train"] = {name: train_as_rank(_train_argv(os.path.join(root, name), 2, *flags))
                    for name, (flags, ranks, _) in CLI_MESHES.items() if ranks == n}
    if n == 2:
        out["eval"] = _eval(run_dir, os.path.join(root, "eval"), "--n_devices", "2")
        out["serve"] = serve_as_rank(run_dir, ("--sp_devices", "2"))
    return out


@pytest.fixture(scope="module")
def ranks(single_runs, tmp_path_factory):
    """n -> run_world's results on n launched gloo ranks (once per n)."""
    root, cache = tmp_path_factory.mktemp("ranks"), {}

    def get(n):
        if n not in cache:
            cache[n] = L.launch(run_world, (n, single_runs[2][2], str(root)), world_size=n,
                                device="cpu", timeout=SPAWN_TIMEOUT)
        return cache[n]

    return get
