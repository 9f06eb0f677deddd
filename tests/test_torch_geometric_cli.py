"""The port's CLIs on a geometric walk against the JAX package's, on the CPU
at 32 px, with the same towers on both sides (a seeded tiny G with its D,
ResNet-50 with the 1-output placeholder head, VGG19, written as torch
checkpoints and read through --g_path / --reg_path / --vgg_path):

- ``cli.train --transform zoom`` (2 epochs of 2 steps, B=2): the loss
  history and the final walk within ``assert_close``'s f32 gates of the
  JAX CLI's run; no sample grids; a SIGTERM after the second step and
  --resume end on the uninterrupted run's walk bit for bit;
- ``vis_w``, ``serve`` (/edit and /sweep) and ``eval`` on the JAX CLI's
  final walk file: the same file names and report keys, images within one
  uint8 level (f32 towers summed in another order, then truncated),
  scores and the eval numbers within 1e-4 relative.

--host_targets (the JAX package's cv2 host path) trains through the CLI in
tests/test_torch_cli.py::test_train_refuses_a_geometric_transform and
tests/test_torch_host_targets.py.
"""

import base64
import io
import os
import signal
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from helpers import assert_close
from test_torch_cli import _one_thread, _restoring_logging

from latent2im_tpu.config import options as joptions
from latent2im_tpu_torch.config import options
from latent2im_tpu_torch.engine.build import TINY_CHANNELS
from latent2im_tpu_torch.io import checkpoint as ckpt
from latent2im_tpu_torch.models import resnet as rn
from latent2im_tpu_torch.models import stylegan2 as sg2
from latent2im_tpu_torch.models import vgg as vggm

SIZE = 32


def _args(models_dir, towers, *extra):
    return ["--transform", "zoom", "--models_dir", models_dir, "--overwrite_config",
            "--num_samples", "4", "--batch_size", "2", "--n_epochs", "2", "--dev_tiny",
            "--resolution", str(SIZE), "--learning_rate", "1e-2", "--model_save_freq", "1",
            "--n_devices", "1", *towers, *extra]  # the JAX CLI: one device of the test mesh


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    import latent2im_tpu.cli.train as jcli
    import latent2im_tpu_torch.cli.train as tcli
    from latent2im_tpu.engine import build as jbuild
    from latent2im_tpu_torch.engine import build as tbuild

    tmp = tmp_path_factory.mktemp("geo_cli")
    gen = torch.Generator().manual_seed(0)
    g = sg2.Generator(SIZE, 32, 2, channels=TINY_CHANNELS, generator=gen)
    with torch.no_grad():
        for k, p in g.named_parameters():
            if k.endswith("noise.weight"):
                p.fill_(0.3)
    d = sg2.Discriminator(SIZE, channels=TINY_CHANNELS, generator=gen)
    torch.save({"g_ema": g.state_dict(), "d": d.state_dict()}, tmp / "g.pt")
    torch.save(rn.ResNet50(num_outputs=1, generator=gen).state_dict(), tmp / "reg.pt")
    torch.save(vggm.VGG19Features(generator=gen).state_dict(), tmp / "vgg.pt")
    towers = ["--g_path", str(tmp / "g.pt"), "--reg_path", str(tmp / "reg.pt"),
              "--vgg_path", str(tmp / "vgg.pt")]
    out = {"tmp": tmp, "towers": towers}
    real_loop = tcli.geometric_train_loop
    fired = {"kill": False}

    def loop(*a, **kw):  # SIGTERM after the second step
        on_step, n = kw["on_step"], {"i": 0}

        def killing_on_step(epoch, i, metrics, dt, wp):
            on_step(epoch, i, metrics, dt, wp)
            n["i"] += 1
            if fired["kill"] and n["i"] == 2:
                os.kill(os.getpid(), signal.SIGTERM)

        kw.update(on_step=killing_on_step)
        return real_loop(*a, **kw)

    # both builds start from the same walk (their random inits differ)
    w0 = (0.02 * np.random.RandomState(3).randn(1, 8, 32)).astype(np.float32)
    with _restoring_logging(), _one_thread(), pytest.MonkeyPatch.context() as mp, \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        mp.setattr(tcli, "geometric_train_loop", loop)
        mp.setattr(jbuild, "init_walk", lambda *a, **k: {"w": jnp.asarray(w0)})
        mp.setattr(tbuild, "init_walk", lambda *a, **k: {"w": torch.from_numpy(w0.copy())})
        jopt = joptions.TrainOptions().parse(_args(str(tmp / "jax"), towers), print_opt=True)
        out["jax"] = jcli.run(jopt)
        out["jax_dir"] = jopt.output_dir
        topt = options.TrainOptions().parse(_args(str(tmp / "port"), towers), print_opt=True)
        out["port"] = tcli.run(topt, device="cpu")
        out["port_dir"] = topt.output_dir
        fired["kill"] = True
        sopt = options.TrainOptions().parse(_args(str(tmp / "split"), towers), print_opt=True)
        out["preempted"] = tcli.run(sopt, device="cpu")
        out["after_sigterm"] = sorted(os.listdir(sopt.output_dir))
        fired["kill"] = False
        out["resumed"] = tcli.run(options.TrainOptions().parse(
            _args(str(tmp / "split"), towers, "--resume"), print_opt=False), device="cpu")
    return out


def test_train_cli_matches_the_jax_cli_and_resumes_exactly(flow):
    (jwalk, jhist), (walk, hist) = flow["jax"], flow["port"]
    assert len(hist) == len(jhist) == 4 and np.all(np.isfinite(hist))
    assert_close(hist, jhist)
    assert_close(walk["w"].detach().numpy(), np.asarray(jwalk["w"]))
    for run_dir in (flow["jax_dir"], flow["port_dir"]):
        assert os.listdir(os.path.join(run_dir, "results")) == []  # no sample grids
        assert os.path.isfile(os.path.join(run_dir, "model_w_2_final_walk_module.ckpt"))
    assert "model_w_2_final_walk_module.ckpt" not in flow["after_sigterm"]
    assert len(flow["preempted"][1]) == 2
    resumed, rhist = flow["resumed"]
    assert rhist == hist[2:]  # SIGTERM at epoch 0's end: --resume runs epoch 1
    assert torch.equal(resumed["w"], walk["w"])
    like = {"w": torch.zeros_like(walk["w"])}
    final, _, _ = ckpt.load_walk(os.path.join(flow["jax_dir"],
                                              "model_w_2_final_walk_module.ckpt"), like)
    np.testing.assert_array_equal(final["w"].numpy(), np.asarray(jwalk["w"]))


def _vis_args(flow, run_key, *extra):
    return [os.path.join(flow[run_key], "opt.yml"), "--save_path_w",
            os.path.join(flow["jax_dir"], "model_w_2_final_walk_module.ckpt"),
            "--num_samples", "2", "--min_alpha", "0.5", "--max_alpha", "2", *extra]


def _png(path_or_b64):
    raw = (open(path_or_b64, "rb").read() if os.path.isfile(str(path_or_b64))
           else base64.b64decode(path_or_b64))
    return np.asarray(Image.open(io.BytesIO(raw))).astype(np.int16)


def _u8_close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1


def test_vis_w_on_a_geometric_walk_matches_the_jax_cli(flow):
    from latent2im_tpu.cli import vis_w as jvis
    from latent2im_tpu_torch.cli import vis_w as tvis

    dirs = {}
    with _one_thread(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, mod, opts, key, kw in (("jax", jvis, joptions, "jax_dir", {}),
                                         ("port", tvis, options, "port_dir", {"device": "cpu"})):
            out_dir = str(flow["tmp"] / f"vis_{name}")
            vopt, conf = opts.VisOptions().parse(
                _vis_args(flow, key, "--output_dir", out_dir, "--num_panels", "5"))
            dirs[name] = mod.run(vopt, conf, **kw)
    names = sorted(os.listdir(dirs["jax"]))
    assert sorted(os.listdir(dirs["port"])) == names and len(names) == 3
    for n in names:
        if n.endswith(".png"):
            _u8_close(_png(os.path.join(dirs["port"], n)), _png(os.path.join(dirs["jax"], n)))


def test_serve_on_a_geometric_walk_matches_the_jax_cli(flow):
    from latent2im_tpu.cli import serve as jserve
    from latent2im_tpu_torch.cli import serve as tserve

    replies = {}
    with _one_thread(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, mod, opts, key, kw in (("jax", jserve, joptions, "jax_dir", {}),
                                         ("port", tserve, options, "port_dir",
                                          {"device": "cpu"})):
            vo = opts.VisOptions()
            vo.parser.add_argument("--serve_batch", type=int, default=2)
            sopt, conf = vo.parse(_vis_args(flow, key, "--num_panels", "3"))
            svc = mod.build_service(sopt, conf, **kw)
            replies[name] = (svc.edit({"seed": 1, "num_samples": 2, "alpha": 0.7}),
                             svc.sweep({"seed": 1, "num_samples": 2}))
    (jedit, jsweep), (edit, sweep) = replies["jax"], replies["port"]
    assert_close(edit["alpha_org"], jedit["alpha_org"], rtol=1e-4)
    for got, want in zip(edit["images"], jedit["images"]):
        _u8_close(_png(got), _png(want))
    assert sweep["alphas"] == jsweep["alphas"] and len(sweep["panels"]) == 3
    for gp, wp in zip(sweep["panels"], jsweep["panels"]):
        for got, want in zip(gp, wp):
            _u8_close(_png(got), _png(want))


def test_eval_on_a_geometric_walk_matches_the_jax_cli(flow):
    from latent2im_tpu.cli import eval as jeval
    from latent2im_tpu_torch.cli import eval as teval

    from latent2im_tpu.engine.editor import Editor as JEditor
    from latent2im_tpu.models import resnet as jrn

    # the JAX CLI's regressor runs eagerly (~12 s here); jitted, it computes
    # the same function
    forward = jax.jit(lambda p, x: jrn.resnet50_forward(p, x)[0])
    reports = {}
    with _one_thread(), warnings.catch_warnings(), pytest.MonkeyPatch.context() as mp:
        warnings.simplefilter("ignore")
        mp.setattr(JEditor, "regress_all",
                   lambda self, img: forward(self.reg_params, self._reg_input(img)))
        for name, mod, opts, key, kw in (("jax", jeval, joptions, "jax_dir", {}),
                                         ("port", teval, options, "port_dir",
                                          {"device": "cpu"})):
            vo = opts.VisOptions()
            vo.parser.add_argument("--facenet_path", default="")
            vo.parser.add_argument("--ref_parity", action="store_true")
            eopt, conf = vo.parse(_vis_args(flow, key, "--output_dir",
                                            str(flow["tmp"] / f"eval_{name}"),
                                            "--num_samples", "1"))
            reports[name] = mod.run(eopt, conf, **kw)
    want, got = reports["jax"], reports["port"]
    assert set(got) == set(want) == {"zoom"}
    for k, v in want["zoom"].items():
        assert np.array_equal(np.isnan(got["zoom"][k]), np.isnan(v)), k
        assert_close(np.nan_to_num(got["zoom"][k]), np.nan_to_num(v), rtol=1e-4)
