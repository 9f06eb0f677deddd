"""The port's CLIs (latent2im_tpu_torch/cli/{train,train_multi_attr,vis_w,
serve}.py) and its opt.yml reader and writer, on the CPU at --dev_tiny
--resolution 32:

- opt.yml crosses both ways: a JAX-written one reads as PyYAML reads it and
  parses to the JAX package's namespaces; a port-written one reads in
  yaml.safe_load to the same dict; what the subset lacks raises with the line;
- train -> SIGTERM after the second step -> preemption checkpoint, no final
  -> --resume -> final; the reloaded walk and Adam state equal the run's bit
  for bit;
- train_multi_attr -> loss artifacts; vis_w sweep panels and the
  --combine_indices grid with index.html; serve with --save_path_w answers
  /edit with the uint8 images of apply_alpha on the loaded walk.

TensorBoard is made unimportable for the flow, as on the GPU machine, which
has none: the CLI warns and logs to log.txt.
"""

import base64
import contextlib
import copy
import io
import logging
import os
import signal
import sys
import warnings

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from latent2im_tpu.config import options as joptions
from latent2im_tpu_torch.config import options
from latent2im_tpu_torch.io import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32


# ---------------------------------------------------------------------------
# opt.yml
# ---------------------------------------------------------------------------

FLAGS = ["--transform", "face", "--attrList", "Smiling,Young", "--layers", "0,1",
         "--kernel_impl", "pallas", "--truncation_psi", "0.7", "--learning_rate",
         "1e-05", "--remat_g", "block", "--prefix", "yes_", "--overwrite_config",
         "--resolution", "64"]


def _strip(ns):
    return {k: (vars(v) if hasattr(v, "__dict__") else v) for k, v in vars(ns).items()
            if k != "config_file"}


def test_jax_written_opt_yml_reads_as_pyyaml_and_parses_as_the_jax_package(tmp_path):
    jopt = joptions.TrainOptions().parse(FLAGS + ["--models_dir", str(tmp_path)],
                                         print_opt=True)
    yml = os.path.join(jopt.output_dir, "opt.yml")
    with open(yml) as f:
        text = f.read()
    assert options.yaml_load(text) == yaml.safe_load(text)
    args = ["--config_file", yml, "--num_samples", "4"]
    assert _strip(options.TrainOptions().parse(args, print_opt=False)) == \
        _strip(joptions.TrainOptions().parse(args, print_opt=False))


def test_port_written_opt_yml_reads_in_pyyaml_and_the_jax_package(tmp_path):
    topt = options.TrainOptions().parse(FLAGS + ["--models_dir", str(tmp_path)],
                                        print_opt=True)
    yml = os.path.join(topt.output_dir, "opt.yml")
    with open(yml) as f:
        text = f.read()
    data = yaml.safe_load(text)
    assert options.yaml_load(text) == data
    assert data["stylegan"]["truncation_psi"] == "0.7" and data["layers"] == "0,1"
    assert data["prefix"] == "yes_" and data["learning_rate"] == 1e-05
    vis = ["--num_panels", "3"]
    to, tc = options.VisOptions().parse([yml] + vis)
    jo, jc = joptions.VisOptions().parse([yml] + vis)
    assert _strip(to) == _strip(jo) and _strip(tc) == _strip(jc)
    odd = {"a": "yes", "b": "1.5", "c": "", "d": None, "e": "it's: #x", "f": 1e20,
           "g": {"h": "0,1", "i": True, "j": -3}, "k": "~", "l": ".inf"}
    assert yaml.safe_load(options.yaml_dump(odd)) == odd
    assert options.yaml_load(options.yaml_dump(odd)) == odd


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: [1, 2]\n", 2), ("a: &x 1\n", 1), ("g:\n  b:\n    c: 1\n", 3),
    ("a: 'x\n  y'\n", 1), ("a: 1\n- 2\n", 2), ("# c\na: |\n  x\n", 2),
    ("a: 0x10\n", 1), ("a: b: c\n", 1),
])
def test_opt_yml_reader_refuses_what_it_lacks_naming_the_line(text, line):
    with pytest.raises(ValueError, match=f"opt.yml:{line}:"):
        options.yaml_load(text)


# ---------------------------------------------------------------------------
# the CLI flow
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _restoring_logging():
    """cli.train.run points the root logger and sys.excepthook at its run's
    log.txt; put the test process's back afterwards."""
    root = logging.getLogger()
    saved = (list(root.handlers), root.level, sys.excepthook)
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


@contextlib.contextmanager
def _one_thread():
    """One torch thread: as fast at these shapes, and the flow does not
    crawl when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _train_args(models_dir, *extra):
    return ["--transform", "face", "--attrList", "Smiling", "--models_dir", models_dir,
            "--overwrite_config", "--num_samples", "8", "--batch_size", "2",
            "--n_epochs", "2", "--dev_tiny", "--resolution", str(SIZE),
            "--model_save_freq", "1", "--export_ref_walk", *extra]


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    """Run the training CLIs once: train with a SIGTERM after the second
    step of epoch 0, --resume to the end, and train_multi_attr."""
    import latent2im_tpu_torch.cli.train as tcli
    from latent2im_tpu_torch.cli.train_multi_attr import N_EPOCH_MULTI

    tmp = tmp_path_factory.mktemp("cli")
    out = {"tmp": tmp, "epoch_end": {}}
    real_loop = tcli.train_loop

    def loop(*a, **kw):
        on_step, on_epoch_end = kw["on_step"], kw["on_epoch_end"]
        fired = {"n": 0}

        def killing_on_step(epoch, i, metrics, dt, wp):
            on_step(epoch, i, metrics, dt, wp)
            if out.get("kill") and fired["n"] == 1:  # after the 2nd step of epoch 0
                os.kill(os.getpid(), signal.SIGTERM)
            fired["n"] += 1

        def recording_on_epoch_end(epoch, wp, st):
            on_epoch_end(epoch, wp, st)
            out["epoch_end"][epoch] = ({k: v.detach().clone() for k, v in wp.items()},
                                       copy.deepcopy(st))

        kw.update(on_step=killing_on_step, on_epoch_end=recording_on_epoch_end)
        return real_loop(*a, **kw)

    with _restoring_logging(), _one_thread(), pytest.MonkeyPatch.context() as mp, \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mp.setattr(tcli, "train_loop", loop)
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)  # unimportable
        models = str(tmp / "models")
        opt = options.TrainOptions().parse(_train_args(models), print_opt=True)
        out["kill"] = True
        out["preempted"] = tcli.run(opt, device="cpu")
        out["run_dir"] = opt.output_dir
        out["after_sigterm"] = sorted(os.listdir(opt.output_dir))
        out["resume_from"] = ckpt.find_resume(opt.output_dir)
        out["preempt_meta"] = ckpt.load_meta(out["resume_from"])
        out["kill"] = False
        opt2 = options.TrainOptions().parse(_train_args(models, "--resume"),
                                            print_opt=False)
        out["resumed"] = tcli.run(opt2, device="cpu")
        with open(os.path.join(opt.output_dir, "log.txt")) as f:
            out["log"] = f.read()
        mopt = options.TrainOptions().parse(
            ["--transform", "face", "--attrList", "Smiling,Young", "--models_dir",
             str(tmp / "multi"), "--overwrite_config", "--num_samples", "4",
             "--batch_size", "2", "--n_epochs", "1", "--dev_tiny", "--resolution",
             str(SIZE), "--model_save_freq", "0"], print_opt=True)
        out["multi"] = tcli.run(mopt, n_epoch_default=N_EPOCH_MULTI,
                                save_loss_artifacts=True, device="cpu")
        out["multi_dir"] = mopt.output_dir
    return out


def test_sigterm_writes_a_preemption_checkpoint_and_resume_finishes(flow):
    run_dir = flow["run_dir"]
    assert "model_w_2_final_walk_module.ckpt" not in flow["after_sigterm"]
    assert flow["after_sigterm"].count("model_w_0_walk_module.ckpt") == 1
    _, hist = flow["preempted"]
    assert len(hist) == 2  # stopped after the second step
    assert flow["resume_from"] == os.path.join(run_dir, "model_w_0_walk_module.ckpt")
    assert flow["preempt_meta"] == {"epoch": -1, "final": False, "preempted": True}
    assert "resuming from" in flow["log"] and "at epoch 0" in flow["log"]
    assert "tensorboard unavailable" in flow["log"]

    walk, hist = flow["resumed"]
    assert len(hist) == 8 and all(np.isfinite(hist))
    like = {"w": torch.zeros_like(walk["w"])}
    final, state, fmeta = ckpt.load_walk(
        os.path.join(run_dir, "model_w_2_final_walk_module.ckpt"), like)
    assert fmeta == {"epoch": 2, "final": True} and state is None
    assert torch.equal(final["w"], walk["w"].detach())
    # the last epoch's checkpoint: walk and Adam state as the run held them
    from latent2im_tpu_torch.engine.train import make_optimizer

    run_walk, run_state = flow["epoch_end"][1]
    w1, st1, meta1 = ckpt.load_walk(
        os.path.join(run_dir, "model_w_1_walk_module.ckpt"), like,
        opt_state_like=make_optimizer(like, 1e-4).state_dict())
    assert meta1 == {"epoch": 1, "final": False}
    assert torch.equal(w1["w"], run_walk["w"]) and torch.equal(w1["w"], walk["w"].detach())
    for key in ("step", "exp_avg", "exp_avg_sq"):
        assert torch.equal(st1["state"][0][key], run_state["state"][0][key]), key
    # 2 steps before SIGTERM, then epoch 0 again and epoch 1, 4 steps each
    assert float(st1["state"][0]["step"]) == 10
    # --export_ref_walk and the periodic sample grids (org and edited, per
    # step: 2 epochs x 4 steps, the re-run epoch 0 writing the same names)
    ref, _, rmeta = ckpt.load_walk(
        os.path.join(run_dir, "model_w_2_final_ref_walk_module.ckpt"), like)
    assert rmeta["source"] == "torch" and torch.equal(ref["w"], final["w"])
    results = sorted(os.listdir(os.path.join(run_dir, "results")))
    assert len(results) == 2 * 8 and "1_6_logit.png" in results
    grid = np.asarray(Image.open(os.path.join(run_dir, "results", "1_6_logit.png")))
    assert grid.shape == (2 * SIZE + 1, SIZE, 3)  # 2 samples, one column


def test_train_multi_attr_writes_its_loss_artifacts(flow):
    from latent2im_tpu_torch.cli.train_multi_attr import N_EPOCH_MULTI

    walk, hist = flow["multi"]
    assert N_EPOCH_MULTI == 3 and walk["w"].shape[0] == 2  # one row per attribute
    assert len(hist) == 2 and all(np.isfinite(hist))
    lv = np.load(os.path.join(flow["multi_dir"], "loss_values.npy"))
    np.testing.assert_array_equal(lv, np.asarray(hist))
    assert os.path.isfile(os.path.join(flow["multi_dir"],
                                       "model_w_1_final_walk_module.ckpt"))


@pytest.mark.parametrize("mode", ["sweep", "combine"])
def test_vis_w_writes_panels_and_index_html(flow, mode):
    from latent2im_tpu_torch.cli.vis_w import run as vis_run

    run_dir = flow["run_dir"] if mode == "sweep" else flow["multi_dir"]
    final = os.path.join(run_dir, "model_w_%d_final_walk_module.ckpt"
                         % (2 if mode == "sweep" else 1))
    out_dir = str(flow["tmp"] / f"vis_{mode}")
    args = [os.path.join(run_dir, "opt.yml"), "--save_path_w", final, "--output_dir",
            out_dir, "--num_samples", "2", "--num_panels", "5"]
    if mode == "combine":
        args += ["--combine_indices", "31,39"]  # Smiling, Young
    vopt, conf = options.VisOptions().parse(args)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert vis_run(vopt, conf, device="cpu") == out_dir
    pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    assert len(pngs) == 2 and os.path.isfile(os.path.join(out_dir, "index.html"))
    with open(os.path.join(out_dir, "index.html")) as f:
        html = f.read()
    assert all(f'<img src="{p}"' in html for p in pngs)
    side = 5 * SIZE + 4
    shape = (SIZE, side, 3) if mode == "sweep" else (side, side, 3)
    for p in pngs:
        assert np.asarray(Image.open(os.path.join(out_dir, p))).shape == shape
    if mode == "sweep":
        assert pngs[0].startswith("sample0_") and pngs[1].startswith("sample1_")
    else:
        assert pngs == ["combine_idx31_idx39_sample0.png", "combine_idx31_idx39_sample1.png"]


def test_serve_loads_the_trained_walk_and_edits_as_apply_alpha(flow):
    from latent2im_tpu_torch.cli.serve import build_service

    run_dir = flow["run_dir"]
    vo = options.VisOptions()
    vo.parser.add_argument("--serve_batch", type=int, default=4)
    opt, conf = vo.parse([os.path.join(run_dir, "opt.yml"), "--save_path_w",
                          os.path.join(run_dir, "model_w_2_final_walk_module.ckpt"),
                          "--num_panels", "3"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        service = build_service(opt, conf, device="cpu")
    assert torch.equal(service.walk["w"], flow["resumed"][0]["w"].detach())
    z = np.random.RandomState(5).randn(4, service.dim_z).astype(np.float32)
    out = service.edit({"z": z.tolist(), "alpha": 0.7})
    want, _, _ = service.ed.apply_alpha(service.walk, z, np.full(4, 0.7, np.float32),
                                        u8=True)
    assert len(out["images"]) == 4
    for i, b64 in enumerate(out["images"]):
        got = np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))
        np.testing.assert_array_equal(got, want[i].numpy())


@pytest.mark.parametrize("extra,item", [
    (["--updateGAN"], "item 11"), (["--n_devices", "2"], "item 15"),
    (["--sp_devices", "2"], "item 15"),
])
def test_train_refuses_what_is_not_ported(tmp_path, extra, item):
    from latent2im_tpu_torch.cli.train import run

    opt = options.TrainOptions().parse(_train_args(str(tmp_path), *extra),
                                       print_opt=False)
    with pytest.raises(NotImplementedError, match=item):
        run(opt, device="cpu")


def test_train_refuses_a_geometric_transform(tmp_path):
    from latent2im_tpu_torch.cli.train import run

    opt = options.TrainOptions().parse(
        ["--transform", "zoom", "--models_dir", str(tmp_path), "--dev_tiny"],
        print_opt=False)
    with _restoring_logging(), pytest.raises(NotImplementedError, match="item 12"):
        run(opt, device="cpu")
