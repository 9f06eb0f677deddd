"""The regressor trainer of the port (latent2im_tpu_torch/cli/train_regressor.py,
models/resnet.py in train mode) against the JAX package's
(latent2im_tpu/cli/train_regressor.py, models/resnet.py) on the CPU, from
JAX-initialised parameters (``init_resnet50(PRNGKey(0))``) carried across by
io/convert.py, at 64 px and B=4 (at 32 px layer4's BN would see n = 2):

- nn.BatchNorm2d in train mode is the JAX package's ``batch_norm(train=True)``
  (one layer: rtol 1e-6), and the network's train-mode loss and running
  statistics are ``resnet50_forward(train=True)`` + ``apply_bn_stats``'s in
  the JAX step (the loss at assert_close's gates, the statistics at 1e-4 as
  the eval-mode test: 53 convolutions summed in another order);
- the gradient: in f64 both packages agree at assert_close's CPU f32 gates.
  In f32 they do not, and neither is near f64: a randomly initialised
  ResNet-50 with batch statistics amplifies rounding ~1e5-fold on its way
  back to the stem (JAX's own f32 gradient lies ~2% from f64 there), so the
  port's f32 gradient is held to f64 by 2 x the JAX f32 gradient's
  distance, over the whole gradient (measured: the port 1.3-3.6% with 1-8
  torch threads or a 1-ulp change of one input, JAX 2.1-2.4%);
- one step from each JAX state (restored from the checkpoint the JAX trainer
  writes) against JAX ``make_steps``: the loss at assert_close's gates, the
  parameters within 2 lr per element (Adam's update is sign-like where the
  gradient is near zero and its f32 noise flips the sign; plus the f32
  rounding of the moved parameter), the running
  statistics within 1e-4 relative L2 (one forward from the same state, as
  the forward above);
- the checkpoint the port writes is byte for byte the JAX trainer's
  ``save_pytree`` of the same values, and restores; the --export_torch state
  dict is the JAX package's export's (``num_batches_tracked`` 0);
- ``load_labelfile`` / ``list_split`` as the JAX package's, and the CLI
  flow on tests/fixtures/torch_regressor/ (print lines, files, meta).
"""

import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers import assert_close
from test_torch_cli import one_torch_thread  # noqa: F401

from latent2im_tpu.cli import train_regressor as jtr
from latent2im_tpu.io import checkpoint as jckpt
from latent2im_tpu.io.torch_convert import export_resnet50_torch as jexport
from latent2im_tpu.models import resnet as jrn
from latent2im_tpu_torch.cli import train_regressor as tr
from latent2im_tpu_torch.io import checkpoint as ckpt
from latent2im_tpu_torch.io import convert
from latent2im_tpu_torch.io.torch_convert import export_resnet50_torch
from latent2im_tpu_torch.models import resnet as rn

LR, SIZE, B, STEPS, OUT = 1e-4, 64, 4, 3, 40
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                        "torch_regressor")


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _leaf(tree, name):
    return dict(_leaves(tree))[name]


def _is_stat(name):
    return name.endswith(("['mean']", "['var']"))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """STEPS steps of the JAX trainer's make_steps from init_resnet50(
    PRNGKey(0)), each state written by its save_pytree before the step."""
    d = tmp_path_factory.mktemp("jax_regressor")
    params = jax.jit(lambda k: jrn.init_resnet50(k, num_outputs=OUT))(jax.random.PRNGKey(0))
    params0 = jax.device_get(params)
    tx, train_step, eval_step = jtr.make_steps(LR)
    opt_state = tx.init(params)
    rng = np.random.RandomState(0)
    xs = rng.uniform(-1, 1, (STEPS, B, SIZE, SIZE, 3)).astype(np.float32)
    ys = rng.uniform(0, 1, (STEPS, B, OUT)).astype(np.float32)
    paths, losses = [], []
    for t in range(STEPS + 1):
        paths.append(str(d / f"{t:03d}_dict.model.msgpack"))
        jckpt.save_pytree(paths[-1], {"model": params, "opt_state": opt_state},
                          meta={"epoch": t})
        if t < STEPS:
            params, opt_state, loss = train_step(params, opt_state, xs[t], ys[t])
            losses.append(float(loss))
    return {"paths": paths, "losses": losses, "xs": xs, "ys": ys, "params0": params0,
            "params": jax.device_get(params),
            "eval_loss": float(eval_step(params, xs[0], ys[0]))}


def _port(path=None):
    model = rn.ResNet50(num_outputs=OUT)
    opt, train_step, eval_step = tr.make_steps(model, LR)
    meta = tr.load_regressor(path, model, opt) if path else None
    return model, opt, train_step, eval_step, meta


def test_batchnorm2d_in_train_mode_is_the_jax_batch_norm():
    """biased batch variance for the output; running statistics moved by
    momentum 0.1, the variance made unbiased by n / (n - 1); eps 1e-5."""
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 5, 6, 8) * 2 + 1).astype(np.float32)
    p = {"gamma": (1 + 0.1 * rng.randn(8)).astype(np.float32),
         "beta": (0.1 * rng.randn(8)).astype(np.float32),
         "mean": (0.1 * rng.randn(8)).astype(np.float32),
         "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}
    want, stats = jrn.batch_norm(p, jnp.asarray(x), train=True)
    bn = torch.nn.BatchNorm2d(8)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["gamma"]))
        bn.bias.copy_(torch.from_numpy(p["beta"]))
        bn.running_mean.copy_(torch.from_numpy(p["mean"]))
        bn.running_var.copy_(torch.from_numpy(p["var"]))
    got = bn.train()(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-6)
    n = 4 * 5 * 6
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 * p["var"] + 0.1 * x.var((0, 1, 2)) * n / (n - 1),
                               rtol=1e-5)


def test_train_mode_forward_and_running_statistics_match_jax(jax_run):
    """The JAX step's loss is resnet50_forward(train=True)'s, and the
    statistics of its next state apply_bn_stats' of that forward."""
    x, y = jax_run["xs"][0], jax_run["ys"][0]
    want_params = ckpt._relistify(ckpt.load_pytree(jax_run["paths"][1])["model"])
    model, *_ = _port(jax_run["paths"][0])
    assert not model.training  # the frozen regressor's mode until the trainer asks
    with torch.no_grad():
        got = model.train()(torch.from_numpy(x))
    assert_close(float(torch.mean((got - torch.from_numpy(y)) ** 2)), jax_run["losses"][0])
    got_params = convert.resnet50_to_jax(model.state_dict())
    for (name, w), (_, g) in zip(_leaves(want_params), _leaves(got_params)):
        if _is_stat(name):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)
        else:  # the JAX step moved the weights; the forward did not
            np.testing.assert_array_equal(g, _leaf(jax_run["params0"], name), err_msg=name)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_the_gradient_matches_jax_in_f64_and_f32(jax_run):
    params = jax_run["params0"]
    x, y = jax_run["xs"][0], jax_run["ys"][0]
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)

        def loss_fn(p):
            preds, _ = jrn.resnet50_forward(p, jnp.asarray(x, jnp.float64), train=True,
                                            dtype=jnp.float64)
            return jnp.mean((preds - y) ** 2)

        want64 = jax.device_get(jax.jit(jax.grad(loss_fn))(p64))
    model, opt, train_step, _, _ = _port(jax_run["paths"][0])
    m64 = rn.ResNet50(num_outputs=OUT).double()
    m64.load_state_dict(model.state_dict())
    m64.train()
    torch.mean((m64(torch.from_numpy(x).double()) - torch.from_numpy(y).double()) ** 2).backward()
    got64 = convert.resnet50_to_jax({**m64.state_dict(),
                                     **{n: p.grad for n, p in m64.named_parameters()}})
    # f32: the port's gradient from its step; the JAX step's from its first
    # Adam moment (mu = (1 - b1) g after one step)
    train_step(torch.from_numpy(x), torch.from_numpy(y))
    got32 = convert.resnet50_to_jax({**model.state_dict(),
                                     **{n: p.grad for n, p in model.named_parameters()}})
    mu = ckpt.load_pytree(jax_run["paths"][1])["opt_state"]["0"]["mu"]
    want32 = ckpt._relistify(mu)
    flat = {k: [] for k in ("w64", "g64", "g32", "j32")}
    for (name, w), (_, g), (_, g32), (_, j) in zip(_leaves(want64), _leaves(got64),
                                                   _leaves(got32), _leaves(want32)):
        if _is_stat(name):
            continue
        assert_close(g, w)
        for k, v in (("w64", w), ("g64", g), ("g32", g32), ("j32", j / 0.1)):
            flat[k].append(np.ravel(v).astype(np.float64))
    w64, g32, j32 = (np.concatenate(flat[k]) for k in ("w64", "g32", "j32"))
    port, jax_err = _rel(g32, w64), _rel(j32, w64)
    assert port <= 2 * jax_err, (port, jax_err)


@pytest.mark.parametrize("t", range(STEPS))
def test_a_step_from_each_jax_state_matches_make_steps(jax_run, tmp_path, t):
    """State t, restored from the JAX trainer's checkpoint, written back byte
    for byte; one step against the JAX step from the same state."""
    model, opt, train_step, _, meta = _port(jax_run["paths"][t])
    assert meta == {"epoch": t}
    mine = str(tmp_path / "port.msgpack")
    ckpt.save_pytree(mine, tr.regressor_tree(model, opt), meta={"epoch": t})
    for suffix in ("", ".meta.json"):
        with open(mine + suffix, "rb") as f, open(jax_run["paths"][t] + suffix, "rb") as g:
            assert f.read() == g.read()
    loss = train_step(torch.from_numpy(jax_run["xs"][t]), torch.from_numpy(jax_run["ys"][t]))
    assert_close(float(loss), jax_run["losses"][t])
    got = tr.regressor_tree(model, opt)
    want = ckpt.load_pytree(jax_run["paths"][t + 1], like=got)
    assert int(got["opt_state"]["0"]["count"]) == int(want["opt_state"]["0"]["count"]) == t + 1
    for (name, w), (_, g) in zip(_leaves(want["model"]), _leaves(got["model"])):
        if _is_stat(name):
            assert _rel(g, w) <= 1e-4, (name, _rel(g, w))
        else:
            # 2 lr, and the rounding of a parameter moved by lr either way
            slack = 2 * LR + 2 * np.spacing(np.maximum(np.abs(g), np.abs(w)))
            assert np.all(np.abs(g - w) <= slack), (name, np.abs(g - w).max())


def test_the_checkpoint_restores_and_the_export_is_the_jax_export(jax_run, tmp_path):
    model, opt, train_step, eval_step, _ = _port(jax_run["paths"][STEPS])
    with torch.no_grad():
        loss = eval_step(torch.from_numpy(jax_run["xs"][0]), torch.from_numpy(jax_run["ys"][0]))
    assert_close(float(loss), jax_run["eval_loss"], rtol=1e-4, atol=1e-4)
    model.train()(torch.from_numpy(jax_run["xs"][0]))  # counts num_batches_tracked up
    model.load_state_dict(convert.resnet50_from_jax(
        ckpt.load_pytree(jax_run["paths"][STEPS], like=tr.regressor_tree(model, opt))["model"]))
    got, want = export_resnet50_torch(model), jexport(jax_run["params"])
    assert list(got) == list(model.state_dict()) and set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k].contiguous()), k
    path = str(tmp_path / "001_dict.model")
    torch.save({"model": got, "optm": {}}, path)
    fresh = rn.ResNet50(num_outputs=OUT)
    fresh.load_state_dict(torch.load(path, weights_only=True)["model"], strict=True)


def test_labels_and_splits_are_read_as_the_jax_package_reads_them():
    path = os.path.join(FIXTURES, "annotations.tsv")
    got, want = tr.load_labelfile(path), jtr.load_labelfile(path)
    assert list(got) == list(want) and len(got) == 10
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], want[k])
        assert got[k].shape == (OUT,)
    for split in ("training.txt", "test.txt"):
        args = (os.path.join(FIXTURES, "imgs"), os.path.join(FIXTURES, "split", split))
        assert tr.list_split(*args) == jtr.list_split(*args)
    assert len(tr.list_split(*args)) == 3


def test_the_cli_flow_writes_the_jax_trainer_files(tmp_path):
    out = tmp_path / "ckpt"
    argv = ["--data_dir", os.path.join(FIXTURES, "imgs"),
            "--label_path", os.path.join(FIXTURES, "annotations.tsv"),
            "--split_dir", os.path.join(FIXTURES, "split"), "--ckpt_dir", str(out),
            "--image_size", "32", "--batch_size", "4", "--n_epochs", "2", "--export_torch"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        model, opt = tr.main(argv, device="cpu")
    lines = buf.getvalue().splitlines()
    assert lines[:3] == ["train 7 / test 3 images", "native loader: True",
                         lines[2]] and lines[2].startswith("epoch 0 iter 0 Loss: ")
    assert lines[3].startswith("epoch 1 iter 0 Loss: ")
    assert lines[4].startswith("Test epoch 1; Loss: ") and len(lines) == 5
    assert np.isfinite(float(lines[4].rsplit(" ", 1)[1]))
    assert sorted(os.listdir(out)) == [
        "001_dict.model", "001_dict.model.msgpack", "001_dict.model.msgpack.meta.json",
        "002_dict.model", "002_dict.model.msgpack", "002_dict.model.msgpack.meta.json"]
    for epoch in (0, 1):
        path = str(out / f"{epoch + 1:03d}_dict.model.msgpack")
        fresh = rn.ResNet50(num_outputs=OUT)
        fresh_opt = torch.optim.Adam(fresh.parameters(), lr=LR)
        assert tr.load_regressor(path, fresh, fresh_opt) == {"epoch": epoch}
        assert int(fresh_opt.state_dict()["state"][0]["step"]) == 2 * (epoch + 1)
    for k, v in fresh.state_dict().items():  # the last epoch's: the model's
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, model.state_dict()[k]), k
    exported = torch.load(str(out / "002_dict.model"), weights_only=True)
    assert exported["optm"] == {}
    fresh.load_state_dict(exported["model"], strict=True)
    assert all(int(v) == 0 for k, v in exported["model"].items()
               if k.endswith("num_batches_tracked"))
