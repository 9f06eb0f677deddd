"""The port's LPIPS (latent2im_tpu_torch/models/lpips.py) and parity_check
CLI (cli/parity_check.py) against the JAX package, on the CPU:

- LPIPS on a tree of the JAX package's layout (``models/lpips.py:
  init_lpips``'s) carried across by ``io/convert.py:lpips_from_jax``,
  against the jitted ``lpips_forward``: within 1e-5 relative (f32 convs
  summed in another order);
- the loader of a PerceptualSimilarity ``vgg.pth`` layout (``lin{i}`` and
  ``lins.{i}`` names) beside a torchvision vgg16 state dict, against the
  JAX package's ``convert_lpips``, and its errors for a missing head or a
  wrong width, of the JAX package's types;
- ``parity_check record`` by the JAX CLI and ``compare`` by the port's, on
  the same towers (a seeded tiny G, ResNet-50/40, VGG19 through --g_path,
  --reg_path, --vgg_path; LPIPS heads and a vgg16 written here): the JAX
  recording compares cleanly (images within ``assert_images_close``'s CPU
  gate, the scores within 1e-4 of scale), and the port's own record on the
  CPU compares to zero.
"""

import warnings

import numpy as np
import pytest
import torch

import jax

from helpers import assert_close
from test_torch_cli import one_torch_thread  # noqa: F401 (autouse: one torch thread)

from latent2im_tpu.io import torch_convert as jtc
from latent2im_tpu.models import lpips as jlp
from latent2im_tpu_torch.engine.build import TINY_CHANNELS
from latent2im_tpu_torch.io.convert import lpips_from_jax, vgg_from_jax
from latent2im_tpu_torch.models import lpips as lp
from latent2im_tpu_torch.models import resnet as rn
from latent2im_tpu_torch.models import stylegan2 as sg2
from latent2im_tpu_torch.models import vgg as vggm

SIZE = 32


@jax.jit
def _jax_lpips_forward(convs, lins, x0, x1):
    """lpips_forward with the tree as an argument (its "cfg" leaf is a
    string, attached inside the trace): one compile for every tree."""
    return jlp.lpips_forward({"vgg": {"cfg": "vgg16", "convs": convs}, "lins": lins}, x0, x1)


def _jax_lpips(tree, x0, x1):
    return np.asarray(_jax_lpips_forward(tree["vgg"]["convs"], tree["lins"], x0, x1))


@pytest.fixture(scope="module")
def jax_lpips():
    """An LPIPS tree in the JAX package's layout (a seeded vgg16 and heads
    through its own converters: a JAX init of the vgg16 takes seconds) and
    two image batches."""
    gen = torch.Generator().manual_seed(0)
    vgg16 = vggm.VGG16Features(generator=gen)
    lin_sd = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=gen) * 0.1
              for i, c in enumerate(lp.LPIPS_CHANNELS)}
    tree = jtc.convert_lpips(lin_sd, jtc.convert_vgg_features(vgg16.state_dict(), "vgg16"))
    tree = jax.tree_util.tree_map(lambda a: a if isinstance(a, str) else np.asarray(a), tree)
    rng = np.random.RandomState(1)
    x0, x1 = (rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2))
    return tree, (x0, x1)


def _lpips(net, x0, x1):
    with torch.no_grad():
        return net(torch.from_numpy(x0), torch.from_numpy(x1)).numpy()


def test_lpips_matches_jax(jax_lpips):
    tree, (x0, x1) = jax_lpips
    want = _jax_lpips(tree, x0, x1)
    net = lp.LPIPS()
    net.load_state_dict(lpips_from_jax(tree), strict=True)
    got = _lpips(net, x0, x1)
    assert got.shape == (2,) and np.all(got > 0)
    assert_close(got, want, rtol=1e-5, atol=0)
    np.testing.assert_array_equal(_lpips(net, x0, x0), 0.0)


@pytest.mark.parametrize("prefix", ["lin{i}", "lins.{i}"])
def test_lpips_loads_the_release_heads_and_a_torchvision_vgg16(jax_lpips, prefix):
    tree, (x0, x1) = jax_lpips
    rng = np.random.RandomState(2)
    lin_sd = {f"{prefix.format(i=i)}.model.1.weight":
              torch.from_numpy(rng.uniform(0, 0.2, (1, c, 1, 1)).astype(np.float32))
              for i, c in enumerate(lp.LPIPS_CHANNELS)}
    vgg16_sd = vgg_from_jax(tree["vgg"])  # torchvision names, features.N.*
    want_tree = jtc.convert_lpips(lin_sd, jtc.convert_vgg_features(vgg16_sd, "vgg16"))
    want = _jax_lpips(want_tree, x0, x1)
    bare = {k[len("features."):]: v for k, v in vgg16_sd.items()}  # a features module's keys
    for sd in (vgg16_sd, bare):
        assert_close(_lpips(lp.LPIPS.from_state_dicts(lin_sd, sd), x0, x1), want, rtol=1e-5,
                     atol=0)


@pytest.mark.parametrize("case", ["missing", "width"])
def test_lpips_loader_refuses_as_the_jax_converter(jax_lpips, case):
    tree, _ = jax_lpips
    lin_sd = {f"lin{i}.model.1.weight": torch.zeros(1, c, 1, 1)
              for i, c in enumerate(lp.LPIPS_CHANNELS)}
    if case == "missing":
        del lin_sd["lin3.model.1.weight"]
    else:
        lin_sd["lin2.model.1.weight"] = torch.zeros(1, 7, 1, 1)
    err = KeyError if case == "missing" else ValueError
    vgg16_sd = vgg_from_jax(tree["vgg"])
    with pytest.raises(err):
        jtc.convert_lpips(lin_sd, jtc.convert_vgg_features(vgg16_sd, "vgg16"))
    with pytest.raises(err):
        lp.LPIPS.from_state_dicts(lin_sd, vgg16_sd)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def towers(tmp_path_factory, jax_lpips):
    tree, _ = jax_lpips
    tmp = tmp_path_factory.mktemp("parity")
    gen = torch.Generator().manual_seed(0)
    g = sg2.Generator(SIZE, 32, 2, channels=TINY_CHANNELS, generator=gen)
    torch.save({"g_ema": g.state_dict()}, tmp / "g.pt")
    torch.save(rn.ResNet50(num_outputs=40, generator=gen).state_dict(), tmp / "reg.pt")
    torch.save(vggm.VGG19Features(generator=gen).state_dict(), tmp / "vgg19.pt")
    torch.save(vgg_from_jax(tree["vgg"]), tmp / "vgg16.pt")
    torch.save({k: v for k, v in lpips_from_jax(tree).items() if k.startswith("lin")},
               tmp / "lpips_vgg.pth")
    flags = ["--g_path", str(tmp / "g.pt"), "--reg_path", str(tmp / "reg.pt"),
             "--vgg_path", str(tmp / "vgg19.pt"), "--resolution", str(SIZE), "--dev_tiny",
             "--n", "3", "--seed", "4"]
    lpips_flags = ["--lpips_path", str(tmp / "lpips_vgg.pth"), "--vgg16_path",
                   str(tmp / "vgg16.pt")]
    return tmp, flags, lpips_flags


def test_parity_check_compares_a_jax_recording_cleanly(towers, capsys):
    from latent2im_tpu.cli import parity_check as jpc
    from latent2im_tpu.config.attributes import default_attr_path
    from latent2im_tpu.config.options import TrainOptions as JTrainOptions
    from latent2im_tpu.engine import build as jbuild
    from latent2im_tpu.engine.editor import Editor as JEditor
    from latent2im_tpu.models import resnet as jrn
    from latent2im_tpu_torch.cli import parity_check as pc

    tmp, flags, lpips_flags = towers
    ref = str(tmp / "jax.npz")
    # the JAX CLI's build names an absolute --attrPath and --models_dir:
    # its parse reads the checkout's CelebA file and a directory here instead
    parse = JTrainOptions.parse

    def parse_in_checkout(self, args=None, print_opt=True):
        args = list(args)
        args[args.index("--attrPath") + 1] = default_attr_path("face")
        args[args.index("--models_dir") + 1] = str(tmp / "models")
        return parse(self, args, print_opt)

    # the JAX CLI's regressor runs eagerly (~12 s here): jitted, it computes
    # the same function; its build initialises a VGG19 (it does not read
    # --vgg_path) that record never runs: the port's, converted
    forward = jax.jit(lambda p, x: jrn.resnet50_forward(p, x)[0])
    vgg19 = jtc.convert_vgg_features(torch.load(tmp / "vgg19.pt"), "vgg19")
    with warnings.catch_warnings(), pytest.MonkeyPatch.context() as mp:
        warnings.simplefilter("ignore")
        mp.setattr(JEditor, "regress_all",
                   lambda self, img: forward(self.reg_params, self._reg_input(img)))
        mp.setattr(jbuild.vggm, "init_vgg", lambda key, cfg: vgg19)
        mp.setattr(JTrainOptions, "parse", parse_in_checkout)
        assert jpc.main(["record", "--out", ref, *flags]) is None
        report = pc.main(["compare", "--ref", ref, "--device", "cpu", *flags, *lpips_flags])
    recorded = np.load(ref)
    assert recorded["images"].shape == (3, SIZE, SIZE, 3) and recorded["scores"].shape == (3, 40)
    assert set(report) == {"max_abs_pixel_diff", "psnr_db", "vgg_feature_distance",
                           "max_abs_score_diff", "lpips"}
    assert report["max_abs_pixel_diff"] <= 2e-3  # assert_images_close's CPU gate
    assert report["psnr_db"] > 60
    assert 0 <= report["vgg_feature_distance"] < 1e-6
    scale = float(np.abs(recorded["scores"]).max())
    assert report["max_abs_score_diff"] <= 1e-4 * scale
    assert 0 <= report["lpips"] < 1e-4
    out = capsys.readouterr().out
    assert "max_abs_pixel_diff:" in out and "lpips:" in out


def test_parity_check_record_then_compare_on_the_cpu_is_exact(towers):
    from latent2im_tpu_torch.cli import parity_check as pc

    tmp, flags, lpips_flags = towers
    ref = str(tmp / "port.npz")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert pc.main(["record", "--out", ref, "--device", "cpu", *flags]) is None
        report = pc.main(["compare", "--ref", ref, "--device", "cpu", *flags, *lpips_flags])
        assert report == {"max_abs_pixel_diff": 0.0, "psnr_db": float("inf"),
                          "vgg_feature_distance": 0.0, "max_abs_score_diff": 0.0,
                          "lpips": 0.0}
        with pytest.raises(ValueError, match="seed"):
            pc.main(["compare", "--ref", ref, "--device", "cpu", *flags[:-1], "5"])
