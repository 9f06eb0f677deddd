"""The port's own copies of the JAX package's host-side modules (options,
attribute vocabularies and their files, task schedules, to_uint8) behave as
the originals: same flags, an opt.yml the JAX package wrote parses
unchanged, same vocabularies, same alpha schedules, same uint8 rounding."""

import os

import numpy as np
import pytest

from latent2im_tpu.config import attributes as jattrs
from latent2im_tpu.config import options as joptions
from latent2im_tpu.tasks import transforms as jtasks
from latent2im_tpu.utils import image as jimage
from latent2im_tpu_torch.config import attributes as attrs
from latent2im_tpu_torch.config import options
from latent2im_tpu_torch.tasks import transforms as tasks
from latent2im_tpu_torch.utils import image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dests(parser):
    return {a.dest: (a.default, tuple(a.option_strings)) for a in parser._actions}


def test_every_flag_is_kept():
    assert _dests(options._build_train_parser()) == _dests(joptions._build_train_parser())
    assert _dests(options.VisOptions().parser) == _dests(joptions.VisOptions().parser)


def test_jax_written_opt_yml_parses_unchanged(tmp_path):
    args = ["--transform", "face", "--attrList", "Smiling,Young", "--layers",
            "0,1", "--models_dir", str(tmp_path), "--kernel_impl", "pallas",
            "--overwrite_config", "--resolution", "64"]
    jopt = joptions.TrainOptions().parse(args, print_opt=True)  # writes opt.yml
    yml = os.path.join(jopt.output_dir, "opt.yml")
    vis = ["--num_panels", "3", "--max_alpha", "0.5"]
    jo, jc = joptions.VisOptions().parse([yml] + vis)
    to, tc = options.VisOptions().parse([yml] + vis)
    strip = lambda ns: {k: v for k, v in vars(ns).items() if k != "config_file"}  # noqa: E731
    assert strip(to) == strip(jo)
    assert vars(tc).keys() == vars(jc).keys()
    for k in vars(jc):
        a, b = getattr(tc, k), getattr(jc, k)
        assert (vars(a) if hasattr(a, "__dict__") else a) == \
               (vars(b) if hasattr(b, "__dict__") else b), k
    assert options.experiment_name(jopt) == joptions.experiment_name(jopt)


@pytest.mark.parametrize("transform,attr_list", [
    ("face", None), ("face", "Smiling"), ("scene", "night,fog"), ("xray", None),
    ("dsprites", "scale,posx"), ("chair", None),
])
def test_attribute_vocabularies_match(transform, attr_list):
    names, table = attrs.build_attr_vocab(transform, attr_list=attr_list)
    jnames, jtable = jattrs.build_attr_vocab(transform, attr_list=attr_list)
    assert names == jnames and dict(table) == dict(jtable)
    assert attrs.attr_indices(names, table) == jattrs.attr_indices(jnames, jtable)
    assert attrs.parse_layers("0,3") == jattrs.parse_layers("0,3") == (0, 3)
    with pytest.raises(KeyError):
        attrs.build_attr_vocab(transform, attr_list="no_such_attribute")


def test_vocabulary_files_are_copies():
    for name in ("attributes_celeba.txt", "attributes_scene.txt"):
        with open(os.path.join(REPO, "latent2im_tpu_torch", "dataset", name), "rb") as f:
            port = f.read()
        with open(os.path.join(REPO, "dataset", name), "rb") as f:
            assert port == f.read(), name


@pytest.mark.parametrize("transform", ["face", "scene", "xray", "chair", "dsprites"])
def test_task_alpha_schedules_match(transform):
    t = tasks.get_task(transform, nsliders=2)
    jt = jtasks.get_task(transform, nsliders=2)
    assert (t.lo, t.hi) == (jt.lo, jt.hi)
    np.testing.assert_array_equal(t.scale_test_alpha(0.3, 4), jt.scale_test_alpha(0.3, 4))
    assert tasks.task_kwargs_from_options(type("O", (), {"transform": transform})) == {}


def test_geometric_tasks_are_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tasks.get_task("zoom")


def test_to_uint8_matches_jax_and_passes_uint8_through():
    x = np.random.RandomState(0).uniform(-1.3, 1.3, (2, 5, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(image.to_uint8(x), jimage.to_uint8(x))
    u = image.to_uint8(x)
    assert image.to_uint8(u) is u
