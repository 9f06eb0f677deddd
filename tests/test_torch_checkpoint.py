"""The port's checkpoint files (latent2im_tpu_torch/io/{msgpack_codec,
checkpoint,torch_convert}.py) against the JAX package's, on the CPU:

- the pure-Python msgpack codec round-trips every type it takes, writes the
  bytes flax writes, and names the byte it refuses;
- a walk + optax.adam state saved by the JAX package loads in the port bit
  for bit, and the port's save loads in the JAX package bit for bit (the
  files are byte-identical);
- one Adam step from the carried-over state matches optax (rtol 1e-6);
- the reference's pickled walk module crosses both ways;
- a JAX msgpack GAN tree loads through --save_path_gan and synthesises what
  JAX synthesises (assert_images_close's CPU gate).
"""

import copy
import os
import struct
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from helpers import assert_images_close
from latent2im_tpu.engine.train import make_optimizer as jmake_optimizer
from latent2im_tpu.io import checkpoint as jckpt
from latent2im_tpu.io import torch_convert as jtc
from latent2im_tpu.models import stylegan2 as jsg2
from latent2im_tpu_torch.engine.train import make_optimizer
from latent2im_tpu_torch.io import checkpoint as ckpt
from latent2im_tpu_torch.io import msgpack_codec as mc
from latent2im_tpu_torch.io import torch_convert as tc
from test_torch_stylegan2 import TINY, _perturbed_jax_generator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (2, 8, 32)  # linear_w [A, L, D] at 32 px, dim_z 32
LR = 1e-3


def _same(a, b):
    """Equal trees: same keys, same types, arrays equal in dtype and shape."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), (a, b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, (np.ndarray, np.generic)):
        assert type(a) is type(b) and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


TREES = {
    "scalars": {"nil": None, "t": True, "f": False, "f64": 2.5, "neg": -1.25e-300,
                "s": "walk", "utf8": "Smílíng", "bin": b"\x00\xff"},
    "ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
             -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63],
    "lengths": {"str8": "x" * 40, "str16": "y" * 300, "bin16": b"z" * 300,
                "arr16": list(range(20)), "map16": {str(i): i for i in range(20)},
                "empty_map": {}, "empty_arr": []},
    "arrays": {"f32": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
               "f64": np.linspace(0, 1, 5), "i32_0d": np.asarray(7, np.int32),
               "u8": np.arange(200, dtype=np.uint8).reshape(2, 100),
               "empty": np.zeros((0, 3), np.float32), "bool": np.array([True, False]),
               "i64": np.asarray([-(2**40), 2**40], np.int64)},
    "npscalars": {"f32": np.float32(1.5), "i64": np.int64(-3), "u16": np.uint16(9)},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_msgpack_codec_roundtrips_and_writes_flax_bytes(name):
    tree = TREES[name]
    data = mc.packb(tree)
    assert data == serialization.msgpack_serialize(copy.deepcopy(tree), in_place=True)
    _same(mc.unpackb(data), serialization.msgpack_restore(data))
    back = mc.unpackb(data)
    if isinstance(tree, dict):
        for k, v in tree.items():
            if isinstance(v, (np.ndarray, np.generic)):
                _same(back[k], v)
            else:
                assert back[k] == v
    else:
        assert back == tree


def test_msgpack_codec_reads_float32_chunked_arrays_and_refuses_the_rest():
    assert mc.unpackb(b"\xca" + struct.pack(">f", 1.5)) == 1.5
    arr = np.arange(10, dtype=np.float32)
    chunked = {"__msgpack_chunked_array__": True, "shape": {"0": 2, "1": 5},
               "chunks": {"0": arr[:6], "1": arr[6:]}}
    np.testing.assert_array_equal(mc.unpackb(mc.packb({"a": chunked}))["a"],
                                  arr.reshape(2, 5))
    for data, what in [(b"\xc1", "type byte 0xc1 at offset 0"),
                       (b"\x81\xa1a\xd4\x05\x00", "extension type 5 at offset 3"),
                       (b"\xd4\x01\x01", "malformed array payload at offset 0"),
                       (b"\x92\x01", "truncated"), (b"\x01\x02", "trailing")]:
        with pytest.raises(mc.MsgpackError, match=what):
            mc.unpackb(data)
    with pytest.raises(mc.MsgpackError, match="cannot encode"):
        mc.packb({"a": object()})


def _jax_state_after_one_update(seed=0):
    rng = np.random.RandomState(seed)
    jwalk = {"w": jnp.asarray(0.02 * rng.randn(*SHAPE), jnp.float32)}
    opt = jmake_optimizer(LR)
    st = opt.init(jwalk)
    grad = {"w": jnp.asarray(rng.randn(*SHAPE), jnp.float32)}
    upd, st = opt.update(grad, st, jwalk)
    return opt, optax.apply_updates(jwalk, upd), st


def _like():
    like = {"w": torch.zeros(SHAPE)}
    return like, make_optimizer(like, LR).state_dict()


def test_walk_and_adam_state_cross_both_ways_bit_for_bit(tmp_path):
    opt, jwalk, st = _jax_state_after_one_update()
    jpath = jckpt.save_walk(str(tmp_path), 3, jwalk, opt_state=st)
    like, like_state = _like()
    walk, state, meta = ckpt.load_walk(jpath, like, opt_state_like=like_state)
    assert meta == {"epoch": 3, "final": False}
    np.testing.assert_array_equal(walk["w"].numpy(), np.asarray(jwalk["w"]))
    s = state["state"][0]
    assert float(s["step"]) == 1.0 and int(st[0].count) == 1
    np.testing.assert_array_equal(s["exp_avg"].numpy(), np.asarray(st[0].mu["w"]))
    np.testing.assert_array_equal(s["exp_avg_sq"].numpy(), np.asarray(st[0].nu["w"]))
    assert state["param_groups"][0]["betas"] == (0.5, 0.99)

    out = tmp_path / "port"
    out.mkdir()
    ppath = ckpt.save_walk(str(out), 3, walk, opt_state=state)
    with open(jpath, "rb") as a, open(ppath, "rb") as b:
        assert a.read() == b.read()  # the same file, byte for byte
    jlike = {"w": jnp.zeros(SHAPE, jnp.float32)}
    jw, jst, jmeta = jckpt.load_walk(ppath, jlike, opt_state_like=opt.init(jlike))
    assert jmeta == meta
    for got, want in [(jw["w"], jwalk["w"]), (jst[0].mu["w"], st[0].mu["w"]),
                      (jst[0].nu["w"], st[0].nu["w"]), (jst[0].count, st[0].count)]:
        assert np.asarray(got).dtype == np.asarray(want).dtype
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    # before a first step: optax's init state <-> an empty torch Adam state
    ppath0 = ckpt.save_walk(str(out), 0, walk, opt_state=like_state)
    _, jst0, _ = jckpt.load_walk(ppath0, jlike, opt_state_like=opt.init(jlike))
    assert int(jst0[0].count) == 0 and not np.asarray(jst0[0].mu["w"]).any()
    _, st0, _ = ckpt.load_walk(ppath0, like, opt_state_like=like_state)
    assert st0["state"] == {}
    with pytest.raises(ValueError, match="shape"):
        ckpt.load_walk(jpath, {"w": torch.zeros(1, 8, 32)})


def test_one_adam_step_from_the_carried_over_state_matches_optax(tmp_path):
    opt, jwalk, st = _jax_state_after_one_update(seed=1)
    jpath = jckpt.save_walk(str(tmp_path), 0, jwalk, opt_state=st)
    like, like_state = _like()
    walk, state, _ = ckpt.load_walk(jpath, like, opt_state_like=like_state)
    grad = np.random.RandomState(2).randn(*SHAPE).astype(np.float32)
    w = walk["w"].requires_grad_(True)
    optimizer = make_optimizer(walk, LR)
    optimizer.load_state_dict(state)
    w.grad = torch.from_numpy(grad)
    optimizer.step()
    upd, st2 = opt.update({"w": jnp.asarray(grad)}, st, jwalk)
    got = optimizer.state_dict()["state"][0]
    # rtol 1e-6 of each array's largest value: the two round in other orders,
    # so an element near 0 differs by an ulp of its neighbours' scale
    for name, a, ref in (("w", w.detach(), optax.apply_updates(jwalk, upd)["w"]),
                         ("mu", got["exp_avg"], st2[0].mu["w"]),
                         ("nu", got["exp_avg_sq"], st2[0].nu["w"])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(a.numpy(), ref, rtol=1e-6,
                                   atol=1e-6 * np.abs(ref).max(), err_msg=name)
    assert float(got["step"]) == int(st2[0].count) == 2


def test_reference_walk_module_crosses_both_ways(tmp_path):
    w = (0.1 * np.random.RandomState(3).randn(*SHAPE)).astype(np.float32)
    jref = str(tmp_path / "jax_ref_walk_module.ckpt")
    jtc.export_walk_torch(jref, "linear_w", {"w": w}, attr_list=["Smiling", "Young"])
    walk, state, meta = ckpt.load_walk(jref, {"w": torch.zeros(SHAPE)})
    assert state is None and meta == {"source": "torch", "cls": "WalkLinearMultiW"}
    np.testing.assert_array_equal(walk["w"].numpy(), w)

    pref = str(tmp_path / "port_ref_walk_module.ckpt")
    tc.export_walk_torch(pref, "linear_w", walk)
    cls, st = jtc.load_walk_checkpoint(pref)
    assert cls == "WalkLinearMultiW"
    np.testing.assert_array_equal(st["w"], w)
    jw, _, jmeta = jckpt.load_walk(pref, {"w": jnp.zeros(SHAPE)})
    np.testing.assert_array_equal(np.asarray(jw["w"]), w)
    with pytest.raises(NotImplementedError, match="item 18"):
        tc.export_walk_torch(pref, "mlp_w", {})
    with pytest.raises(NotImplementedError, match="item 18"):
        tc.convert_walk_state("WalkMlpMultiW", {}, [])
    # single-attribute walks merged into a bank, as the JAX package does
    single = {"w": w[1:2] + 1.0}
    got = ckpt.merge_walk_banks({"w": torch.from_numpy(w)}, [("Young", single)],
                                ["Smiling", "Young"])
    want = jckpt.merge_walk_banks({"w": w}, [("Young", single)], ["Smiling", "Young"])
    np.testing.assert_array_equal(got["w"].numpy(), want["w"])


def _tiny_conf(models_dir):
    from latent2im_tpu_torch.config.options import TrainOptions

    return TrainOptions().parse(
        ["--transform", "face", "--attrList", "Smiling", "--models_dir", models_dir,
         "--dev_tiny", "--resolution", "32", "--no_content_loss"], print_opt=False)


@pytest.mark.parametrize("fmt", ["jax_msgpack", "torch_pt"])
def test_gan_checkpoint_loads_through_save_path_gan(tmp_path, fmt):
    from latent2im_tpu_torch.engine.build import load_editor_for_inference
    from latent2im_tpu_torch.io.convert import discriminator_from_jax, generator_from_jax

    g_run = _perturbed_jax_generator(32, TINY, seed=21)
    d_shapes = jax.eval_shape(lambda k: jsg2.init_discriminator(k, 32, channels=TINY),
                              jax.random.PRNGKey(0))
    rng = np.random.RandomState(23)
    d_tree = jax.tree_util.tree_map(
        lambda s: (0.1 * rng.randn(*s.shape)).astype(np.float32), d_shapes)
    path = str(tmp_path / "model_gan_1_final.ckpt")
    if fmt == "jax_msgpack":  # as the JAX trainer's _save_gan writes it
        g_other = _perturbed_jax_generator(32, TINY, seed=22)
        jckpt.save_pytree(path, {"g": g_other, "g_running": g_run, "d": d_tree})
    else:
        torch.save({"g_ema": generator_from_jax(g_run),
                    "d": discriminator_from_jax(d_tree)}, path)
    opt = type("Opt", (), {"save_path_w": None, "save_path_gan": path,
                           "attrList": None, "attrPath": ""})()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ed, _, _ = load_editor_for_inference(opt, _tiny_conf(str(tmp_path)),
                                             device="cpu")
    z = np.random.RandomState(4).randn(2, 32).astype(np.float32)
    want = jax.jit(lambda g, z: jsg2.synthesize(
        g, jnp.broadcast_to(jsg2.style_forward(g, z)[:, None], (2, 8, 32))))(
            g_run, jnp.asarray(z))
    got = ed.synthesize(ed.get_w(z))
    assert_images_close(got.numpy(), np.asarray(want))
    d_sd = discriminator_from_jax(d_tree)
    for k, v in ed.d.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), d_sd[k].numpy())
