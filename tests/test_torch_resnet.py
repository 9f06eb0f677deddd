"""The port's ResNet-50 regressor (latent2im_tpu_torch/models/resnet.py)
against the JAX package's resnet50_forward on the CPU, on the same weights
carried over by latent2im_tpu_torch/io/convert.py, at 64 x 64 with
non-trivial eval-mode BN statistics. Tolerance 1e-4: 53 convolutions summed
in another order in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latent2im_tpu.models import resnet as jrn
from latent2im_tpu_torch.io import convert
from latent2im_tpu_torch.models import resnet as rn


def _np_resnet_tree(num_outputs=40, seed=0):
    """The JAX package's init_resnet50 structure, filled from a numpy seed:
    kaiming-scaled convs and BN statistics away from the identity."""
    shapes = jax.eval_shape(
        lambda k: jrn.init_resnet50(k, num_outputs=num_outputs),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = jax.tree_util.keystr(path)
        if name.endswith("['w']") and len(s.shape) == 4:
            kh, _, _, cout = s.shape
            return (rng.randn(*s.shape) * np.sqrt(2.0 / (kh * kh * cout))).astype(np.float32)
        if name.endswith("['gamma']"):
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name.endswith("['mean']") or name.endswith("['beta']") \
                or name.endswith("['b']"):
            return (0.1 * rng.randn(*s.shape)).astype(np.float32)
        return (rng.uniform(-1, 1, s.shape) / np.sqrt(2048)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_resnet50_matches_jax_with_bn_statistics():
    tree = _np_resnet_tree()
    net = rn.ResNet50(num_outputs=40)
    net.load_state_dict(convert.resnet50_from_jax(tree), strict=True)
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    want, _ = jrn.resnet50_forward(jax.tree_util.tree_map(jnp.asarray, tree),
                                   jnp.asarray(x))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_resnet50_layout_is_torchvision():
    """Parameter names and shapes of torchvision's resnet50 with fc -> 40,
    so a torchvision state_dict loads with strict=True."""
    sd = rn.ResNet50(num_outputs=40).state_dict()
    assert sd["conv1.weight"].shape == (64, 3, 7, 7)
    assert sd["layer1.0.downsample.0.weight"].shape == (256, 64, 1, 1)
    assert sd["layer4.2.bn3.running_var"].shape == (2048,)
    assert sd["fc.weight"].shape == (40, 2048)
    assert "layer3.5.bn2.num_batches_tracked" in sd
    assert len([k for k in sd if k.endswith(".weight") and sd[k].dim() == 4]) == 53
    with pytest.raises(RuntimeError):
        rn.ResNet50(num_outputs=40).load_state_dict({"fc.bias": torch.zeros(40)})
