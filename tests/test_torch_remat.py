"""--remat_g (all | block) and --remat_towers in the port's walk-training step
(latent2im_tpu_torch/engine/train.py, utils/remat.py) against the port's
plain step and the JAX package's step with the same flags, on the CPU.

The world is 32 px (tiny G and D channel tables, the full ResNet-50 and
VGG19, non-zero noise weights), made by the port's seeded init and carried
into the JAX package by its own torch converters. Both packages take the
same z, host-sampled alphas and the stored noise buffers. Tolerances:
against the JAX step, loss terms rtol 1e-4 (as tests/test_torch_train.py)
and the walk gradient 5e-2 relative L2 (see GRAD_REL_L2); a remat step
against the port's plain step, loss terms rtol 1e-5 and the walk gradient
rtol 1e-5 (the grid of tests/test_engine.py:305-340). The JAX step is
compiled once, with both options on (--remat_g block --remat_towers): the
JAX package's own tests hold each of its remat configurations to its plain
step, and every port configuration here is held to the port's plain step,
so one JAX compile covers the grid. With fresh noise from a
torch.Generator a remat step must give the plain step's gradient too: the
noise is drawn before each checkpointed region.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_cli import one_torch_thread  # noqa: F401 (autouse: one torch thread)

from latent2im_tpu.engine import train as jtrain
from latent2im_tpu.engine.editor import Editor as JEditor
from latent2im_tpu.engine.editor import EditorConfig as JEditorConfig
from latent2im_tpu.io import torch_convert as tc
from latent2im_tpu.models import stylegan2 as jsg2
from latent2im_tpu_torch.engine import train as T
from latent2im_tpu_torch.engine.editor import Editor, EditorConfig
from latent2im_tpu_torch.models import resnet as rn
from latent2im_tpu_torch.models import stylegan2 as sg2
from latent2im_tpu_torch.models import vgg as vggm
from latent2im_tpu_torch.tasks.transforms import get_task

SIZE, STYLE_DIM, BATCH, LR = 32, 32, 2, 1e-3
CHANNELS = {4: 16, 8: 16, 16: 8, 32: 8}
ATTR_LIST, ATTR_IDX, N_OUT = ("Smiling", "Young"), (31, 39), 40
TERMS = ("loss", "reg_loss", "content_loss", "gan_loss")
def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# the two packages' f32 walk gradients are 1.3e-2 apart (relative L2) in
# this world in every configuration, the plain one too: the port's f32 edited
# image (1.0e-6 from an f64 one, JAX's 8.9e-7) crosses a ReLU / max-pool kink
# of the regressor that JAX's does not, and the f64 regressor gradient
# itself moves by 3.6e-2 between the two images. So the JAX step bounds the
# gradient loosely; the plain port step, bit-identical on the CPU, tightly.
GRAD_REL_L2 = 5e-2
GRID = [("all", False), ("block", False), (False, True), ("block", True)]


def jax_world(seed=0):
    """The towers, seeded with torch at the JAX package's init scales (the
    port's modules, non-zero noise weights), their JAX pytrees made by the
    JAX package's own converters, and the step's inputs: (port towers
    (g, d, reg, vgg), JAX trees (g, d, reg, vgg), walk0, z, sampled)."""
    gen = torch.Generator().manual_seed(seed)
    g = sg2.Generator(SIZE, STYLE_DIM, 2, channels=CHANNELS, generator=gen)
    with torch.no_grad():
        for name, p in g.named_parameters():
            if name.endswith("noise.weight"):
                p.fill_(0.5)
    d = sg2.Discriminator(SIZE, channels=CHANNELS, generator=gen)
    reg = rn.ResNet50(num_outputs=N_OUT, generator=gen)
    vgg = vggm.VGG19Features(generator=gen)
    trees = (tc.convert_stylegan2_generator(g.state_dict(), SIZE, n_mlp=2),
             tc.convert_stylegan2_discriminator(d.state_dict(), SIZE),
             tc.convert_resnet50(reg.state_dict()),
             tc.convert_vgg_features(vgg.state_dict(), "vgg19"))
    rng = np.random.RandomState(seed)
    walk0 = (0.05 * rng.randn(len(ATTR_LIST), jsg2.n_latent(SIZE), STYLE_DIM)
             ).astype(np.float32)
    z = rng.randn(BATCH, STYLE_DIM).astype(np.float32)
    sampled = rng.uniform(0, 1, (BATCH, len(ATTR_LIST))).astype(np.float32)
    return (g, d, reg, vgg), trees, walk0, z, sampled


def port_editor(world, fixed_noise=True, **flags):
    g, d, reg, vgg = world[0]
    cfg = EditorConfig(attr_list=ATTR_LIST, attr_idx=ATTR_IDX, size=SIZE,
                       dim_z=STYLE_DIM, fixed_noise=fixed_noise, **flags)
    return Editor(cfg, g, reg, "cpu", vgg=vgg, d=d)


def port_step(ed, world, generator=None):
    """One host-alpha step (fresh noise from ``generator`` unless the editor
    uses the stored buffers) -> (loss terms, walk gradient, walk after)."""
    walk0, z, sampled = world[2:]
    walk = {"w": torch.from_numpy(walk0.copy()).requires_grad_()}
    step = T.make_train_step(ed, get_task("face"), T.make_optimizer(walk, LR),
                             host_alpha=True)
    m = step(walk, z, generator=generator, sampled=sampled)
    return ({k: float(m[k]) for k in TERMS}, walk["w"].grad.numpy().copy(),
            walk["w"].detach().numpy().copy())


def jax_step(world, **flags):
    (g, d, reg, vgg), walk0, z, sampled = world[1:]
    cfg = JEditorConfig(latent="w", walk_kind="linear_w", attr_list=ATTR_LIST,
                        attr_idx=ATTR_IDX, size=SIZE, dim_z=STYLE_DIM,
                        alpha_mode="target", fixed_noise=True, **flags)
    editor = JEditor(cfg, g, reg, vgg_params=vgg, d_params=d)
    # plain SGD at rate 1 leaves walk0 - grad: the JAX step's walk gradient
    optimizer = optax.sgd(1.0)
    walk = {"w": jnp.asarray(walk0)}
    step = jtrain.make_train_step(editor, None, optimizer, host_alpha=True)
    walk, _, m = step(walk, optimizer.init(walk), jnp.asarray(z),
                      jax.random.PRNGKey(0), sampled=jnp.asarray(sampled))
    return {k: float(m[k]) for k in TERMS}, walk0 - np.asarray(walk["w"])


@pytest.fixture(scope="module")
def world():
    return jax_world()


@pytest.fixture(scope="module")
def plain(world):
    return port_step(port_editor(world), world)


@pytest.fixture(scope="module")
def jax_remat(world):
    """The JAX step under --remat_g block --remat_towers."""
    return jax_step(world, remat_g="block", remat_towers=True)


@pytest.mark.parametrize("remat_g,remat_towers", GRID)
def test_remat_step_matches_the_plain_step_and_the_jax_step(world, plain, jax_remat,
                                                            remat_g, remat_towers):
    flags = dict(remat_g=remat_g, remat_towers=remat_towers)
    terms, grad, _ = port_step(port_editor(world, **flags), world)
    base_terms, base_grad, _ = plain
    for k in TERMS:
        np.testing.assert_allclose(terms[k], base_terms[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(grad, base_grad, rtol=1e-5, atol=1e-7)
    want_terms, want_grad = jax_remat
    for k in TERMS:
        np.testing.assert_allclose(terms[k], want_terms[k], rtol=1e-4, err_msg=k)
    assert rel_l2(grad, want_grad) < GRAD_REL_L2


@pytest.mark.parametrize("remat_g,remat_towers", GRID)
def test_remat_with_fresh_noise_gives_the_plain_gradient(world, remat_g, remat_towers):
    """The noise of the edited synthesis comes from a torch.Generator; drawn
    inside a checkpointed region it would differ on the recompute and the
    gradient would be wrong without an error."""
    def run(**flags):
        gen = torch.Generator().manual_seed(3)
        return port_step(port_editor(world, fixed_noise=False, **flags), world, gen)

    terms, grad, _ = run(remat_g=remat_g, remat_towers=remat_towers)
    base_terms, base_grad, _ = run()
    for k in TERMS:
        np.testing.assert_allclose(terms[k], base_terms[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(grad, base_grad, rtol=1e-5, atol=1e-7)
    assert np.abs(base_grad).max() > 0


def test_block_remat_synthesis_equals_the_plain_synthesis(world):
    ed = port_editor(world)
    lat = torch.from_numpy(np.random.RandomState(4).randn(
        2, sg2.n_latent(SIZE), STYLE_DIM).astype(np.float32)).requires_grad_()
    gen = torch.Generator().manual_seed(0)
    noise = ed.g.make_noise(2, gen)
    outs, grads = [], []
    for remat in (False, True):
        img = ed.synth(lat, noise=noise, block_remat=remat)
        (g,) = torch.autograd.grad(img.square().sum(), lat)
        outs.append(img.detach())
        grads.append(g)
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-6, atol=1e-7)
    assert dataclasses.replace(ed.cfg, remat_g="block").remat_g == "block"
