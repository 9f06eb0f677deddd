"""Spatial partitioning (sp) of the PGGAN (model_256), GAN-zoo GNet and
StyleGAN1 generators of the port (their row-sharded forwards,
parallel/spatial.py) on the CPU, against one process and the JAX package's
sp forward of the same family.

On two launched gloo ranks (a 1 x 2 data x spatial mesh, min_rows_per_device
2, so every block from 4 px on qualifies), each family's forward runs on the
ranks' rows and gathers the image; a "step" backpropagates a fixed
projection of the image into z and G's parameters, their gradients summed
over the spatial ranks (as average_gradients sums a walk's). Gates: the
forward within tests/test_torch_spatial.py's FWD (atol = rtol = 2e-5) of one
process's, and within each family's own JAX parity gate (tests/
test_torch_pggan.py's 1e-5 of scale, tests/test_torch_stylegan1.py's
assert_images_close) of JAX's forward under its spatial_partitioning on a
1 x 2 mesh of virtual CPU devices; the gradients within 1e-5 relative L2 of
one process's.

The families at full channel width (the ladders' 512 channels), at small
steps: PGGAN step 3 (32 px), StyleGAN1 step 3 (32 px, nearest upsampling up
to fused_from and fused from there: fused_from 2 here, so both forms run on
rows), the zoo GNet with depths (16, 16, 8) (16 px) as tests/test_torch_pggan.py.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from latent2im_tpu_torch.models import pgan_zoo, pggan, stylegan1
from latent2im_tpu_torch.parallel import launch as L
from latent2im_tpu_torch.parallel import mesh as M
from latent2im_tpu_torch.parallel import spatial as S
from test_torch_spatial import FWD, MIN_ROWS, SPAWN_TIMEOUT, rel_l2

B, PG_STEP, S1_STEP, S1_FUSED_FROM = 2, 3, 3, 2
ZOO_DEPTHS = (16, 16, 8)
FAMILIES = ("pggan", "zoo", "stylegan1")


def _inputs():
    rng = np.random.RandomState(0)
    return {"z": rng.randn(B, 512).astype(np.float32),
            "z_zoo": rng.randn(B, 32).astype(np.float32),
            "noise": [rng.randn(B, 4 * 2 ** i, 4 * 2 ** i, 1).astype(np.float32)
                      for i in range(S1_STEP + 1)],
            "proj": rng.randn(B, 32, 32, 3).astype(np.float32)}


def _models(s1_state=None):
    """The generators, seeded; StyleGAN1 (from the JAX tree's state dict,
    which the parent converts) where s1_state is given."""
    gen = torch.Generator().manual_seed(0)
    out = {"pggan": pggan.Generator(n_label=0, generator=gen).eval(),
           "zoo": pgan_zoo.GNet(32, ZOO_DEPTHS, generator=torch.Generator().manual_seed(4)).eval()}
    if s1_state is not None:
        s1 = stylegan1.StyledGenerator(fused_from=S1_FUSED_FROM)
        s1.load_state_dict({k: torch.from_numpy(v) for k, v in s1_state.items()}, strict=True)
        out["stylegan1"] = s1.eval()
    return out


def _forward(name, g, x, noise):
    if name == "pggan":
        return g(x, step=PG_STEP)
    if name == "zoo":
        return g(x)
    return g(x, noise=noise, step=S1_STEP)


def run_families(s1_state, n_sp=None):
    """Each family's forward and the gradients of sum(image * proj) wrt z
    and G's parameters (summed over the spatial ranks), on a 1 x n_sp mesh
    or (None) in one process."""
    torch.set_num_threads(1)
    inp, models = _inputs(), _models(s1_state)
    mesh = ctx = None
    if n_sp:
        mesh = S.make_mesh_spatial(n_sp, 1)
        ctx = S.spatial_partitioning(mesh, min_rows_per_device=MIN_ROWS)
    out = {}
    for name, g in models.items():
        x = torch.from_numpy(inp["z_zoo" if name == "zoo" else "z"]).requires_grad_()
        noise = [torch.from_numpy(n) for n in inp["noise"]]
        with ctx or contextlib.nullcontext():
            img = _forward(name, g, x, noise)
        h = img.shape[1]
        (img * torch.from_numpy(inp["proj"][:, :h, :h])).sum().backward()
        grads = [x.grad] + [p.grad for p in g.parameters() if p.grad is not None]
        if mesh is not None:
            grads = [M.all_reduce(mesh, t, "spatial") for t in grads]
        out[name] = {"img": img.detach().numpy(),
                     "grad": np.concatenate([t.reshape(-1).numpy() for t in grads]),
                     "halo_bytes": ctx.plan.halo_bytes if ctx else 0}
    return out


@pytest.fixture(scope="module")
def s1_tree():
    import jax

    from latent2im_tpu.models import stylegan1 as js1

    t = jax.device_get(jax.jit(js1.init_styled_generator)(jax.random.PRNGKey(3)))
    rng = np.random.RandomState(4)
    for p in t["progression"]:
        for k in ("noise1_w", "noise2_w"):
            p[k] = (0.3 * rng.randn(*p[k].shape)).astype(np.float32)
    return t


@pytest.fixture(scope="module")
def s1_state(s1_tree):
    from latent2im_tpu_torch.io.convert import stylegan1_from_jax

    return {k: v.numpy() for k, v in
            stylegan1_from_jax(s1_tree, fused_from=S1_FUSED_FROM).items()}


@pytest.fixture(scope="module")
def single(s1_state):
    n = torch.get_num_threads()
    try:
        return run_families(s1_state)
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(s1_state):
    return L.launch(run_families, (s1_state, 2), world_size=2, device="cpu",
                    timeout=SPAWN_TIMEOUT)


@pytest.fixture(scope="module")
def jax_sp(s1_tree):
    """Each family's JAX forward under the JAX package's
    spatial_partitioning on a 1 x 2 mesh of virtual CPU devices."""
    import jax
    import jax.numpy as jnp

    from latent2im_tpu.io import torch_convert as jtc
    from latent2im_tpu.models import pgan_zoo as jzoo
    from latent2im_tpu.models import pggan as jpgg
    from latent2im_tpu.models import stylegan1 as js1
    from latent2im_tpu.parallel import spatial as jsp

    if jax.device_count() < 2:
        pytest.skip("needs 2 devices (virtual CPU mesh)")
    inp, models = _inputs(), _models()
    sd = models["pggan"].state_dict()
    jg = jtc.convert_pggan_generator({**sd, "label_embed.weight": torch.zeros(10, 10)})
    del jg["label_embed"]
    jz = jtc.convert_ganzoo_pgan({f"module.{k}": v for k, v in models["zoo"].state_dict().items()})
    mesh = jsp.make_mesh_spatial(n_spatial=2, n_data=1)
    out = {}
    with jsp.spatial_partitioning(mesh, min_rows_per_device=MIN_ROWS):
        out["pggan"] = jax.jit(lambda p, z: jpgg.generator_forward(p, z, step=PG_STEP))(
            jg, inp["z"])
        out["zoo"] = jax.jit(lambda p, z: jzoo.generator_forward(p, z))(jz, inp["z_zoo"])
        out["stylegan1"] = jax.jit(lambda p, z, n: js1.styled_generator_forward(
            p, z, noise=n, step=S1_STEP, fused_from=S1_FUSED_FROM))(
            s1_tree, jnp.asarray(inp["z"]), [jnp.asarray(n) for n in inp["noise"]])
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("name", FAMILIES)
def test_row_sharded_forward_equals_one_process_and_jax_sp(name, ranks, single, jax_sp):
    from helpers import assert_close, assert_images_close

    got = ranks[name]["img"]
    assert got.shape == single[name]["img"].shape
    np.testing.assert_allclose(got, single[name]["img"], **FWD)
    if name == "stylegan1":
        assert_images_close(got, jax_sp[name])
    else:
        assert_close(got, jax_sp[name], rtol=1e-5,
                     atol=1e-5 * max(float(np.abs(jax_sp[name]).max()), 1.0))
    assert ranks[name]["halo_bytes"] > 0  # the rows did cross ranks


@pytest.mark.parametrize("name", FAMILIES)
def test_row_sharded_gradients_equal_one_process(name, ranks, single):
    got, want = ranks[name]["grad"], single[name]["grad"]
    assert got.shape == want.shape
    assert rel_l2(got, want) < 1e-5, rel_l2(got, want)


def test_fused_upsample_on_rows_reads_one_halo_row_in_f64():
    """StyleGAN1's stride-2 transposed conv on two rows shards (its halo
    from the neighbour's rows, zeros past the image) equals the whole
    conv's rows, in f64; a one-rank plan's halo is zeros, so each shard is
    computed as the image's top or bottom by turns."""
    gen = torch.Generator().manual_seed(5)
    up = stylegan1.FusedUpsample(4, 3, 3, 1, generator=gen).double()
    x = torch.randn(2, 4, 8, 6, dtype=torch.float64, generator=gen)
    whole = up(x)

    class Rows:  # the halo rows of a two-shard split of x, by hand
        def __init__(self, top):
            self.top = top

        def halo(self, t, r, dim):
            zero = torch.zeros_like(t.narrow(dim, 0, r))
            nb = x.narrow(dim, 4, r) if self.top else x.narrow(dim, 4 - r, r)
            return torch.cat([zero, t, nb] if self.top else [nb, t, zero], dim)

    top, bottom = up(x[:, :, :4], Rows(True)), up(x[:, :, 4:], Rows(False))
    torch.testing.assert_close(torch.cat([top, bottom], 2), whole, rtol=1e-12, atol=1e-12)
