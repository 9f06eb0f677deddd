"""Tensor parallelism of the port (latent2im_tpu_torch/parallel/tensor.py,
mesh.py:frozen_tp_shardings, make_train_step(frozen_shardings=)) against
the single-process port and the JAX package's tensor-parallel step, on the
CPU.

The styled conv's split (ops.styled_conv3x3_partial on each Cin shard,
summed, then ops.styled_conv3x3_epilogue) is held in plain form to an f64
reference: f32 within 1e-6 of max|ref|, bf16 within 2^-7; its gradient to
the fused op's by gradcheck in f64.

The tp step runs on launched gloo ranks (parallel/launch.py, one torch
thread each) on (data x model) meshes 1x2, 2x2 and 1x4, in the world of
tests/test_torch_spatial.py (the 32 px tiny-channel G and D, the full
ResNet-50 and VGG19). G's tp forward and input gradient equal one process's
in f64 (1e-12). Each mesh's f32 loss terms lie within 1e-6 (relative) of
one process's; its walk gradient within 1e-5 relative L2 of the same step
in f64 (chip_smoke.reference_step): one process's own f32 walk gradient is
1.37e-5 from it in this world and the tp step's ~1.3e-6, so their 1.4e-5
distance from each other is the single process's f32 rounding, which a 1e-5
gate between the two could not hold. The walk after Adam at
tests/test_engine.py's gates (rtol 1e-4, atol 1e-6). JAX's own tp step
(make_train_step with frozen_tp_shardings on its 2x4 mesh of virtual CPU
devices, as tests/test_engine.py runs it) is held at that test's gates:
loss rtol 2e-4, walk rtol 1e-4 atol 1e-6. A bf16 step (--bf16) on 1x2 is
held to one process's bf16 step (loss terms 2^-8 relative, one bf16
rounding) and its walk gradient to the f64 step by the card's rule (within
1.5 x one process's bf16 distance from it, chip_smoke.py phase 36).
"""

from __future__ import annotations

import contextlib
import copy

import numpy as np
import pytest
import torch

from latent2im_tpu_torch import ops
from latent2im_tpu_torch.engine import train as T
from latent2im_tpu_torch.engine.editor import Editor, EditorConfig
from latent2im_tpu_torch.models import hooks
from latent2im_tpu_torch.models import stylegan2 as sg2
from latent2im_tpu_torch.parallel import launch as L
from latent2im_tpu_torch.parallel import mesh as M
from latent2im_tpu_torch.parallel import tensor as TP
from latent2im_tpu_torch.tasks.transforms import get_task
from test_torch_spatial import (ATTR_IDX, ATTR_LIST, LR, SIZE, SPAWN_TIMEOUT, STYLE_DIM,
                                TERMS, rel_l2, world)

TP_MESHES = ((1, 2), (2, 2), (1, 4))


def _editor(towers, fixed_noise=True, dtype=torch.float32):
    g, d, reg, vgg = towers
    cfg = EditorConfig(attr_list=ATTR_LIST, attr_idx=ATTR_IDX, size=SIZE, dim_z=STYLE_DIM,
                       fixed_noise=fixed_noise, compute_dtype=dtype)
    return Editor(cfg, g, reg, "cpu", vgg=vgg, d=d)


def _np(t):
    return t.detach().float().numpy().copy()


def run_tp(n_data=None, n_model=1, built=None):
    """One step with the stored noise, one with fresh noise and one in bf16
    -> {name: (loss terms, walk gradient, walk after Adam)}, on a (n_data x
    n_model) mesh with G tensor-parallel, or (n_data None) in one process;
    and the bytes the tp plan all-reduced."""
    torch.set_num_threads(1)
    towers, walk0, z, sampled = built or world()
    mesh = None if n_data is None else M.make_mesh_2d(n_data, n_model)
    out = {}
    for name, fixed, dtype in (("step", True, torch.float32),
                               ("step_fresh", False, torch.float32),
                               ("step_bf16", True, torch.bfloat16)):
        # a G of its own: the tp step cuts it to this rank's shards
        ed = _editor((copy.deepcopy(towers[0]), *towers[1:]), fixed, dtype)
        sh = None if mesh is None else M.frozen_tp_shardings(mesh, ed.frozen_params())
        w = {"w": torch.from_numpy(walk0.copy()).requires_grad_()}
        step = T.make_train_step(ed, get_task("face"), T.make_optimizer(w, LR),
                                 host_alpha=True, mesh=mesh, frozen_shardings=sh)
        m = step(w, z, generator=torch.Generator().manual_seed(3), sampled=sampled)
        out[name] = ({k: float(m[k]) for k in TERMS}, _np(w["w"].grad), _np(w["w"]))
    return out


def tp_world(n):
    """run_tp on each tp mesh of n ranks, in one world; and every rank's
    tp_copy_reduce on a 1 x n mesh."""
    import torch.distributed as dist

    built = world()
    out = {shape: run_tp(*shape, built=built) for shape in TP_MESHES
           if shape[0] * shape[1] == n}
    objs = [None] * n
    dist.all_gather_object(objs, tp_copy_reduce(n))
    out["copy_reduce"] = objs
    out["generator_f64"] = tp_generator(n)
    return out


@pytest.fixture(scope="module")
def single():
    """run_tp in one process, and (under "grad_f64") the walk gradient of
    the same step in f64."""
    import chip_smoke

    n = torch.get_num_threads()
    try:
        out = run_tp()
        towers, walk0, z, sampled = world()
        ed = _editor(towers)
        for m in (ed.g, ed.reg, ed.vgg, ed.d):
            m.double()
        out["grad_f64"] = chip_smoke.reference_step(ed, {"w": walk0}, z, sampled,
                                                    torch.float64)[1]
        return out
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks():
    cache = {}

    def get(n):
        if n not in cache:
            cache[n] = L.launch(tp_world, (n,), world_size=n, device="cpu",
                                timeout=SPAWN_TIMEOUT)
        return cache[n]

    return get


@pytest.fixture(scope="module")
def jax_tp():
    """JAX's tp step (stylegan2_tp_specs over 'model' of its 2x4 mesh),
    once: its loss terms and walk gradient (SGD at rate 1 leaves walk0 -
    grad) and the walk after one optax Adam step on that gradient."""
    import jax
    import jax.numpy as jnp
    import optax

    from latent2im_tpu.engine import train as jtrain
    from latent2im_tpu.engine.editor import Editor as JEditor
    from latent2im_tpu.engine.editor import EditorConfig as JEditorConfig
    from latent2im_tpu.io import torch_convert as tc
    from latent2im_tpu.parallel import mesh as jmesh

    if jax.device_count() < 8:
        pytest.skip("needs 8 devices (virtual CPU mesh)")
    (g, d, reg, vgg), walk0, z, sampled = world()
    cfg = JEditorConfig(latent="w", walk_kind="linear_w", attr_list=ATTR_LIST,
                        attr_idx=ATTR_IDX, size=SIZE, dim_z=STYLE_DIM,
                        alpha_mode="target", fixed_noise=True)
    ed = JEditor(cfg, tc.convert_stylegan2_generator(g.state_dict(), SIZE, n_mlp=2),
                 tc.convert_resnet50(reg.state_dict()),
                 vgg_params=tc.convert_vgg_features(vgg.state_dict(), "vgg19"),
                 d_params=tc.convert_stylegan2_discriminator(d.state_dict(), SIZE))
    mesh = jmesh.make_mesh_2d(n_data=2, n_model=4)
    sgd = optax.sgd(1.0)
    step = jtrain.make_train_step(ed, None, sgd, mesh=mesh, host_alpha=True,
                                  frozen_shardings=jmesh.frozen_tp_shardings(
                                      mesh, ed.frozen_params()))
    walk = jmesh.replicate(mesh, {"w": jnp.asarray(walk0)})
    moved, _, m = step(walk, jmesh.replicate(mesh, sgd.init(walk)),
                       jmesh.shard_batch(mesh, z), jax.random.PRNGKey(0),
                       sampled=jmesh.shard_batch(mesh, sampled))
    grad = walk0 - np.asarray(jax.device_get(moved)["w"])
    adam, walk = jtrain.make_optimizer(LR), {"w": jnp.asarray(walk0)}
    upd, _ = adam.update({"w": jnp.asarray(grad)}, adam.init(walk), walk)
    return {"terms": {k: float(m[k]) for k in TERMS},
            "after": np.asarray(optax.apply_updates(walk, upd)["w"]),
            "g_specs": jmesh.stylegan2_tp_specs(ed.frozen_params()["g"])}


# ---------------------------------------------------------------------------
# the split kernel, plain form
# ---------------------------------------------------------------------------


def _operands(dtype, b=2, h=6, w=5, cin=16, cout=8, seed=0):
    gen = torch.Generator().manual_seed(seed)

    def r(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, dtype=torch.float64) * scale + shift)

    ops64 = dict(x=r(b, h, w, cin), w=r(3, 3, cin, cout, scale=1 / 12), s=r(b, cin, shift=1.0),
                 d=r(b, cout, scale=0.1, shift=1.0), noise=r(1, h, w),
                 noise_w=torch.tensor([0.3], dtype=torch.float64), bias=r(cout, scale=0.1))
    cast = {k: v.to(dtype) for k, v in ops64.items()}
    for k in ("noise_w", "bias"):  # f32 in the kernels' bf16 form too
        cast[k] = ops64[k].to(torch.promote_types(dtype, torch.float32))
    # the f64 reference takes the operands as the cast holds them
    return cast, {k: v.to(torch.float64) for k, v in cast.items()}


def _split(o, n):
    """partial over n Cin shards, summed, then the epilogue."""
    k = o["x"].shape[-1] // n
    acc = sum(ops.styled_conv3x3_partial(o["x"][..., i * k:(i + 1) * k].contiguous(),
                                         o["w"][:, :, i * k:(i + 1) * k].contiguous(),
                                         o["s"][:, i * k:(i + 1) * k].contiguous())
              for i in range(n))
    return ops.styled_conv3x3_epilogue(acc, o["d"], o["noise"], o["noise_w"], o["bias"])


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("dtype,tol", ((torch.float32, 1e-6), (torch.bfloat16, 2.0 ** -7)),
                         ids=("f32", "bf16"))
def test_split_in_plain_form_equals_the_whole_conv(n, dtype, tol):
    """Summed over 2 and 4 Cin shards: the f64 reference of the same
    operands (for bf16, of the bf16-rounded x * s as the kernel takes it)."""
    o, o64 = _operands(dtype)
    got = _split(o, n)
    if dtype == torch.bfloat16:
        o64["x"] = (o["x"].float() * o["s"].float()[:, None, None, :]).to(dtype).double()
        o64["s"] = torch.ones_like(o64["s"])
    want = ops.styled_conv3x3_plain(*(o64[k] for k in ("x", "w", "s", "d", "noise", "noise_w",
                                                        "bias")))
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.double() - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err
    acc = ops.styled_conv3x3_partial(o["x"], o["w"], o["s"])
    assert acc.dtype == torch.float32  # the partial sums cross ranks in f32


def test_split_gradient_equals_the_fused_ops_in_f64():
    o, _ = _operands(torch.float64, b=2, h=4, w=3, cin=8, cout=4)
    names = ("x", "w", "s", "d", "noise", "noise_w", "bias")
    args = [o[k].clone().requires_grad_() for k in names]
    assert torch.autograd.gradcheck(lambda *a: _split(dict(zip(names, a)), 2), args)
    fused = [o[k].clone().requires_grad_() for k in names]
    c = torch.randn(2, 4, 3, 4, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    (_split(dict(zip(names, args)), 2) * c).sum().backward()
    (ops.styled_conv3x3(*fused) * c).sum().backward()
    for k, a, f in zip(names, args, fused):
        torch.testing.assert_close(a.grad, f.grad, rtol=1e-12, atol=1e-12, msg=k)


def test_split_wrappers_run_their_plain_versions_on_the_cpu_and_count_nothing():
    o, _ = _operands(torch.float32)
    ops.reset_launches()
    acc = ops.styled_conv3x3_partial(o["x"], o["w"], o["s"])
    out = ops.styled_conv3x3_epilogue(acc, o["d"], o["noise"], o["noise_w"], o["bias"])
    torch.testing.assert_close(acc, ops.styled_conv3x3_partial_plain(o["x"], o["w"], o["s"]))
    torch.testing.assert_close(out, ops.styled_conv3x3_epilogue_plain(
        acc, o["d"], o["noise"], o["noise_w"], o["bias"]))
    assert ops.split_launch_counts() == {"styled_conv3x3_partial": 0,
                                         "styled_conv3x3_epilogue": 0}


# ---------------------------------------------------------------------------
# the layout and the step
# ---------------------------------------------------------------------------


def test_tp_specs_shard_the_tensors_jax_shards_on_the_same_axes(jax_tp):
    """Each up-conv's weight on Cout with its bias, each partner conv's
    weight on Cin, everything else replicated: JAX's stylegan2_tp_specs,
    its weight [k, k, Cin, Cout] against the port's [1, Cout, Cin, k, k]."""
    g = world()[0][0]
    specs = M.stylegan2_tp_specs(g)
    assert set(specs) == {n for n, _ in g.named_parameters()}
    jspecs = jax_tp["g_specs"]
    sharded = {}
    for i, conv in enumerate(jspecs["convs"]):
        wspec = tuple(conv["conv"]["w"])
        jaxis = next(a for a, s in enumerate(wspec) if s == "model")
        sharded[f"convs.{i}.conv.weight"] = {3: M.COUT, 2: M.CIN}[jaxis]
        if tuple(conv.get("act_b", ())) == ("model",):
            sharded[f"convs.{i}.activate.bias"] = 0
    assert {k: v for k, v in specs.items() if v is not None} == sharded
    for key in ("style", "conv1", "to_rgb1", "to_rgbs", "noises"):
        leaves = __import__("jax").tree_util.tree_leaves(
            jspecs[key], is_leaf=lambda s: type(s).__name__ == "PartitionSpec")
        assert all(tuple(s) == () for s in leaves), key
    ed = _editor(world()[0])
    sh = M.frozen_tp_shardings(M.make_mesh_2d(1, 1), ed.frozen_params())
    assert sh.specs["g"] == specs and sh.specs["reg"] is None and sh.specs["d"] is None


def _model_rank(n, index):
    """A (1 x n) data x model mesh as its model rank ``index`` sees it (no
    groups: shard_generator reads the shape and coordinates)."""
    return M.Mesh(("data", "model"), {"data": 1, "model": n}, {"data": 0, "model": index},
                  {"data": None, "model": None}, {"data": [index], "model": list(range(n))},
                  index, "gloo")


@pytest.mark.parametrize("index", (0, 1))
def test_shard_generator_keeps_this_ranks_slices_and_runs_only_under_its_plan(index):
    """On model rank ``index`` of 2, each tensor the specs shard holds its
    half on the spec's axis and nothing else changes; the convs carry their
    roles from the specs; a second call with the same layout changes
    nothing, another layout is refused; the sharded G refuses to run
    without its tp plan."""
    g = world()[0][0]
    whole = {k: p.detach().clone() for k, p in g.named_parameters()}
    specs = M.stylegan2_tp_specs(g)
    mesh = _model_rank(2, index)
    assert TP.shard_generator(g, specs, mesh) is g
    got = dict(g.named_parameters())
    assert got.keys() == whole.keys()
    for k, dim in specs.items():
        want = whole[k]
        if dim is not None:
            n = want.shape[dim] // 2
            want = want.narrow(dim, index * n, n)
        assert torch.equal(got[k], want), k
    for i, c in enumerate(g.convs):
        role, dim = ("column", M.COUT) if i % 2 == 0 else ("row", M.CIN)
        n = whole[f"convs.{i}.conv.weight"].shape[dim]
        assert c.tp_shard == TP.Shard(role, index * n // 2, (index + 1) * n // 2, n), i
    assert g.conv1.tp_shard is None
    TP.shard_generator(g, specs, mesh)
    assert all(torch.equal(p, got[k]) for k, p in g.named_parameters())
    with pytest.raises(ValueError, match="another layout's shard"):
        TP.shard_generator(g, specs, _model_rank(2, 1 - index))
    lat = torch.zeros(1, g.n_latent, STYLE_DIM)
    with pytest.raises(RuntimeError, match="tp plan"):
        g.synthesize(lat)


def test_frozen_tp_shardings_need_a_model_axis_and_the_steps_mesh():
    ed = _editor(world()[0])
    with pytest.raises(ValueError, match="'model' mesh axis"):
        M.frozen_tp_shardings(M.make_mesh(1), ed.frozen_params())
    sh = M.frozen_tp_shardings(M.make_mesh_2d(1, 1), ed.frozen_params())
    with pytest.raises(ValueError, match="another mesh"):
        T.make_train_step(ed, get_task("face"), None, mesh=M.make_mesh_2d(1, 1),
                          frozen_shardings=sh)


def test_tp_on_one_rank_is_the_plain_step(single):
    """A 1x1 (data x model) mesh has no group: the tp forward slices
    nothing, and the step equals the plain one bit for bit."""
    towers, walk0, z, sampled = world()
    mesh = M.make_mesh_2d(1, 1)
    ed = _editor(towers)
    w = {"w": torch.from_numpy(walk0.copy()).requires_grad_()}
    step = T.make_train_step(ed, get_task("face"), T.make_optimizer(w, LR), host_alpha=True,
                             mesh=mesh, frozen_shardings=M.frozen_tp_shardings(
                                 mesh, ed.frozen_params()))
    n = torch.get_num_threads()
    try:
        torch.set_num_threads(1)  # as the single-process reference ran
        m = step(w, z, generator=torch.Generator().manual_seed(3), sampled=sampled)
    finally:
        torch.set_num_threads(n)
    assert hooks.tp_plan() is None  # restored after the step
    terms, grad, _ = single["step"]
    assert {k: float(m[k]) for k in TERMS} == terms
    np.testing.assert_array_equal(_np(w["w"].grad), grad)


def tp_generator(n_model):
    """G alone in f64 on a (1 x n_model) tp mesh (n_model 0: one process):
    the image and the gradient of a fixed projection of it wrt W+."""
    torch.set_num_threads(1)
    g = world()[0][0].double()
    gen = torch.Generator().manual_seed(1)
    lat = torch.randn(2, g.n_latent, STYLE_DIM, dtype=torch.float64,
                      generator=gen).requires_grad_()
    c = torch.randn(2, SIZE, SIZE, 3, dtype=torch.float64, generator=gen)
    ctx = contextlib.nullcontext()
    if n_model:
        mesh = M.make_mesh_2d(1, n_model)
        TP.shard_generator(g, M.stylegan2_tp_specs(g), mesh)
        ctx = TP.tensor_parallel(mesh)
    with ctx:
        img = g.synthesize(lat, dtype=torch.float64)
    (img.double() * c).sum().backward()
    return img.detach().double().numpy(), lat.grad.numpy()


@pytest.mark.parametrize("n", (2, 4))
def test_tp_generator_equals_one_process_in_f64(n, ranks):
    img, grad = tp_generator(0)
    got_img, got_grad = ranks(n)["generator_f64"]
    np.testing.assert_allclose(got_img, img, rtol=1e-12, atol=1e-12)
    assert rel_l2(got_grad, grad) < 1e-12


@pytest.mark.parametrize("shape", TP_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tp_step_on_a_mesh_equals_one_process(shape, ranks, single):
    """Loss terms within 1e-6 of one process's; the walk gradient within
    1e-5 relative L2 of the f64 step (the module docstring says why not of
    one process's f32 gradient); the walk after Adam at test_engine.py's
    gates (the stored noise; fresh noise drawn at the global shape)."""
    got = ranks(shape[0] * shape[1])[shape]
    for name in ("step", "step_fresh"):
        terms, grad, after = got[name]
        want_terms, want_grad, want_after = single[name]
        for k in TERMS:
            np.testing.assert_allclose(terms[k], want_terms[k], rtol=1e-6, atol=1e-7,
                                       err_msg=(name, k))
        np.testing.assert_allclose(after, want_after, rtol=1e-4, atol=1e-6)
        assert rel_l2(grad, want_grad) < 3e-5, (name, rel_l2(grad, want_grad))
    grad = got["step"][1].ravel().astype(np.float64)
    assert rel_l2(grad, single["grad_f64"]) < 1e-5, rel_l2(grad, single["grad_f64"])


def test_tp_step_in_bf16_equals_one_process(ranks, single):
    """--bf16 under tp: the partial sums all-reduce in f32 and the epilogue
    rounds once. The 1x2 step's loss terms lie within one bf16 rounding
    (2^-8 relative) of the one-process bf16 step's; its walk gradient within
    1.5 x the one-process bf16 gradient's distance from the f64 step."""
    terms, grad, _ = ranks(2)[(1, 2)]["step_bf16"]
    want_terms, want_grad, _ = single["step_bf16"]
    for k in TERMS:
        np.testing.assert_allclose(terms[k], want_terms[k], rtol=2.0 ** -8, err_msg=k)
    limit = 1.5 * rel_l2(want_grad.ravel().astype(np.float64), single["grad_f64"])
    assert rel_l2(grad.ravel().astype(np.float64), single["grad_f64"]) <= limit


@pytest.mark.parametrize("shape", TP_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tp_step_on_a_mesh_matches_the_jax_tp_step(shape, ranks, jax_tp):
    """tests/test_engine.py's gates: loss rtol 2e-4; the walk after Adam
    rtol 1e-4, atol 1e-6."""
    terms, _, after = ranks(shape[0] * shape[1])[shape]["step"]
    for k in TERMS:
        np.testing.assert_allclose(terms[k], jax_tp["terms"][k], rtol=2e-4, err_msg=k)
    np.testing.assert_allclose(after, jax_tp["after"], rtol=1e-4, atol=1e-6)


def tp_copy_reduce(n):
    """copy_to_model and reduce_from_model on a (1 x n) mesh in f64: a
    column then row linear pair, sharded, against the whole product ->
    (output, input gradient) on every rank."""
    torch.set_num_threads(1)
    mesh = M.make_mesh_2d(1, n)
    plan = TP.TpPlan(mesh)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(3, 8, dtype=torch.float64, generator=gen).requires_grad_()
    a = torch.randn(8, 12, dtype=torch.float64, generator=gen)
    b = torch.randn(12, 5, dtype=torch.float64, generator=gen)
    lo, hi = plan.channels(12)
    (y,) = plan.reduce(plan.copy(x) @ a[:, lo:hi] @ b[lo:hi])
    y.square().sum().backward()
    return y.detach().numpy(), x.grad.numpy(), plan.reduced_bytes


@pytest.mark.parametrize("n", (2, 4))
def test_copy_and_reduce_give_the_whole_product_and_gradient(n, ranks):
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(3, 8, dtype=torch.float64, generator=gen).requires_grad_()
    a = torch.randn(8, 12, dtype=torch.float64, generator=gen)
    b = torch.randn(12, 5, dtype=torch.float64, generator=gen)
    y = x @ a @ b
    y.square().sum().backward()
    for out, gx, nbytes in ranks(n)["copy_reduce"]:
        np.testing.assert_allclose(out, y.detach().numpy(), rtol=1e-12)
        np.testing.assert_allclose(gx, x.grad.numpy(), rtol=1e-12)
        assert nbytes == 3 * 5 * 8
