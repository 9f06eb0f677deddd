"""The port's process mesh and launcher (latent2im_tpu_torch/parallel/mesh.py,
launch.py, dryrun.py) on the CPU: the mesh's errors and batch helpers in one
process (a mesh of one rank needs no process group), the backend choice,
and on launched gloo ranks (a FileStore rendezvous, a time limit on every
launch) the grid's groups, ``replicate``, the collectives, the launcher's
failure path and the dry run. The launched functions live in this module,
which imports no JAX."""

from __future__ import annotations

import argparse
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from latent2im_tpu_torch.models import hooks
from latent2im_tpu_torch.parallel import launch as L
from latent2im_tpu_torch.parallel import mesh as M
from latent2im_tpu_torch.parallel import spatial as S

TIMEOUT = 120.0


def test_backend_is_nccl_only_with_a_card_per_rank():
    assert M.choose_backend("cuda", 1, 1) == "nccl"
    assert M.choose_backend("cuda", 4, 4) == "nccl"
    assert M.choose_backend("cuda", 2, 1) == "gloo"  # ranks share a card
    assert M.choose_backend("cpu", 4, 0) == "gloo"


def test_meshes_of_one_process_and_their_errors():
    """The JAX package's errors where too few ranks exist."""
    assert not dist.is_initialized() and M.init_distributed(device_type="cpu") == 0
    m = M.make_mesh()
    assert m.shape == {"data": 1} and m.is_main and m.transport == "local"
    m2 = M.make_mesh_2d(1, 1, ("data", "spatial"))
    assert m2.shape == {"data": 1, "spatial": 1} and m2.coords == {"data": 0, "spatial": 0}
    with pytest.raises(ValueError, match=r"\(data x model\) mesh wants 2x1 = 2 devices, have 1"):
        M.make_mesh_2d(2, 1)
    with pytest.raises(ValueError, match=r"\(data\) mesh wants 2 devices, have 1"):
        M.make_mesh(2)
    with pytest.raises(ValueError, match="wants >= 2 devices on the 'spatial' axis, got 1"):
        S.make_mesh_spatial(1)
    with pytest.raises(ValueError, match=r"\(data x spatial\) mesh wants 1x2 = 2 devices"):
        S.make_mesh_spatial(2)


def _mesh(n_data, rank):
    """A mesh object as rank ``rank`` of a (n_data,) grid sees it (no
    groups: for the batch helpers, which read the shape and coordinates)."""
    return M.Mesh(("data",), {"data": n_data}, {"data": rank}, {"data": None},
                  {"data": list(range(n_data))}, rank, "gloo")


def test_shard_batch_slices_pads_and_refuses_as_the_jax_package():
    batch = np.arange(10, dtype=np.float32).reshape(5, 2)
    with pytest.raises(ValueError, match="batch of 5 does not divide the 2-device mesh"):
        M.shard_batch(_mesh(2, 0), batch)
    assert M.pad_to_devices(5, 2) == 6 and M.pad_to_devices(4, 2) == 4
    lo = M.shard_batch(_mesh(2, 0), batch, pad=True)
    hi = M.shard_batch(_mesh(2, 1), batch, pad=True)
    np.testing.assert_array_equal(np.concatenate([lo, hi]), batch[[0, 1, 2, 3, 4, 4]])
    t = torch.arange(12.0).reshape(2, 6)  # axis 1, a tensor
    got = M.shard_batch(_mesh(3, 2), t, axis=1)
    assert isinstance(got, torch.Tensor) and torch.equal(got, t[:, 4:6])


def test_tensor_parallelism_and_unported_rows_name_item_15():
    """What item 15 held runs now: tp (JAX frozen_tp_shardings /
    make_train_step(frozen_shardings=), tests/test_torch_tp.py), and the
    rows of PGGAN, StyleGAN1 and the GAN zoo under a row plan
    (tests/test_torch_sp_families.py). A one-rank plan computes what no plan
    does."""
    from latent2im_tpu_torch.models import pggan, stylegan2

    mesh = M.make_mesh_2d(1, 1)
    g = stylegan2.Generator(8, 8, 1, channels={4: 4, 8: 4},
                            generator=torch.Generator().manual_seed(0))
    sh = M.frozen_tp_shardings(mesh, {"g": g, "reg": None})
    assert sh.mesh is mesh and sh.specs["reg"] is None
    assert sh.specs["g"]["convs.0.conv.weight"] == M.COUT
    assert sh.specs["g"]["convs.1.conv.weight"] == M.CIN
    pg = pggan.Generator(n_label=0, generator=torch.Generator().manual_seed(0))
    z = torch.randn(1, 512, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = pg(z, step=1)
        with S.spatial_partitioning(M.make_mesh_2d(1, 1, ("data", "spatial")),
                                    min_rows_per_device=2):
            got = pg(z, step=1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_spatial_partitioning_restores_the_plan_and_bumps_the_token():
    mesh = M.make_mesh_2d(1, 1, ("data", "spatial"))
    sp = S.spatial_partitioning(mesh, min_rows_per_device=2)
    t0 = hooks.spatial_token()
    with sp:
        assert hooks.row_plan() is sp.plan
        with S.spatial_partitioning(mesh) as inner:
            assert hooks.row_plan() is inner.plan
        assert hooks.row_plan() is sp.plan
    with sp:  # reusable
        assert hooks.row_plan() is sp.plan
    assert hooks.row_plan() is None and hooks.spatial_token() == t0 + 6


def collectives(n_data, n_sp):
    """On a launched (n_data x n_sp) grid: each rank's coordinates and
    groups, replicate, the neighbour exchange and the gathers."""
    torch.set_num_threads(1)
    mesh = S.make_mesh_spatial(n_sp, n_data)
    r = mesh.rank
    walk = {"w": torch.full((2, 3), float(r)), "b": [torch.full((1,), 10.0 + r)]}
    M.replicate(mesh, walk)
    t = torch.full((1, 1, 2, 1), float(r))
    from_prev, from_next = M.exchange(mesh, "spatial", t, t + 100)
    rows = M.all_gather(mesh, "spatial", t, 1)
    data = M.all_gather(mesh, "data", t, 0)
    return {"rank": r, "coords": mesh.coords, "members": mesh.members,
            "walk": (walk["w"].tolist(), walk["b"][0].item()),
            "exchange": (from_prev.flatten().tolist(), from_next.flatten().tolist()),
            "rows": rows.flatten().tolist(), "data": data.flatten().tolist(),
            "sum": M.all_reduce(mesh, t).flatten()[0].item(), "any": M.any_rank(mesh, r == 3),
            "transport": mesh.transport}


def gather_all(n_data, n_sp):
    out = collectives(n_data, n_sp)
    objs = [None] * dist.get_world_size()
    dist.all_gather_object(objs, out)
    return objs


def test_grid_groups_replicate_and_collectives_on_launched_ranks():
    """Rank = data * n_spatial + spatial; every rank's view of a 2x2 grid."""
    outs = L.launch(gather_all, (2, 2), world_size=4, device="cpu", timeout=TIMEOUT)
    for o in outs:
        r = o["rank"]
        d, s = divmod(r, 2)
        assert o["coords"] == {"data": d, "spatial": s}
        assert o["members"] == {"data": [s, 2 + s], "spatial": [2 * d, 2 * d + 1]}
        assert o["walk"] == ([[0.0] * 3] * 2, 10.0)  # rank 0's
        # spatial neighbour swap: zeros past the grid's edges
        prev = [float(r - 1) + 100] * 2 if s == 1 else [0.0, 0.0]
        nxt = [float(r + 1)] * 2 if s == 0 else [0.0, 0.0]
        assert o["exchange"] == (prev, nxt)
        assert o["rows"] == [float(2 * d)] * 2 + [float(2 * d + 1)] * 2
        assert o["data"] == [float(s)] * 2 + [float(2 + s)] * 2
        assert o["sum"] == 6.0 and o["any"] is True
        assert o["transport"].startswith("gloo")


def failing(fail_rank):
    torch.set_num_threads(1)
    if dist.get_rank() == fail_rank:
        raise ValueError(f"rank {fail_rank} fails on purpose")
    dist.barrier()  # the others wait for it, as ranks in a collective do
    time.sleep(60)


def test_a_failing_rank_fails_the_launch_and_stops_the_others():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed:(.|\n)*fails on purpose"):
        L.launch(failing, (1,), world_size=3, device="cpu", timeout=TIMEOUT, grace=10.0)
    assert time.monotonic() - t0 < 40


def sleeping():
    time.sleep(60)
    return 1


def test_a_launch_past_its_time_limit_fails():
    with pytest.raises(RuntimeError, match="did not finish within 1 s"):
        L.launch(sleeping, world_size=2, device="cpu", timeout=1.0, grace=5.0)


def test_launch_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.launch(sleeping, world_size=2, device="cuda")


def test_dryrun_prints_the_jax_dry_run_lines(capsys):
    from latent2im_tpu_torch.parallel.dryrun import dryrun_multichip

    lines = dryrun_multichip(2, "cpu")
    assert lines[0].startswith("dryrun_multichip(2): one 2 dp step OK, loss=")
    assert lines[1].startswith("dryrun_multichip(2): one 1x2 dp+tp step OK, loss=")
    assert lines[2].startswith("dryrun_multichip(2): one 1x2 dp+sp step OK, loss=")
    assert capsys.readouterr().out.splitlines() == lines
