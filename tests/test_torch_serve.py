"""The port's serving CLI (latent2im_tpu_torch/cli/serve.py) on the CPU,
mirroring tests/test_serve.py: the real ThreadingHTTPServer on an ephemeral
port over a tiny editor — health check, /edit pad-and-slice, /sweep,
micro-batching, and the 400 paths. The stdlib PNG encoder is checked by
decoding its output with Pillow."""

import base64
import io
import json
import os
import threading
import urllib.request

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from latent2im_tpu_torch.cli.serve import build_service, make_server
    from latent2im_tpu_torch.config.options import TrainOptions, VisOptions

    tmp_path = tmp_path_factory.mktemp("serve")
    topt = TrainOptions().parse(
        [
            "--model", "stylegan_v2_real", "--transform", "face",
            "--walk_type", "linear", "--attrList", "Smiling",
            "--attrPath", os.path.join(REPO, "dataset", "attributes_celeba.txt"),
            "--models_dir", str(tmp_path / "models"), "--overwrite_config",
            "--dev_tiny", "--resolution", "32",
        ],
        print_opt=True,
    )
    vo = VisOptions()
    vo.parser.add_argument("--serve_batch", type=int, default=2)
    opt, conf = vo.parse([os.path.join(topt.output_dir, "opt.yml"),
                          "--serve_batch", "2", "--num_panels", "3"])
    service = build_service(opt, conf, device="cpu")
    service.warmup()
    srv = make_server(service, "127.0.0.1", 0)  # ephemeral port
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", service
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)


def _post(url, path, obj):
    req = urllib.request.Request(
        url + path, data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _decode(b64):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def test_healthz(server):
    url, service = server
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        data = json.loads(r.read())
    assert data["status"] == "ok"
    assert data["serve_batch"] == 2
    assert data["attr_list"] == ["Smiling"]
    assert data["device"] == "cpu"


def test_edit_roundtrip_pads_and_slices(server):
    url, service = server
    z = np.random.RandomState(0).randn(1, service.dim_z).tolist()  # < batch
    calls = service.device_calls
    code, out = _post(url, "/edit", {"z": z, "alpha": 0.8})
    assert code == 200, out
    assert service.device_calls == calls + 1
    assert len(out["images"]) == 1  # sliced back to the request batch
    assert _decode(out["images"][0]).shape == (32, 32, 3)
    assert len(out["alpha_org"]) == 1
    # the padded row does not change the real row's answer
    code, out2 = _post(url, "/edit", {"z": z * 2, "alpha": 0.8})
    assert code == 200
    assert out2["images"][0] == out["images"][0]


def test_edit_matches_editor_u8(server):
    """The served PNG decodes to exactly the editor's uint8 image."""
    url, service = server
    z = np.random.RandomState(5).randn(2, service.dim_z).astype(np.float32)
    code, out = _post(url, "/edit", {"z": z.tolist(), "alpha": [0.1, 0.9]})
    assert code == 200, out
    want, _, _ = service.ed.apply_alpha(service.walk, z,
                                        np.asarray([0.1, 0.9], np.float32), u8=True)
    for i in range(2):
        np.testing.assert_array_equal(_decode(out["images"][i]), want[i].numpy())


def test_sweep_roundtrip(server):
    url, service = server
    code, out = _post(url, "/sweep", {"seed": 3, "num_samples": 2})
    assert code == 200, out
    assert len(out["panels"]) == 3  # num_panels
    assert len(out["panels"][0]) == 2
    assert _decode(out["panels"][2][1]).shape == (32, 32, 3)
    assert len(out["alphas"]) == 3
    code, out = _post(url, "/sweep", {"seed": 3, "num_panels": 4})
    assert code == 400 and "num_panels" in out["error"]


def test_micro_batching_coalesces_concurrent_edits(server):
    """K concurrent single-sample /edit requests coalesce into fewer device
    calls than requests."""
    url, service = server
    service.enable_batching(window_ms=150.0)  # wide window: test determinism
    try:
        calls_before = service.device_calls
        results = [None] * 4
        errs = []

        def one(i):
            try:
                z = np.random.RandomState(100 + i).randn(1, service.dim_z).tolist()
                results[i] = _post(url, "/edit", {"z": z, "alpha": 0.5})
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        ts = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
        assert not errs
        for code, out in results:
            assert code == 200, out
            assert _decode(out["images"][0]).shape == (32, 32, 3)
        launches = service.device_calls - calls_before
        assert launches < 4, f"no coalescing: {launches} launches"
        imgs = [np.asarray(_decode(out["images"][0]), int) for _, out in results]
        assert any(np.abs(imgs[0] - im).max() > 0 for im in imgs[1:])
    finally:
        service.batcher = None  # later tests use the direct path


def test_oversized_batch_is_400(server):
    url, service = server
    z = np.zeros((5, service.dim_z)).tolist()
    code, out = _post(url, "/edit", {"z": z, "alpha": 0.5})
    assert code == 400
    assert "serve_batch" in out["error"]


def test_bad_z_dim_is_400(server):
    url, service = server
    code, out = _post(url, "/edit", {"z": [[0.0] * 7], "alpha": 0.5})
    assert code == 400
    assert "dim" in out["error"]


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 9)])
def test_png_encoder_roundtrips(shape):
    from PIL import Image

    from latent2im_tpu_torch.utils.image import png_bytes

    img = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    got = np.asarray(Image.open(io.BytesIO(png_bytes(img))))
    np.testing.assert_array_equal(got, img)
