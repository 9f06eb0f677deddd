"""The port's counterpart of the JAX package's native extension
(latent2im_tpu_torch/native/ against latent2im_tpu/native over
native/l2i_native.cpp, libjpeg-turbo 2.1 and libpng 1.6), on the CPU, bit
for bit:

- the epoch order: libstdc++'s ``std::shuffle`` by ``std::mt19937_64``
  against the extension's Loader, for several numbers of files, batch
  sizes and epochs 0-3;
- ``load_resize`` of each photo kind (PNG with alpha, palette tRNS, 16
  bits, gAMA, sRGB, sBIT; baseline, progressive, gray, arithmetic, cut and
  CMYK JPEG; WEBP, GIF and BMP, which fail there) at sizes below, at and
  above its crop, in Python and through the host C++ (built here by the
  host's compiler, tests/test_torch_loader.py:host_library), the black
  image of the Loader and the IOError of ``load_resize``;
- the callers with both packages' native paths present:
  ``cli/train.py:_make_real_batcher`` over two epoch boundaries with ragged
  tails, also after a replay of the stream (load=False), and the regressor
  trainer's training-split batches; ``utils/image.py:load_and_resize_image``;
- tests/fixtures/torch_native/native.json, what the card's phase 54 holds
  the port to, still what the extension makes (its recorder:
  tests/fixtures/torch_native/gen_native.py).
"""

import glob
import hashlib
import json
import os
import re
import shutil
import sys

import numpy as np
import pytest

jn = pytest.importorskip("latent2im_tpu.native")
from latent2im_tpu.cli import train as jcli  # noqa: E402
from latent2im_tpu.cli import train_regressor as jtr  # noqa: E402
from latent2im_tpu_torch.cli import train as tcli  # noqa: E402
from latent2im_tpu_torch.cli import train_regressor as tr  # noqa: E402
from latent2im_tpu_torch.native import _l2i_native as tn  # noqa: E402
from latent2im_tpu_torch.native import order  # noqa: E402
from latent2im_tpu_torch.ops import _build  # noqa: E402
from latent2im_tpu_torch.utils import image as im  # noqa: E402
from test_torch_loader import host_library, native  # noqa: E402,F401 (the C++ twin)

JN = jn._l2i_native
HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
RECORD = os.path.join(FIX, "torch_native", "native.json")
with open(RECORD) as _f:
    REC = json.load(_f)


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a, np.uint8).tobytes()).hexdigest()


def _jax(path, size):
    try:
        return JN.load_resize(path, size)
    except OSError:
        return None


def _port(path, size, host_cpp=False):
    try:
        return tn.load_resize(path, size, host_cpp=host_cpp)
    except OSError:
        return None


def _jax_orders(n, b, epochs=4):
    loader = JN.Loader([os.path.join(HERE, "missing")] * n, 1, b, threads=1)
    out = []
    for e in range(epochs):
        loader.start_epoch(seed=e, shuffle=True)
        lists = []
        while True:
            try:
                lists.append(loader.next_batch()[1])
            except StopIteration:
                break
        out.append(lists)
    return out


@pytest.mark.parametrize("n,b", [(1, 1), (2, 1), (2, 2), (5, 2), (5, 4), (37, 3), (37, 32),
                                 (1000, 7), (1000, 32)])
def test_the_epoch_order_is_the_extensions(n, b):
    want = _jax_orders(n, b)
    loader = tn.Loader([os.path.join(HERE, "missing")] * n, 1, b, threads=1, host_cpp=False)
    with loader:
        for e in range(4):
            loader.start_epoch(seed=e, shuffle=True)
            got = []
            while True:
                try:
                    got.append(loader.skip_batch())
                except StopIteration:
                    break
            assert got == want[e], (n, b, e)
    assert loader.num_batches() == -(-n // b)


def test_mt19937_64_is_the_standards():
    g = order.MT19937_64(5489)
    for _ in range(9999):
        g()
    assert g() == 9981545732273789042  # the C++ standard's 10000th draw


def _photos():
    return sorted(p for p in glob.glob(os.path.join(FIX, "*", "*.*"))
                  if p.endswith((".png", ".jpg", ".webp", ".gif", ".bmp", ".tif"))
                  and "1024" not in p)


@pytest.mark.parametrize("route", ["python", "host_cpp"])
def test_load_resize_is_the_extensions_on_every_fixture(route, native):  # noqa: F811
    failed = 0
    for path in _photos():
        with open(path, "rb") as f:
            h = min(_pil_size(f.read()))
        for size in sorted({7, max(1, h // 2), h, h + 9}):
            want, got = _jax(path, size), _port(path, size, route == "host_cpp")
            if want is None or got is None:
                assert want is None and got is None, (path, size)
                failed += 1
                continue
            np.testing.assert_array_equal(got, want, err_msg=f"{path} at {size}")
    assert failed > 0  # WEBP, GIF, BMP, TIFF and CMYK fail on this path


def _pil_size(data):
    import io

    import PIL.Image

    return PIL.Image.open(io.BytesIO(data)).size


@pytest.mark.parametrize("kind", ["baseline", "progressive"])
def test_cut_jpegs_decode_as_libjpeg_fills_them(kind, tmp_path, native):  # noqa: F811
    data = open(os.path.join(FIX, "torch_jpeg_progressive" if kind == "progressive"
                             else "torch_jpeg", "prog_256_420.jpg" if kind == "progressive"
                             else "photo_256_422.jpg"), "rb").read()
    for cut in np.linspace(3, len(data) - 1, 9).astype(int):
        path = tmp_path / f"cut{cut}.jpg"
        path.write_bytes(data[:cut])
        want = _jax(str(path), 64)
        for host_cpp in (False, True):
            got = _port(str(path), 64, host_cpp)
            if want is None:
                assert got is None, cut
            else:
                np.testing.assert_array_equal(got, want, err_msg=str(cut))


def test_unreadable_files_are_black_in_the_loader_and_raise_in_load_resize(tmp_path):
    good = os.path.join(FIX, "torch_native", "rgba_40x32.png")
    paths = [good, str(tmp_path / "missing.png"), os.path.join(
        FIX, "torch_image_kinds", "gif_quantized_trns_64x48.gif"), good]
    with tn.Loader(paths, 16, 4, host_cpp=False) as loader:
        loader.start_epoch(seed=0, shuffle=False)
        batch, idx = loader.next_batch()
    assert idx == [0, 1, 2, 3]
    assert not batch[1].any() and not batch[2].any() and batch[0].any()
    jl = JN.Loader(paths, 16, 4, threads=2)
    jl.start_epoch(seed=0, shuffle=False)
    raw, _ = jl.next_batch()
    np.testing.assert_array_equal(batch, np.frombuffer(raw, np.uint8).reshape(4, 16, 16, 3))
    for bad in paths[1:3]:
        with pytest.raises(OSError, match="failed to load/decode"):
            JN.load_resize(bad, 16)
        with pytest.raises(OSError, match="failed to load/decode .*" + re.escape(
                os.path.basename(bad))):
            tn.load_resize(bad, 16, host_cpp=False)


def test_a_failed_build_raises_on_the_native_path(monkeypatch):
    def refused():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "library", refused)
    path = os.path.join(FIX, "torch_jpeg", "photo_256_422.jpg")
    assert tn.load_resize(path, 32, host_cpp=False).shape == (32, 32, 3)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tn.load_resize(path, 32, host_cpp=True)
    with tn.Loader([path], 32, 1, host_cpp=True) as loader:
        loader.start_epoch()
        with pytest.raises(RuntimeError, match="nvcc not found"):
            loader.next_batch()


def test_imgrid_is_the_extensions():
    rng = np.random.RandomState(3)
    for n, cols, pad in ((5, 3, 1), (1, 4, 2), (6, 2, 0)):
        a = rng.randint(0, 256, (n, 7, 5, 3)).astype(np.uint8)
        np.testing.assert_array_equal(tn.imgrid(a, cols, pad), JN.imgrid(a, cols, pad))


def _gan_dir(tmp_path):
    d = tmp_path / "real"
    d.mkdir()
    for name, rel in REC["gan_stream"]["files"].items():
        shutil.copy(os.path.join(FIX, rel), d / name)
    return sorted(str(p) for p in d.iterdir())


@pytest.mark.parametrize("replay", [0, 1, 3])
def test_real_batches_are_the_extensions_stream(tmp_path, replay):
    """_make_real_batcher at 32 px, B=4, on six files: past two epoch
    boundaries with ragged tails, after ``replay`` batches replayed."""
    paths = _gan_dir(tmp_path)
    want = jcli._make_real_batcher(paths, 32, 4)
    wanted = [want() for _ in range(replay + 4)]
    got = tcli._make_real_batcher(paths, 32, 4)
    try:
        for _ in range(replay):
            assert got(load=False) is None
        for k in range(4):
            np.testing.assert_array_equal(got(), wanted[replay + k])
        with pytest.raises(RuntimeError, match="replays only before"):
            got(load=False)
    finally:
        got.loader.close()


def test_load_and_resize_image_takes_the_native_path():
    for rel in ("torch_native/palette_trns_37x31.png", "torch_jpeg/photo_218x178_420.jpg"):
        path = os.path.join(FIX, rel)
        np.testing.assert_array_equal(im.load_and_resize_image(path, 40),
                                      JN.load_resize(path, 40))


def test_the_regressor_trains_on_the_extensions_batches(tmp_path):
    """The training split through the native Loader (epochs 0, 1) as the JAX
    trainer takes it, the test split through Pillow, and the trainer's
    print line."""
    rec = REC["regressor"]
    root = tmp_path / "reg"
    for key, rel in rec["files"].items():
        (root / os.path.dirname(key)).mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(FIX, rel), root / key)
    split = {}
    for part, keys in rec["split"].items():
        (tmp_path / f"{part}.txt").write_text("\n".join(keys) + "\n")
        split[part] = tr.list_split(str(root), str(tmp_path / f"{part}.txt"))
        assert split[part] == jtr.list_split(str(root), str(tmp_path / f"{part}.txt"))
    train = [p for p, _ in split["training"]]
    jl, ok = jtr._make_loader(train, 32, 2)
    loader, native_ = tr.make_native_loader(train, 32, 2)
    assert ok and native_
    try:
        for epoch in range(2):
            jl.start_epoch(seed=epoch, shuffle=True)
            loader.start_epoch(seed=epoch, shuffle=True)
            got = list(tr.native_batches(loader))
            want = []
            while True:
                try:
                    raw, idx = jl.next_batch()
                except StopIteration:
                    break
                want.append((np.frombuffer(raw, np.uint8).reshape(len(idx), 32, 32, 3), idx))
            assert [i for _, i in got] == [i for _, i in want]
            for (g, _), (w, _) in zip(got, want):
                np.testing.assert_array_equal(g, w)
    finally:
        loader.close()
    test = [p for p, _ in split["test"]]
    want = list(jtr._pil_batches(test, 32, 2, np.arange(len(test))))
    with tr.make_loader(test, 32, host_cpp=False) as pool:
        got = list(pool.batches(tr.index_batches(np.arange(len(test)), 2)))
    for (g, gi), (w, wi) in zip(got, want):
        assert list(gi) == list(wi)
        np.testing.assert_array_equal(g, w)


def test_the_recorded_fixtures_are_still_the_extensions(tmp_path):
    """native.json (what the card holds the port to) against the extension
    here and the port's Python path."""
    for rel, sizes in REC["load_resize"].items():
        path = os.path.join(FIX, rel)
        for size, want in sizes.items():
            got = _jax(path, int(size))
            assert (want == "fail") == (got is None) and (got is None or _sha(got) == want), rel
            if "1024" not in rel:
                port = _port(path, int(size))
                assert (want == "fail") == (port is None), rel
                assert port is None or _sha(port) == want, (rel, size)
    for key, epochs in REC["orders"].items():
        n, b = map(int, key.split("_"))
        assert _jax_orders(n, b) == epochs
        o = list(range(n))
        for e in range(4):
            order.std_shuffle(o, e)
            assert [o[s:s + b] for s in range(0, n, b)] == epochs[e]
    paths = _gan_dir(tmp_path)
    nxt = tcli._make_real_batcher(paths, REC["gan_stream"]["size"], REC["gan_stream"]["batch"])
    try:
        assert [_sha(nxt()) for _ in REC["gan_stream"]["sha256"]] == REC["gan_stream"]["sha256"]
    finally:
        nxt.loader.close()


def test_the_fallback_stays_reachable(monkeypatch):
    """Hiding the port's module reaches each caller's fallback, as hiding
    the extension does in the JAX package."""
    monkeypatch.setitem(sys.modules, "latent2im_tpu_torch.native", None)
    monkeypatch.setitem(sys.modules, "latent2im_tpu.native", None)
    path = os.path.join(FIX, "torch_jpeg", "photo_218x178_420.jpg")
    from latent2im_tpu.utils import image as jim

    np.testing.assert_array_equal(im.load_and_resize_image(path, 40),
                                  jim.load_and_resize_image(path, 40))
    assert tr.make_native_loader([path], 40, 1) == (None, False)
