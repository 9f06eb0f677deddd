"""The port's image loading for the trainers on the CPU: the threaded loader
(latent2im_tpu_torch/utils/loader.py) and the host C++ of the decode and
resize (ops/csrc/jpeg_huffman.cpp, resample.cpp):

- the regressor trainer's batch stream (order and bytes) is the JAX
  trainer's pure-Python ``_pil_batches`` (its native extension hidden, as
  tests/test_torch_gan_io.py hides it) on tests/fixtures/torch_regressor/;
- the threaded loader yields exactly the sequential path's batches, in its
  order, for any thread count; a load that raises raises at its
  batch; a stress run with more threads than cores and a short switch
  interval keeps the order; ``--updateGAN``'s real batches replay only
  before the first load;
- the C entries, built by the test with the host's C++ compiler (on the
  card they build with nvcc, with the kernels), equal the Python and numpy
  versions bit for bit: the whole decode (``l2i_jpeg_decode``) on every
  fixture JPEG, on JPEGs Pillow writes in the test, on truncated and corrupted data (the same
  error, or the same image); its core ``l2i_jpeg_decode_interval`` against
  ``_decode_interval`` on random bit streams (the same packed outputs, DC
  sums, bits used, or the same failure); the resize for the three
  filters; a DC table with a size past 15 is a bad table in both;
- the CPU path never touches the library, and a failed build raises
  through ``host_cpp=True`` (no quiet switch to Python).
"""

import ctypes
import glob
import io
import os
import random
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import PIL.Image
import pytest

from latent2im_tpu.cli import train_regressor as jtr
from latent2im_tpu_torch.cli import train as tcli
from latent2im_tpu_torch.cli import train_regressor as tr
from latent2im_tpu_torch.ops import _build
from latent2im_tpu_torch.utils import image as im
from latent2im_tpu_torch.utils import jpeg
from latent2im_tpu_torch.utils.loader import MAX_THREADS, Loader, default_threads

HERE = os.path.dirname(os.path.abspath(__file__))
REGRESSOR = os.path.join(HERE, "fixtures", "torch_regressor")
JPEGS = sorted(glob.glob(os.path.join(HERE, "fixtures", "torch_jpeg", "*.jpg")))


@pytest.fixture
def jax_fallback(monkeypatch):
    """Both packages with their native paths hidden: Pillow batches."""
    monkeypatch.setitem(sys.modules, "latent2im_tpu.native", None)
    monkeypatch.setitem(sys.modules, "latent2im_tpu_torch.native", None)


def _train_paths():
    items = tr.list_split(os.path.join(REGRESSOR, "imgs"),
                          os.path.join(REGRESSOR, "split", "training.txt"))
    return [p for p, _ in items]


@pytest.mark.parametrize("size,batch", [(32, 4), (48, 3)])
def test_the_batch_stream_is_the_jax_trainers(jax_fallback, size, batch):
    paths = _train_paths()
    assert len(paths) == 7
    assert jtr._make_loader(paths, size, batch) == (None, False)  # the extension is hidden
    for epoch in (0, 1):
        order = np.random.RandomState(epoch).permutation(len(paths))
        with tr.make_loader(paths, size, host_cpp=False) as loader:
            got = list(loader.batches(tr.index_batches(order, batch)))
        want = list(jtr._pil_batches(paths, size, batch, order))
        assert len(got) == len(want) == -(-len(paths) // batch)
        for (g, gi), (w, wi) in zip(got, want):
            assert gi == wi and g.dtype == np.uint8 and np.array_equal(g, w)


def _load(i):
    return np.full((2, 3), i, np.int64) * np.arange(6).reshape(2, 3)


@pytest.mark.parametrize("threads", [1, 3, MAX_THREADS])
def test_the_threaded_loader_yields_the_sequential_batches(threads):
    idx = [list(range(s, min(s + 4, 23))) for s in range(0, 23, 4)]
    with Loader(_load, threads=threads) as loader:
        got = list(loader.batches(idx))
    assert [i for _, i in got] == idx
    for b, i in got:
        assert np.array_equal(b, np.stack([_load(j) for j in i]))
    assert 1 <= default_threads() <= MAX_THREADS


def test_a_failing_load_raises_at_its_batch_and_an_early_stop_cancels():
    def load(i):
        if i == 6:
            raise ValueError("bad image 6")
        return _load(i)

    with Loader(load, threads=2) as loader:
        it = loader.batches([[0, 1], [2, 3], [4, 5], [6, 7], [8, 9]])
        assert [next(it)[1] for _ in range(3)] == [[0, 1], [2, 3], [4, 5]]
        with pytest.raises(ValueError, match="bad image 6"):
            next(it)
        stopped = loader.batches([[0], [1], [2], [3]])
        assert next(stopped)[1] == [0]
        stopped.close()  # the consumer stops: the batches in flight are dropped
    assert loader._pool._shutdown


def test_order_holds_under_stress():
    """More threads than cores, a short switch interval, loads that take
    random times: every batch still in the sequential order, complete."""
    rng = random.Random(0)
    delays = [rng.uniform(0, 0.004) for _ in range(256)]

    def load(i):
        time.sleep(delays[i])
        return np.array([i, threading.get_ident() % 7])

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with Loader(load, threads=4 * (os.cpu_count() or 1)) as loader:
            idx = [list(range(s, s + 8)) for s in range(0, 256, 8)]
            got = list(loader.batches(idx))
    finally:
        sys.setswitchinterval(saved)
    assert [i for _, i in got] == idx
    assert all(np.array_equal(b[:, 0], i) for b, i in got)


def test_the_real_batches_replay_only_before_the_first_load(tmp_path):
    for i in range(3):
        (tmp_path / f"{i}.png").write_bytes(im.png_bytes(np.full((6, 6, 3), i, np.uint8)))
    paths = tcli._real_paths(str(tmp_path))
    nxt = tcli._make_real_batcher(paths, 4, 2)
    assert nxt(load=False) is None
    assert nxt().shape == (2, 4, 4, 3)
    with pytest.raises(RuntimeError, match="replays only before"):
        nxt(load=False)
    nxt.loader.close()


# ---------------------------------------------------------------------------
# the host C++ (built by the host's C++ compiler)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def host_library(tmp_path_factory):
    """ops/csrc/*.cpp built by the host's C++ compiler, with _build's
    signatures, standing in for the kernel library."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build ops/csrc/*.cpp with")
    out = str(tmp_path_factory.mktemp("host") / "libhost.so")
    srcs = sorted(glob.glob(os.path.join(_build.CSRC, "*.cpp")))
    subprocess.run([cxx, "-std=c++17", "-O2", "-fPIC", "-shared", "-o", out, *srcs],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(out)
    for name, argtypes in _build.SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = _build.RESTYPES.get(name, ctypes.c_int)
    return lib


@pytest.fixture
def native(monkeypatch, host_library):
    monkeypatch.setattr(_build, "library", lambda: host_library)


def _both(data):
    out = []
    for native in (False, True):
        try:
            out.append(jpeg.jpeg_decode_rgb(data, host_cpp=native))
        except ValueError as e:
            out.append(str(e))
    return out


def _same(data):
    want, got = _both(data)
    if isinstance(want, str) or isinstance(got, str):
        assert want == got
        return False
    assert want.shape == got.shape and np.array_equal(want, got)
    return True


def test_the_c_decode_is_the_python_decode_on_the_fixtures(native):
    assert len(JPEGS) == 5
    for path in JPEGS:
        with open(path, "rb") as f:
            assert _same(f.read()), path
        assert np.array_equal(im.read_image_rgb(path, host_cpp=True), im.read_image_rgb(path))


def _photo(h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    a = np.stack([127.5 + 120 * np.sin(xx / 7.0 + yy / 11.0 + c) for c in range(3)], -1)
    return np.clip(a + rng.randn(h, w, 3) * 8, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("h,w", [(1, 1), (2, 3), (17, 23), (33, 2), (64, 48)])
def test_the_c_decode_is_the_python_decode_on_pillow_jpegs(native, h, w):
    for seed, (ss, q, opts) in enumerate([(0, 95, {}), (1, 50, {}), (2, 75, {"optimize": True}),
                                          ("4:1:1", 90, {}), (2, 80, {"restart_marker_rows": 1}),
                                          (2, 80, {"restart_marker_blocks": 3})]):
        buf = io.BytesIO()
        PIL.Image.fromarray(_photo(h, w, seed)).save(buf, "JPEG", quality=q, subsampling=ss,
                                                     **opts)
        assert _same(buf.getvalue()), (ss, q, opts)
    buf = io.BytesIO()
    PIL.Image.fromarray(_photo(h, w, 9)).convert("L").save(buf, "JPEG")
    assert _same(buf.getvalue())


def test_the_c_decode_fails_as_the_python_decode_on_bad_data(native):
    rng = np.random.RandomState(3)
    kinds = {True: 0, False: 0}
    for name in ("restart_120x100_420", "photo_218x178_420"):
        with open(os.path.join(HERE, "fixtures", "torch_jpeg", f"{name}.jpg"), "rb") as f:
            src = f.read()
        for cut in range(len(src) // 2, len(src), len(src) // 25):
            kinds[_same(src[:cut])] += 1
        for _ in range(40):
            b = bytearray(src)
            for _ in range(rng.randint(1, 4)):
                b[rng.randint(len(src) // 3, len(src) - 2)] = rng.randint(0, 256)
            kinds[_same(bytes(b))] += 1
    assert kinds[True] and kinds[False]  # both images and errors were compared


def _tables(data):
    """The file's Huffman tables: {(class, id): (counts, symbols)}."""
    out, i = {}, 2
    while i + 4 < len(data) and data[i] == 0xFF and data[i + 1] != 0xDA:
        n = int.from_bytes(data[i + 2:i + 4], "big")
        if data[i + 1] == 0xC4:
            j, body = 0, data[i + 4:i + 2 + n]
            while j < len(body):
                counts = bytes(body[j + 1:j + 17])
                out[(body[j] >> 4, body[j] & 15)] = (counts, bytes(body[j + 17:j + 17 + sum(counts)]))
                j += 17 + sum(counts)
        i += 2 + n
    return out


def test_the_c_interval_decode_is_the_python_one_on_random_streams(host_library):
    with open(os.path.join(HERE, "fixtures", "torch_jpeg", "photo_218x178_420.jpg"), "rb") as f:
        tabs = _tables(f.read())
    rows = [(jpeg._lut_rows(*tabs[(0, t)], True), jpeg._lut_rows(*tabs[(1, t)], False))
            for t in (0, 1)]
    lists = [(jpeg._lut(*tabs[(0, t)], True), jpeg._lut(*tabs[(1, t)], False)) for t in (0, 1)]
    ptrs = ctypes.c_void_p * 2
    dc_p = ptrs(*[r[0].ctypes.data for r in rows])
    ac_p = ptrs(*[r[1].ctypes.data for r in rows])
    rng = np.random.RandomState(9)
    seen = {"decoded": 0, "past the end": 0, "invalid": 0}
    for _ in range(300):
        n_blocks = rng.randint(1, 10)
        blk = np.arange(n_blocks, dtype=np.int64) * 3 + rng.randint(0, 500)
        sel = rng.randint(0, 2, n_blocks).astype(np.int32)
        raw = rng.randint(0, 256, rng.randint(1, 300)).astype(np.uint8).tobytes()
        padded = raw + bytes(12 - len(raw) % 4)  # as utils/jpeg.py:_decode_scan pads
        words = np.frombuffer(padded, ">u4").tolist()
        want_ac, want_dc = [], []
        try:
            want = jpeg._decode_interval(words, list(zip(blk.tolist(), sel.tolist())),
                                         [lists[0][0], lists[1][0]], [lists[0][1], lists[1][1]],
                                         [0, 0], want_ac, want_dc)
        except IndexError:
            want = -1
        except ValueError:
            want = -2
        out_ac = np.empty(n_blocks * 63, np.int64)
        out_dc = np.empty(n_blocks, np.int64)
        n_ac = ctypes.c_longlong(0)
        got = host_library.l2i_jpeg_decode_interval(
            padded, len(padded), blk.ctypes.data, sel.ctypes.data, n_blocks, dc_p, ac_p,
            out_ac.ctypes.data, ctypes.byref(n_ac), out_dc.ctypes.data)
        assert got == want
        seen["past the end" if want == -1 else "invalid" if want == -2 else "decoded"] += 1
        if want >= 0:
            assert out_ac[:n_ac.value].tolist() == want_ac and out_dc.tolist() == want_dc
    assert seen["decoded"] and seen["past the end"], seen


def test_a_dc_size_past_15_is_a_bad_table_in_both(native):
    with open(os.path.join(HERE, "fixtures", "torch_jpeg", "photo_218x178_420.jpg"), "rb") as f:
        data = bytearray(f.read())
    assert data[177:179] == b"\xff\xc4" and data[181] == 0x00  # the first DC table
    data[198] = 0x10  # its first symbol: a DC size of 16
    want, got = _both(bytes(data))
    assert want == got == "jpeg: bad Huffman table"


@pytest.mark.parametrize("filt", ["bilinear", "bicubic", "lanczos"])
def test_the_c_resize_is_the_numpy_resize(native, filt, monkeypatch):
    monkeypatch.setitem(sys.modules, "latent2im_tpu_torch.native", None)  # the fallback's resize
    rng = np.random.RandomState(4)
    for h, w in [(1, 1), (3, 5), (178, 178), (218, 178), (64, 200)]:
        a = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        for size in [(256, 256), (7, 3), (1, 1), (w, 9)]:
            want = im._pil_resize(a, size, filt)
            got = im._pil_resize(a, size, filt, host_cpp=True)
            assert want.shape == got.shape and np.array_equal(want, got), (h, w, size)
    for path in _train_paths():
        assert np.array_equal(im.load_and_resize_image(path, 48, host_cpp=True),
                              im.load_and_resize_image(path, 48))


def test_the_cpu_path_builds_nothing_and_a_failed_build_raises(monkeypatch):
    def refused():
        raise RuntimeError("nvcc not found")

    monkeypatch.setitem(sys.modules, "latent2im_tpu_torch.native", None)  # the fallback
    monkeypatch.setattr(_build, "library", refused)
    path = JPEGS[0]
    assert im.load_and_resize_image(path, 32).shape == (32, 32, 3)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        im.load_and_resize_image(path, 32, host_cpp=True)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        im._pil_resize(np.zeros((4, 4, 3), np.uint8), (2, 2), "bilinear", host_cpp=True)
