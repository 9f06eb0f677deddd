"""Build and load the port's hand-written CUDA kernels.

Every ``.cu`` source under ``ops/csrc/`` compiles to an object with its own
``nvcc`` call, all started together, and one more ``nvcc`` call links them
into one shared library with a plain C interface, loaded with ``ctypes``.
The host C++ there (``jpeg_huffman.cpp``, ``webp_decode.cpp``,
``jpeg2000_t1.cpp``, ``resample.cpp`` and ``native_decode.cpp``, the image
loaders' hot loops)
compiles the same way, into the same library. No
source includes PyTorch's headers, so the build takes seconds, not minutes.
The library is built at first use into ``build/torch_kernels/`` at the root of
the checkout (listed in ``.gitignore``) under a name that hashes the sources
and flags: an edited source rebuilds, an unchanged one loads what is there.

    python -m latent2im_tpu_torch.ops._build

times clean builds of the sources this way against one ``nvcc`` call over
all of them, in the order one, parallel, parallel, one (one JSON line each).

Each C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns ``cudaGetLastError()``; ``check``
raises on a non-zero code, since a refused launch never runs and a later
``torch.cuda.synchronize()`` would not report it.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import json
import os
import shutil
import subprocess
import tempfile
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "torch_kernels",
)
# sm_90a (not sm_90): the Hopper-only instructions later kernels need exist
# only for that target
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    # x, bias, y, n, c, is_bf16, slope, scale, stream
    "l2i_fused_act": (_P, _P, _P, _LL, _I, _I, _F, _F, _P),
    # g, y, dx, n, is_bf16, slope, scale, stream
    "l2i_fused_act_bwd": (_P, _P, _P, _LL, _I, _F, _F, _P),
    # x, k, out, B, H, W, C, OH, OW, kh, kw, up, down, px0, py0, is_bf16,
    # stream
    "l2i_upfirdn2d": (_P, _P, _P) + (_I,) * 13 + (_P,),
    # x, out, C, kh, kw, up, down, is_bf16 -> 0 generic, 1, 4 or 8 templated
    # (channels per thread)
    "l2i_upfirdn2d_form": (_P, _P) + (_I,) * 6,
    # x, w, s, d, noise, noise_w, bias, out, workspace, B, H, W, cin, cout,
    # noise_per_sample, is_bf16, slope, gain, stream
    "l2i_styled_conv3x3": (_P,) * 9 + (_I,) * 7 + (_F, _F, _P),
    # B, H, W, cin, cout, is_bf16, int[3] {BM, BN, splits} -> workspace bytes
    "l2i_styled_conv3x3_plan": (_I,) * 6 + (_P,),
    # the tensor-parallel split: x, w, s, acc (f32), workspace, B, H, W, cin,
    # cout, is_bf16, stream
    "l2i_styled_conv3x3_partial": (_P,) * 5 + (_I,) * 6 + (_P,),
    # acc, d, noise, noise_w, bias, out, B, H, W, cout, noise_per_sample,
    # is_bf16, slope, gain, stream
    "l2i_styled_conv3x3_epilogue": (_P,) * 6 + (_I,) * 6 + (_F, _F, _P),
    # host C++ of utils/jpeg.py and utils/image.py (jpeg_huffman.cpp,
    # resample.cpp), not kernels. data, n_bytes, blocks, comps, n_blocks,
    # dc_luts, ac_luts, out_ac, n_ac, out_dc -> bits used, -1 past the data,
    # -2 an invalid code
    "l2i_jpeg_decode_interval": (_P, _LL, _P, _P, _LL, _P, _P, _P, _P, _P),
    # data, n, int[2] {height, width} -> 0, -1 no frame header found
    "l2i_jpeg_dims": (_P, _LL, _P),
    # data, n, out, out_bytes, long long[2] info, libjpeg (0: as Pillow
    # reads, 1: as libjpeg-turbo 2.1 alone) -> 0 or an error code
    "l2i_jpeg_decode": (_P, _LL, _P, _LL, _P, _I),
    # utils/webp.py's decoder (webp_decode.cpp): data, n, int[2] {height,
    # width} -> 0 or an error code
    "l2i_webp_dims": (_P, _LL, _P),
    # data, n, out, out_bytes, long long[2] info -> 0 or an error code
    "l2i_webp_decode": (_P, _LL, _P, _LL, _P),
    # in, row, h, w, c, idx_w, k_w, ks_w, out_w, idx_h, k_h, ks_h, out_h,
    # bits, out
    "l2i_resize": (_P, _LL) + (_I,) * 3 + (_P, _P, _I, _I, _P, _P, _I, _I, _I, _P),
    # the native path (native_decode.cpp): data, n, h, stride, bpp, out -> 0,
    # -1 short data, -2 an unknown filter
    "l2i_png_unfilter": (_P, _LL, _I, _LL, _I, _P),
    # img, h, w, size, out (no return value)
    "l2i_crop_resize": (_P, _I, _I, _I, _P),
    # utils/jpeg2000.py's tier-1 (jpeg2000_t1.cpp): data, int[n][8] block
    # meta, int[][2] segments, n, out -> 0, -1 out of memory, -2 a block of
    # 31 or more bit planes
    "l2i_j2k_t1": (_P, _P, _P, _I, _P),
}
# a source's own flags beyond NVCC_FLAGS: the crop-resize's double sums in
# the order written, no fused multiply-add
SOURCE_FLAGS = {"native_decode.cpp": ("-Xcompiler", "-ffp-contract=off")}
# the others return an int
RESTYPES = {"l2i_styled_conv3x3_plan": _LL, "l2i_jpeg_decode_interval": _LL}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[str]:
    """The CUDA sources and the host C++ beside them (nvcc hands a .cpp to
    the host compiler)."""
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cpp")))


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the port's CUDA kernels build from source at first use"
    )


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + repr(sorted(SOURCE_FLAGS.items())).encode())
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libl2i_kernels_{h.hexdigest()[:16]}.so")


def build_commands(out: str) -> tuple[list[list[str]], list[str]]:
    """(one compile command per source, the link command) for library `out`;
    the objects sit beside it."""
    objs = [f"{out}.{os.path.basename(src)}.o" for src in sources()]
    compiles = [[nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(os.path.basename(src), ()), "-c",
                 "-o", obj, src] for obj, src in zip(objs, sources())]
    return compiles, [nvcc(), "-shared", "-o", out, *objs]


def _run(stages: list[list[list[str]]]) -> None:
    """Run the commands of each stage together, stage after stage; after a
    failure stop the stage's commands still running and raise."""
    for cmds in stages:
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True) for cmd in cmds]
        try:
            for cmd, proc in zip(cmds, procs):
                out, err = proc.communicate()
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed (exit {proc.returncode}): "
                                       f"{' '.join(cmd)}\n{out}\n{err}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()


def build() -> tuple[str, float]:
    """Compile the library unless it exists -> (path, seconds spent)."""
    path = library_path()
    if os.path.isfile(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    compiles, link = build_commands(tmp)
    try:
        _run([compiles, [link]])  # all sources at once, then the link
    finally:
        for cmd in compiles:
            obj = cmd[cmd.index("-o") + 1]
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, path)  # atomic: a concurrent builder never loads a half file
    return path, time.perf_counter() - t0


def time_builds() -> None:
    """Print the seconds of clean builds of the sources: one nvcc call per
    source run together then a link (``build``), against one nvcc call over
    all sources, alternating one, parallel, parallel, one."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as d:
        out = os.path.join(d, "lib.so")
        compiles, link = build_commands(out)
        single = [nvcc(), *NVCC_FLAGS, "-shared", "-o", out, *sources()]
        one, parallel = ("one nvcc call", [[single]]), ("one call per source",
                                                        [compiles, [link]])
        for name, stages in (one, parallel, parallel, one):
            t0 = time.perf_counter()
            _run(stages)
            print(json.dumps({"build": name, "sources": len(sources()),
                              "seconds": time.perf_counter() - t0}), flush=True)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = RESTYPES.get(name, ctypes.c_int)
            lib.l2i_error_string.argtypes = [ctypes.c_int]
            lib.l2i_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = library().l2i_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} at launch: {msg}")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def count(fn, t) -> None:
    """One launch of ``fn``'s kernel on tensor ``t``: raise ``fn.launches``,
    and ``fn.launches_bf16`` too where ``t`` is bf16 (the bf16 instance)."""
    import torch

    fn.launches += 1
    if t.dtype == torch.bfloat16:
        fn.launches_bf16 += 1


if __name__ == "__main__":
    time_builds()
