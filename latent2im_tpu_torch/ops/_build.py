"""Build and load the port's hand-written CUDA kernels.

Every ``.cu`` source under ``ops/csrc/`` compiles with ONE ``nvcc`` call into
one shared library with a plain C interface, loaded with ``ctypes``. No source
includes PyTorch's headers, so the build takes seconds, not minutes. The
library is built at first use into ``build/torch_kernels/`` at the root of the
checkout (listed in ``.gitignore``) under a name that hashes the sources and
flags: an edited source rebuilds, an unchanged one loads what is there.

Each C entry point launches on the stream it is given (PyTorch's current
stream), allocates nothing, and returns ``cudaGetLastError()``; ``check``
raises on a non-zero code, since a refused launch never runs and a later
``torch.cuda.synchronize()`` would not report it.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
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
              "-shared", "-Xcompiler", "-fPIC")

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    # x, bias, y, n, c, is_bf16, slope, scale, stream
    "l2i_fused_act": (_P, _P, _P, _LL, _I, _I, _F, _F, _P),
    # g, y, dx, n, is_bf16, slope, scale, stream
    "l2i_fused_act_bwd": (_P, _P, _P, _LL, _I, _F, _F, _P),
    # x, k, out, B, H, W, C, OH, OW, kh, kw, up, down, px0, py0, stream
    "l2i_upfirdn2d": (_P, _P, _P) + (_I,) * 12 + (_P,),
    # x, w, s, d, noise, noise_w, bias, out, B, H, W, cin, cout,
    # noise_per_sample, slope, gain, stream
    "l2i_styled_conv3x3": (_P,) * 8 + (_I,) * 6 + (_F, _F, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libl2i_kernels_{h.hexdigest()[:16]}.so")


def build_command(out: str) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", out, *sources()]


def build() -> tuple[str, float]:
    """Compile the library unless it exists -> (path, seconds spent)."""
    path = library_path()
    if os.path.isfile(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run(build_command(tmp), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, path)  # atomic: a concurrent builder never loads a half file
    return path, time.perf_counter() - t0


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
                fn.restype = ctypes.c_int
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
