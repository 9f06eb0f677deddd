"""The port stands alone and dispatches by device.

- No module of latent2im_tpu_torch, nor chip_smoke.py, imports jax, flax,
  optax, latent2im_tpu, or what the GPU machine lacks besides (msgpack,
  yaml, PIL) (an AST scan), and a fresh process that imports the port and
  runs a tiny CPU edit ends with none of them in sys.modules.
- An entry point given no device on a machine without a card raises: the
  builder, the Editor, the server and the CLIs' run.
- A CPU tensor through each kernel wrapper runs the plain version and leaves
  the launch count at 0; a tensor on a device that is neither cpu nor cuda is
  refused.
- The kernel build is one nvcc compile for sm_90a per .cu source, then one
  link.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from latent2im_tpu_torch import ops
from latent2im_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "latent2im_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "latent2im_tpu", "msgpack", "yaml", "PIL")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    bad = []
    files = _port_files()
    assert len(files) > 20
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [(path, n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_cpu_edit_in_a_fresh_process_loads_no_jax():
    code = (
        "import sys, argparse, warnings; warnings.simplefilter('ignore')\n"
        "from latent2im_tpu_torch.config.options import TrainOptions\n"
        "from latent2im_tpu_torch.engine.build import build_editor_from_options\n"
        "conf = TrainOptions().parse(['--attrList', 'Smiling', '--dev_tiny',\n"
        "    '--resolution', '8', '--models_dir', 'unused'], print_opt=False)\n"
        "ed, walk, _ = build_editor_from_options(conf, device='cpu')\n"
        "img, a, _ = ed.apply_alpha(walk, [[0.0] * 32], [0.5], u8=True)\n"
        "assert img.shape == (1, 8, 8, 3), img.shape\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "assert not bad, bad\n"
        "print('ok')\n" % (FORBIDDEN,)
    )
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_entry_points_without_a_device_raise_when_there_is_no_card(monkeypatch, tmp_path):
    from latent2im_tpu_torch.cli import train, vis_w
    from latent2im_tpu_torch.cli.serve import build_service
    from latent2im_tpu_torch.config.options import TrainOptions
    from latent2im_tpu_torch.device import resolve_device
    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.engine.editor import Editor, EditorConfig

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = TrainOptions().parse(["--attrList", "Smiling", "--dev_tiny",
                                 "--resolution", "8", "--models_dir", str(tmp_path)],
                                print_opt=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_editor_from_options(conf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Editor(EditorConfig(size=8, dim_z=32), None, None)
    opt = type("Opt", (), {"num_panels": 3, "min_alpha": 0.0, "max_alpha": 1.0})()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_service(opt, conf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run(conf)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vis_w.run(opt, conf)
    assert not os.listdir(tmp_path)  # they raise before writing anything
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def _wrapper_calls(device):
    rng = np.random.RandomState(0)

    def t(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device)

    return {
        "fused_act": lambda: ops.fused_leaky_relu(t(2, 4, 8), t(8)),
        "upfirdn2d": lambda: ops.upfirdn2d(t(1, 4, 4, 3), ops.make_kernel([1, 3, 3, 1]),
                                           up=2, pad=(2, 1)),
        "styled_conv3x3": lambda: ops.styled_conv3x3(
            t(1, 4, 4, 2), t(3, 3, 2, 3), t(1, 2), t(1, 3), t(1, 4, 4), t(1), t(3)),
        "fused_act_bwd": lambda: ops.fused_leaky_relu_bwd(t(2, 4, 8), t(2, 4, 8))[0],
        "upfirdn2d_bwd": lambda: ops.upfirdn2d_bwd(
            t(1, 8, 8, 3), ops.make_kernel([1, 3, 3, 1]), 2, 1, (2, 1), (4, 4)),
    }


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    before = ops.launch_counts()
    assert set(before) == {"fused_act", "fused_act_bwd", "upfirdn2d",
                           "upfirdn2d_bwd", "styled_conv3x3"}
    for name, call in _wrapper_calls("cpu").items():
        assert call().device.type == "cpu"
    assert ops.launch_counts() == before


def test_other_devices_are_refused():
    for name, call in _wrapper_calls("meta").items():
        with pytest.raises(ValueError, match="unsupported device"):
            call()


def test_kernel_build_is_one_nvcc_compile_per_source_then_one_link(monkeypatch):
    """One nvcc call per source for sm_90a, all run together, then one link
    call."""
    monkeypatch.setattr(_build, "nvcc", lambda: "/opt/cuda/bin/nvcc")
    compiles, link = _build.build_commands("out.so")
    srcs = [c for cmd in compiles for c in cmd if c.endswith(".cu")]
    assert len(srcs) == len(compiles)  # one nvcc call per source, run together
    assert {os.path.basename(s) for s in srcs} >= {
        "fused_act.cu", "upfirdn2d.cu", "styled_conv3x3.cu"}
    for cmd in compiles:
        assert "arch=compute_90a,code=sm_90a" in cmd and "-c" in cmd
    objs = [cmd[cmd.index("-o") + 1] for cmd in compiles]
    assert "-shared" in link and link[link.index("-o") + 1] == "out.so"
    assert link[-len(objs):] == objs
    path = _build.library_path()
    assert path.startswith(os.path.join(REPO, "build", "torch_kernels"))
    assert path == _build.library_path()  # stable name for unchanged sources


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    real_isfile = os.path.isfile
    monkeypatch.setattr(_build.os.path, "isfile",
                        lambda p: False if p.endswith("nvcc") else real_isfile(p))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
