#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (latent2im_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (a failed phase raises, and the script exits non-zero):
  1. the card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build the hand-written kernels from ops/csrc with nvcc (sm_90a);
  3. kernels: each kernel at every shape one 256 px apply_alpha (B=4) gives
     it, held against its plain PyTorch version on the card (f32, TF32 off),
     then timed with CUDA events beside its bound, the plain version and one
     PyTorch library call computing the same function;
  4. main path: the full-width 256 px edit server (StyleGAN2 style_dim 512,
     n_mlp 8, channel multiplier 2; ResNet-50/40; Smiling; seeded random
     weights; serve_batch 4; 5 panels) answers /healthz, /edit of 1 and 4
     samples and /sweep over HTTP; the kernels' launch counts, set to 0 just
     before, must show every request went through all three kernels;
  5. profile: one apply_alpha (B=4) under torch.profiler, its device time
     by kernel group and the device's busy share (trace in chiprun_out/);
  6. card against CPU: the same apply_alpha (B=1, same weights) on cuda and
     on cpu (plain versions) must agree.
It ends with one JSON line of the kernels' numbers and, last, the line
{"ok": true, "device": {...}}. Per-shape details go to
chiprun_out/chip_smoke.json. Exits non-zero, printing no result, without a
CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import struct
import subprocess
import sys
import threading
import time
import urllib.request
import zlib

REPO = os.path.dirname(os.path.abspath(__file__))
SIZE, BATCH, PANELS = 256, 4, 5
# NVIDIA H100 SXM data sheet (dense): HBM3 bytes/s, f32 on the CUDA cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TOL = {"fused_act": 1e-6, "upfirdn2d": 1e-5, "styled_conv3x3": 1e-4}
SOURCE = {
    "fused_act": ("latent2im_tpu_torch/ops/csrc/fused_act.cu",
                  "latent2im_tpu/ops/pallas_kernels.py:99"),
    "upfirdn2d": ("latent2im_tpu_torch/ops/csrc/upfirdn2d.cu",
                  "latent2im_tpu/ops/pallas_kernels.py:296"),
    "styled_conv3x3": ("latent2im_tpu_torch/ops/csrc/styled_conv3x3.cu",
                       "latent2im_tpu/ops/pair_conv.py:142"),
}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, iters: int = 25) -> float:
    """Median of per-call CUDA-event times after warmup."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters)]
    for s, e in ev:
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels at the main path's shapes
# ---------------------------------------------------------------------------


def main_path_shapes():
    """Per 256 px apply_alpha at B=4: {kernel: [(shape args, launches)]}.
    One apply_alpha = one style MLP (get_w) + two syntheses."""
    from latent2im_tpu_torch.models.stylegan2 import channel_table

    ch = channel_table(2)
    res = [2 ** i for i in range(3, int(math.log2(SIZE)) + 1)]  # 8 .. 256
    return {
        # 8 style-MLP layers, then the up styled conv of each block (x2 synth)
        "fused_act": [((BATCH, 512), 8)] + [((BATCH, r, r, ch[r]), 2) for r in res],
        # the blur after each up conv (2H+1 -> 2H) and the C=3 skip upsample
        "upfirdn2d": [(("blur", BATCH, r + 1, ch[r]), 2) for r in res]
                     + [(("skip", BATCH, r // 2, 3), 2) for r in res],
        # conv1 at 4x4, then the non-up conv of each block
        "styled_conv3x3": [((BATCH, 4, ch[4], ch[4]), 2)]
                          + [((BATCH, r, ch[r], ch[r]), 2) for r in res],
    }


def kernel_cases(name, shape, gen, dev):
    """-> (kernel call, plain call, library call, bytes, flops)."""
    import torch
    import torch.nn.functional as F

    from latent2im_tpu_torch import ops

    def randn(*s):
        return torch.randn(s, generator=gen, device=dev)

    sqrt2 = math.sqrt(2.0)
    if name == "fused_act":
        x, b = randn(*shape), 0.1 * randn(shape[-1])
        n = x.numel()
        return (lambda: ops.fused_leaky_relu(x, b),
                lambda: ops.fused_leaky_relu_plain(x, b),
                lambda: F.leaky_relu(x + b, 0.2) * sqrt2,
                8 * n + 4 * b.numel(), 3 * n)
    if name == "upfirdn2d":
        kind, bsz, h, c = shape
        k = torch.as_tensor(ops.make_kernel([1, 3, 3, 1]), device=dev) * 4.0
        x = randn(bsz, h, h, c)
        if kind == "blur":  # pad (1, 1), 16 taps per output
            up, pad, oh, taps = 1, (1, 1), h - 1, 16
            kf = torch.flip(k, (0, 1)).expand(c, 1, 4, 4)
            lib = lambda: F.conv2d(x.permute(0, 3, 1, 2), kf, padding=1, groups=c)  # noqa: E731
        else:  # x2 upsample, pad (2, 1): 4 of the 16 taps land on samples
            up, pad, oh, taps = 2, (2, 1), 2 * h, 4
            ke = k.expand(c, 1, 4, 4)
            lib = lambda: F.conv_transpose2d(x.permute(0, 3, 1, 2), ke, stride=2,  # noqa: E731
                                             padding=1, groups=c)
        out_n = bsz * oh * oh * c
        return (lambda: ops.upfirdn2d(x, k, up=up, pad=pad),
                lambda: ops.upfirdn2d_plain(x, k, up=up, pad=pad),
                lib, 4 * (x.numel() + out_n + 16), 2 * taps * out_n)
    bsz, h, cin, cout = shape
    x = randn(bsz, h, h, cin)
    w = randn(3, 3, cin, cout) / math.sqrt(9 * cin)
    s = 1.0 + 0.2 * randn(bsz, cin)
    d = torch.rsqrt(s.square() @ w.square().sum((0, 1)) + 1e-8)
    noise, nw, bias = randn(1, h, h), torch.full((1,), 0.3, device=dev), 0.1 * randn(cout)
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    w_oihw = w.permute(3, 2, 0, 1).contiguous()

    def library():  # the rosinality grouped-conv form
        wt = w_oihw[None] * s[:, None, :, None, None] * d[:, :, None, None, None]
        out = F.conv2d(x_nchw.reshape(1, bsz * cin, h, h),
                       wt.reshape(bsz * cout, cin, 3, 3), padding=1, groups=bsz)
        out = out.view(bsz, cout, h, h) + nw * noise[:, None] + bias[:, None, None]
        return F.leaky_relu(out, 0.2) * sqrt2

    args = (x, w, s, d, noise, nw, bias)
    nbytes = 4 * (x.numel() + w.numel() + s.numel() + d.numel() + noise.numel()
                  + 1 + cout + bsz * h * h * cout)
    return (lambda: ops.styled_conv3x3(*args), lambda: ops.styled_conv3x3_plain(*args),
            library, nbytes, 2 * bsz * h * h * 9 * cin * cout)


def kernel_phase(dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    results, details = {}, []
    for name, shapes in main_path_shapes().items():
        agg = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
               "bytes_ms": 0.0, "ops_ms": 0.0, "max_abs_err": 0.0,
               "per_request": 0}
        for shape, count in shapes:
            kern, plain, lib, nbytes, flops = kernel_cases(name, shape, gen, dev)
            got = kern()
            torch.cuda.synchronize()
            want = plain()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            if not (math.isfinite(err) and err <= TOL[name] * scale):
                raise AssertionError(
                    f"{name} {shape}: max abs err {err:.3e} > {TOL[name]} * "
                    f"max|ref| {scale:.3e}")
            t_k, t_p, t_l = time_ms(kern), time_ms(plain), time_ms(lib)
            b_ms, _ = bound_ms(nbytes, flops)
            details.append({"kernel": name, "shape": list(shape), "launches": count,
                            "max_abs_err": err, "max_abs_ref": scale, "ms": t_k,
                            "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
                            "bytes": nbytes, "flops": flops})
            agg["ms"] += count * t_k
            agg["plain_ms"] += count * t_p
            agg["library_ms"] += count * t_l
            agg["bound_ms"] += count * b_ms
            agg["bytes_ms"] += count * nbytes / HBM_BYTES_PER_S * 1e3
            agg["ops_ms"] += count * flops / F32_FLOPS * 1e3
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
            agg["per_request"] += count
        agg["bound_by"] = "bytes" if agg["bytes_ms"] >= agg["ops_ms"] else "operations"
        results[name] = agg
        log(f"  {name}: {agg['per_request']} launches per apply_alpha, "
            f"max abs err {agg['max_abs_err']:.3e}; per apply_alpha "
            f"{agg['ms']:.4f} ms (plain {agg['plain_ms']:.4f}, library "
            f"{agg['library_ms']:.4f}, bound {agg['bound_ms']:.4f} by "
            f"{agg['bound_by']})")
    return results, details


# ---------------------------------------------------------------------------
# phase 4: the edit server
# ---------------------------------------------------------------------------


def png_decode(data: bytes):
    """Minimal decoder for the server's PNGs (8-bit, filter 0 rows)."""
    import numpy as np

    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = hdr[:4]
    assert depth == 8 and color == 2, hdr
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def _request(url, obj) -> dict:
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        code, out = r.status, json.loads(r.read())
    if code != 200:
        raise AssertionError(f"{url}: HTTP {code}")
    return out


def _post(url, obj):
    """-> (reply, decoded images of the reply)."""
    import base64

    out = _request(url, obj)
    return out, [png_decode(base64.b64decode(b)) for b in
                 (out["images"] if "images" in out else
                  [x for row in out["panels"] for x in row])]


def serve_phase(results, dev):
    import argparse

    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.cli.serve import build_service, make_server
    from latent2im_tpu_torch.config.options import TrainOptions
    from latent2im_tpu_torch.engine.editor import SWEEP_CHUNK, _balanced_chunk

    conf = TrainOptions().parse(
        ["--model", "stylegan_v2_real", "--transform", "face", "--walk_type",
         "linear", "--latent", "w", "--attrList", "Smiling", "--resolution",
         str(SIZE), "--models_dir", os.path.join(REPO, "chiprun_out")],
        print_opt=False)
    opt = argparse.Namespace(save_path_w=None, save_path_gan=None, attrList=None,
                             attrPath="", num_panels=PANELS, min_alpha=0.0,
                             max_alpha=1.0, serve_batch=BATCH)
    t0 = time.perf_counter()
    service = build_service(opt, conf)  # cuda: the entry point's default
    assert service.ed.device.type == dev.type
    assert service.ed.cfg.attr_idx == (31,) and service.dim_z == 512
    service.warmup()
    torch.cuda.synchronize()
    log(f"  service built and warmed in {time.perf_counter() - t0:.1f} s")
    srv = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        ops.reset_launches()
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["size"] == SIZE, health
        out1, im1 = _post(url + "/edit", {"seed": 1, "num_samples": 1, "alpha": 0.9})
        out4, im4 = _post(url + "/edit", {"seed": 2, "num_samples": 4, "alpha": 0.1})
        outs, ims = _post(url + "/sweep", {"seed": 3, "num_samples": 4})
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert len(im1) == 1 and len(im4) == 4 and len(ims) == PANELS * 4
        for im in im1 + im4 + ims:
            assert im.shape == (SIZE, SIZE, 3) and im.dtype == np.uint8
        for a in out1["alpha_org"] + out4["alpha_org"] + outs["alpha_org"]:
            assert all(math.isfinite(v) for v in a), a
        assert len(outs["panels"]) == PANELS
        per_alpha = {name: r["per_request"] for name, r in results.items()}
        n_chunks = -(-PANELS * BATCH // _balanced_chunk(PANELS * BATCH, SWEEP_CHUNK))
        per_synth = {"fused_act": (per_alpha["fused_act"] - 8) // 2,
                     "upfirdn2d": per_alpha["upfirdn2d"] // 2,
                     "styled_conv3x3": per_alpha["styled_conv3x3"] // 2}
        expect = {k: 2 * per_alpha[k] + (1 + n_chunks) * per_synth[k]
                  + (8 if k == "fused_act" else 0) for k in per_alpha}
        log(f"  launches over /healthz + 2 /edit + 1 /sweep: {counts} "
            f"(expected {expect})")
        assert counts == expect, (counts, expect)
        assert all(v > 0 for v in counts.values())

        lat, n_img = [], 0
        t_all = time.perf_counter()
        for i in range(10):  # timed to the parsed JSON reply; no client decode
            t = time.perf_counter()
            out = _request(url + "/edit", {"seed": 10 + i, "num_samples": BATCH,
                                           "alpha": 0.7})
            lat.append((time.perf_counter() - t) * 1e3)
            n_img += len(out["images"])
        wall = time.perf_counter() - t_all
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    z = np.random.RandomState(0).randn(BATCH, 512).astype(np.float32)
    a = np.full((BATCH,), 0.7, np.float32)
    dev_ms = time_ms(lambda: service.ed.apply_alpha(service.walk, z, a, u8=True),
                     warmup=2, iters=10)
    serve = {"p50_request_ms": statistics.median(lat), "img_per_s": n_img / wall,
             "requests": len(lat), "images": n_img,
             "apply_alpha_b4_device_ms": dev_ms}
    return service, conf, counts, serve


# ---------------------------------------------------------------------------
# phase 5: where an edit's device time goes
# ---------------------------------------------------------------------------

KERNEL_GROUPS = (  # (group, substrings of the CUDA kernel name), first match
    ("styled_conv3x3 (ours)", ("small_tile_kernel", "large_tile_kernel")),
    ("upfirdn2d (ours)", ("upfirdn2d_kernel",)),
    ("fused_act (ours)", ("fused_act_kernel",)),
    ("cuDNN/cuBLAS conv + GEMM", ("cudnn", "xmma", "gemm", "conv", "cutlass", "wgrad",
                                  "dgrad", "implicit", "sm90", "sm80")),
    ("PyTorch elementwise/reduce/copy", ("elementwise", "reduce", "copy", "fill",
                                        "index", "cat", "vectorized")),
)


def profile_phase(service):
    """One apply_alpha (B=4, uint8) under torch.profiler: device time by
    kernel group and the device's busy share of the host-timed call."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    z = np.random.RandomState(1).randn(BATCH, 512).astype(np.float32)
    a = np.full((BATCH,), 0.7, np.float32)
    service.ed.apply_alpha(service.walk, z, a, u8=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        service.ed.apply_alpha(service.walk, z, a, u8=True)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(REPO, "chiprun_out", "apply_alpha_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    kernels = [e for e in (events.get("traceEvents", events) if isinstance(events, dict)
                           else events)
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
    if not kernels:
        return {"wall_ms": wall_ms, "device": "not measured (no kernel events in the trace)"}
    groups: dict[str, float] = {}
    for e in kernels:
        name = e["name"].lower()
        g = next((g for g, keys in KERNEL_GROUPS if any(k.lower() in name for k in keys)),
                 "other")
        groups[g] = groups.get(g, 0.0) + e["dur"] / 1e3
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, end = 0.0, -1e30
    for s, t in spans:  # union of kernel intervals
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    busy_ms = busy / 1e3
    return {"wall_ms": wall_ms, "kernels": len(kernels), "device_busy_ms": busy_ms,
            "busy_share_of_wall": busy_ms / wall_ms,
            "device_ms_by_group": dict(sorted(groups.items(), key=lambda kv: -kv[1]))}


# ---------------------------------------------------------------------------
# phase 6: card against CPU
# ---------------------------------------------------------------------------


def cpu_phase(service, conf):
    import numpy as np

    from latent2im_tpu_torch.engine.build import build_editor_from_options

    cpu_ed, cpu_walk, _ = build_editor_from_options(conf, device="cpu")
    z = np.random.RandomState(7).randn(1, 512).astype(np.float32)
    a = np.asarray([0.8], np.float32)
    t = time.perf_counter()
    ce, ca, co = (v.numpy() for v in cpu_ed.apply_alpha(cpu_walk, z, a))
    cpu_s = time.perf_counter() - t
    ge, ga, go = (v.cpu().numpy() for v in service.ed.apply_alpha(service.walk, z, a))
    out = {"cpu_apply_alpha_s": cpu_s}
    for name, g, c in (("edited", ge, ce), ("orig", go, co)):
        assert np.isfinite(g).all() and g.shape == (1, SIZE, SIZE, 3)
        rel = float(np.linalg.norm(g - c) / np.linalg.norm(c))
        out[f"{name}_rel_l2"] = rel
        assert rel < 1e-3, (name, rel)
    err = float(np.abs(ga - ca).max())
    out["alpha_org_abs_err"], out["alpha_org"] = err, float(ca[0, 0])
    assert err <= 1e-3 * max(1.0, float(np.abs(ca).max())), (ga, ca)
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "latent2im_tpu_torch")):
        print(f"chip_smoke: no latent2im_tpu_torch/ beside {__file__}: run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from latent2im_tpu_torch.device import resolve_device
    from latent2im_tpu_torch.ops import _build

    t_start = time.perf_counter()
    card = card_line()
    log(f"[1] card: {card}")
    log(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    dev = resolve_device("cuda")  # TF32 off for cuDNN and cuBLAS

    path, secs = _build.build()
    _build.library()
    log(f"[2] kernels built in {secs:.1f} s: {os.path.relpath(path, REPO)}")

    log("[3] kernels against their plain versions at the 256 px B=4 shapes")
    results, details = kernel_phase(dev)
    log("kernels: " + json.dumps(
        [{"name": n, "launches_per_apply_alpha": r["per_request"]}
         for n, r in results.items()]))

    log("[4] main path: the 256 px edit server over HTTP")
    service, conf, counts, serve = serve_phase(results, dev)
    log(f"    p50 request latency {serve['p50_request_ms']:.1f} ms, "
        f"{serve['img_per_s']:.2f} img/s ({serve['requests']} /edit requests "
        f"of {BATCH}), apply_alpha B={BATCH} device time "
        f"{serve['apply_alpha_b4_device_ms']:.2f} ms, on {card}")

    log("[5] one apply_alpha (B=4) under torch.profiler")
    prof = profile_phase(service)
    log(f"    {json.dumps(prof)}")

    log("[6] card against CPU (B=1, same weights)")
    cmp_ = cpu_phase(service, conf)
    log(f"    {cmp_}")

    kernels = [{
        "name": n, "route": "cuda", "source": SOURCE[n][0], "replaces": SOURCE[n][1],
        "launches": counts[n], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
    } for n, r in results.items()]
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "kernels": kernels, "shapes": details, "serve": serve, "profile": prof,
              "cpu_vs_card": cmp_, "seconds": time.perf_counter() - t_start}
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"done in {report['seconds']:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
