#!/usr/bin/env python3
"""Two gloo ranks sharing one card: all_gather of CUDA tensors handed to gloo
as they are, against the same gather staged through host copies (what
parallel/mesh.py:_to_wire does for send and recv), at the sizes the sp path
gathers (the rgb rows of a 1024 px image, B=1, and smaller ones).

    python3 scripts/torch_gloo_gather_ab.py

Needs a CUDA card. Each size is timed in A B B A order, host clock around a
device synchronisation, median of REPS; prints one JSON line with the card's
name and power limit and writes it to chiprun_out/torch_gloo_gather_ab.json.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REPS = 20
SHAPES = ((1, 16, 1024, 3), (1, 128, 1024, 3), (1, 512, 1024, 3))  # f32 rgb row shards


def _rank():
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", torch.cuda.current_device())
    world = dist.get_world_size()

    def direct(t):
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        return torch.cat(parts, 1)

    def staged(t):
        w = t.cpu()
        parts = [torch.empty_like(w) for _ in range(world)]
        dist.all_gather(parts, w)
        return torch.cat(parts, 1).to(t.device)

    def ms(fn, t):
        times = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            dist.barrier()
            t0 = time.perf_counter()
            fn(t)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    out = []
    for shape in SHAPES:
        t = torch.randn(shape, device=dev) + dist.get_rank()
        assert torch.equal(direct(t), staged(t))
        a1, b1, b2, a2 = ms(direct, t), ms(staged, t), ms(staged, t), ms(direct, t)
        out.append({"shape": list(shape), "bytes_per_rank": t.numel() * 4,
                    "direct_ms": [a1, a2], "staged_ms": [b1, b2]})
    return out


def main() -> int:
    import torch

    from latent2im_tpu_torch.parallel.launch import launch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    rows = launch(_rank, (), world_size=2, device="cuda", timeout=600.0)
    report = {"card": card, "torch": torch.__version__, "ranks": 2, "backend": "gloo",
              "reps": REPS, "rows": rows}
    print(json.dumps(report))
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "torch_gloo_gather_ab.json"), "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":  # the launched ranks import this file again
    sys.exit(main())
