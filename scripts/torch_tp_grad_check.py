#!/usr/bin/env python3
"""Where the tp step's f32 walk gradient lies against the f64 step, beside
the one-process step's, under cuDNN's default and deterministic algorithms
(256 px, B=4, full width, the stored noise; chip_smoke.py phase 48's inputs).

    python3 scripts/torch_tp_grad_check.py [reps]

One process: the f64 step (plain versions), then ``reps`` f32 steps under
each cuDNN mode; then two gloo ranks sharing the card run the tp step
(1 x 2) ``reps`` times under each mode. Prints each step's relative L2
distance to the f64 gradient and to the first one-process f32 gradient, and
one JSON line. Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _steps(reps, mesh=None):
    import torch

    import chip_smoke as cs
    from latent2im_tpu_torch.device import resolve_device
    from latent2im_tpu_torch.parallel import mesh as M

    dev = resolve_device("cuda")
    out = {}
    for mode in ("default", "deterministic"):
        torch.backends.cudnn.deterministic = mode == "deterministic"
        out[mode] = []
        for _ in range(reps):
            ed, walk = cs._par_editor(cs.SIZE, cs.BATCH, dev)
            if mesh is not None:
                _, walk = M.replicate_editor(ed, walk, mesh)
            out[mode].append(cs.tp_run(ed, walk, cs.BATCH, mesh)["grad"])
            del ed, walk
    torch.backends.cudnn.deterministic = False
    return out


def tp_rank(reps):
    from latent2im_tpu_torch.parallel import mesh as M

    return _steps(reps, M.make_mesh_2d(1, 2))


def main() -> int:
    import torch

    import chip_smoke as cs
    from latent2im_tpu_torch.device import resolve_device
    from latent2im_tpu_torch.ops import _build
    from latent2im_tpu_torch.parallel.launch import launch
    from latent2im_tpu_torch.walks import walk_map

    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    card = cs.card_line()
    _build.library()
    dev = resolve_device("cuda")
    ed, walk = cs._par_editor(cs.SIZE, cs.BATCH, dev)
    w0 = walk_map(lambda t: t.detach().cpu().numpy().copy(), walk)
    for m in (ed.g, ed.reg, ed.vgg, ed.d):
        m.double()
    z, sampled, _, _ = cs._par_inputs(ed, cs.BATCH)
    with cs.plain_kernels():
        f64 = cs.reference_step(ed, w0, z, sampled, torch.float64)[1]
    del ed, walk
    one = _steps(reps)
    tp = launch(tp_rank, (reps,), world_size=2, device="cuda", timeout=1200.0)
    base = one["default"][0]
    rows = []
    for path, runs in (("one process", one), ("tp 1x2", tp)):
        for mode, grads in runs.items():
            for i, g in enumerate(grads):
                rows.append({"path": path, "cudnn": mode, "rep": i,
                             "rel_l2_f64": cs.rel_l2(g, f64), "rel_l2_one_process": cs.rel_l2(g, base)})
                cs.log(f"{path} {mode} #{i}: to f64 {rows[-1]['rel_l2_f64']:.3e}, to one process "
                       f"#0 {rows[-1]['rel_l2_one_process']:.3e}")
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":  # the launched ranks import this file again
    sys.exit(main())
