"""Quantitative eval CLI — identity and attribute preservation; PyTorch port
of latent2im_tpu/cli/eval.py.

Loads a training run's opt.yml and a walk checkpoint, makes the panel edits
of each trained attribute (one ``Editor.sweep`` per batch, one
``regress_all`` over all its panels), buckets the samples by |Delta
target-attr| <= 0.3 / 0.6 / 1.0 and reports per bucket

  * identity preservation (1 - mean cosine distance of face embeddings:
    facenet with --facenet_path, a VGG-feature embedding otherwise)
  * attribute preservation (mean |Delta| over the non-target regressor
    outputs)

into ``<output_dir>/eval_report.json``:

    python -m latent2im_tpu_torch.cli.eval <run_dir>/opt.yml \\
        --save_path_w <run_dir>/model_w_10_final_walk_module.ckpt \\
        [--facenet_path facenet_vggface2.pt] [--ref_parity] \\
        [--num_samples 64] [--output_dir ./eval_out]

Runs on the card (``device`` cuda unless the caller asks for the CPU).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..config.options import VisOptions
from ..device import resolve_device
from ..engine import evaluation as ev
from ..engine.build import load_editor_for_inference
from ..engine.train import sample_epoch_z
from ..tasks.transforms import get_task, task_kwargs_from_options
from ..utils import image as imgmod

BATCH = 8  # z per sweep call; its P panels fold into the batch


def run(opt, conf, device=None):
    """Evaluate the walk of ``opt`` on ``device`` -> the report's results."""
    device = resolve_device(device)
    for flag in ("n_devices", "sp_devices"):
        if (getattr(opt, flag, None) or 1) > 1:
            raise NotImplementedError(
                f"--{flag} > 1 is not ported yet (ROADMAP.md queue A item 15)")
    editor, walk_params, info = load_editor_for_inference(opt, conf, device)

    ref_parity = bool(getattr(opt, "ref_parity", False))
    facenet_path = getattr(opt, "facenet_path", "")
    if facenet_path:
        from ..models.facenet import InceptionResnetV1

        net = InceptionResnetV1.from_state_dict(
            torch.load(facenet_path, map_location="cpu", weights_only=False)
        ).to(device)

        @torch.inference_mode()
        def embed_fn(imgs_u8):
            return net(ev.resize_for_embedding(imgs_u8, 160, ref_parity=ref_parity,
                                               device=device))

        embed_name = "facenet-vggface2"
    else:
        print("NOTE: no --facenet_path; identity uses a VGG-feature embedding")
        if editor.vgg is None:
            raise ValueError("the VGG-feature identity embedding needs the run's "
                             "VGG19 (trained with --no_content_loss: give "
                             "--facenet_path)")
        embed_fn = ev.make_vgg_embed_fn(editor.vgg, ref_parity=ref_parity)
        embed_name = "vgg-fallback"

    # identity numbers from a randomly initialized embedding tower rank edits
    # relative to each other but compare with no published absolute figure
    identity_relative_only = (embed_name == "vgg-fallback"
                              and not info["pretrained"]["vgg"])
    if identity_relative_only:
        print("=" * 72)
        print("WARNING: the identity embedding tower is RANDOMLY INITIALIZED "
              "(no --facenet_path / --vgg_path).")
        print("Identity-preservation numbers below are RELATIVE-ONLY: valid "
              "for comparing runs of this exact build, meaningless as "
              "absolute identity scores.")
        print("=" * 72)

    task = get_task(conf.transform, walk_type=conf.walk_type,
                    nsliders=len(info["attr_list"]), **task_kwargs_from_options(conf))
    panel_alphas = task.test_alphas()

    zs = sample_epoch_z(opt.num_samples, editor.cfg.dim_z, seed=opt.noise_seed)
    report = {}
    for a_pos, attr in enumerate(editor.cfg.attr_list):
        target_idx = editor.cfg.attr_idx[a_pos]
        acc = ev.EvalAccumulator()
        for bs in range(0, opt.num_samples, BATCH):
            z = zs[bs:bs + BATCH]
            panels = np.stack([task.scale_test_alpha(a, z.shape[0])
                               for a in panel_alphas]).astype(np.float32)
            imgs, _, orig = editor.sweep(walk_params, z, panels)
            org_all = editor.regress_all(orig).cpu().numpy()
            # one regressor call over all panels (flattened [P * B, ...])
            p, b = imgs.shape[0], imgs.shape[1]
            preds_all = editor.regress_all(
                imgs.reshape(p * b, *imgs.shape[2:])).cpu().numpy().reshape(p, b, -1)
            orig_u8 = imgmod.to_uint8(orig.cpu().numpy())
            imgs = imgs.cpu().numpy()
            for pi in range(p):
                acc.add_batch(preds_all[pi], org_all, imgmod.to_uint8(imgs[pi]),
                              orig_u8, target_idx=target_idx)
        identity = ev.identity_preservation(acc, embed_fn)
        attr_pres = ev.attribute_preservation(acc, target_idx)
        report[attr] = {
            "bucket_counts": acc.counts(),
            "identity_preservation": identity,
            "attribute_preservation": attr_pres,
        }
        print(f"[{attr}] buckets(<=0.3/0.6/1.0): {acc.counts()}")
        print(f"[{attr}] identity preservation ({embed_name}): {identity}")
        print(f"[{attr}] attribute preservation: {attr_pres}")

    out_dir = opt.output_dir or "."
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "eval_report.json"), "w") as f:
        json.dump({
            "embedding": embed_name,
            # provenance: 'reference' = raw 0-255 Pillow-BICUBIC-resized
            # inputs, bit-matching eval.py:183-190; 'whitened' = bilinear +
            # (x - 127.5) / 128. The two modes must not be cross-compared.
            "embedding_preprocess": "reference" if ref_parity else "whitened",
            "identity_is_relative_only": identity_relative_only,
            "results": report,
        }, f, indent=2)
    return report


def main(argv=None):
    vo = VisOptions()
    vo.parser.add_argument("--facenet_path", type=str, default="")
    vo.parser.add_argument("--ref_parity", action="store_true",
                           help="feed raw 0-255 Pillow-BICUBIC-resized images "
                                "to the identity embedding, bit-matching the "
                                "reference eval.py's preprocessing")
    opt, conf = vo.parse(argv)
    run(opt, conf)


if __name__ == "__main__":
    main()
