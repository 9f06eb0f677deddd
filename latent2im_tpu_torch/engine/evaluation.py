"""Quantitative evaluation: identity and attribute preservation — PyTorch
port of latent2im_tpu/engine/evaluation.py (the reference's eval.py:34-239
and the bucketing of transform_base.py:675-767):

  * edits are made per panel alpha; samples fall into three epsilon buckets
    by |Delta target-attribute score| <= 0.3 / 0.6 / 1.0;
  * identity preservation: 1 - mean cosine distance between the face
    embeddings of the original and the edited image (facenet-VGGFace2 at
    160x160 in the reference; a VGG-feature embedding when no facenet
    checkpoint is given, flagged in the report);
  * attribute preservation: mean |Delta| over the NON-target regressor
    outputs per bucket (eval.py:228-239).

The buckets and the averages run on the host in numpy, as in the JAX
package; the embeddings run on the embedding tower's device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..utils.image import pil_resize_bicubic
from .editor import bilinear_resize

EPS_BUCKETS = (0.3, 0.6, 1.0)


@dataclasses.dataclass
class EvalAccumulator:
    """Per-bucket storage mirroring multi_attr/attri_org/imgs/orgs
    (transform_base.py:686-689)."""

    pred_attrs: list = dataclasses.field(default_factory=lambda: [[], [], []])
    org_attrs: list = dataclasses.field(default_factory=lambda: [[], [], []])
    edited_imgs: list = dataclasses.field(default_factory=lambda: [[], [], []])
    org_imgs: list = dataclasses.field(default_factory=lambda: [[], [], []])

    def add_batch(self, pred, org, edited, orig, target_idx: int):
        """Bucket each sample by |pred - org| at the target attribute
        (transform_base.py:718-736); a sample beyond the last edge is
        dropped."""
        delta = np.abs(pred[:, target_idx] - org[:, target_idx])
        for i in range(pred.shape[0]):
            b = next((k for k, edge in enumerate(EPS_BUCKETS) if delta[i] <= edge), None)
            if b is None:
                continue
            self.pred_attrs[b].append(pred[i])
            self.org_attrs[b].append(org[i])
            self.edited_imgs[b].append(edited[i])
            self.org_imgs[b].append(orig[i])

    def counts(self):
        return [len(b) for b in self.pred_attrs]


def attribute_preservation(acc: EvalAccumulator, target_idx: int) -> list[float]:
    """Mean abs change over the non-target attributes per bucket
    (eval.py:228-239); nan for an empty bucket."""
    out = []
    for b in range(3):
        if not acc.pred_attrs[b]:
            out.append(float("nan"))
            continue
        diff = np.abs(np.stack(acc.pred_attrs[b]) - np.stack(acc.org_attrs[b]))
        mask = np.ones(diff.shape[1], bool)
        mask[target_idx] = False
        out.append(float(np.mean(diff[:, mask])))
    return out


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def identity_preservation(acc: EvalAccumulator, embed_fn: Callable,
                          batch: int = 16) -> list[float]:
    """1 - mean cosine distance of (orig, edited) embeddings per bucket
    (eval.py:183-208). embed_fn: uint8 NHWC images -> [B, D]."""
    out = []
    for b in range(3):
        if not acc.edited_imgs[b]:
            out.append(float("nan"))
            continue
        edited = np.stack(acc.edited_imgs[b])
        orig = np.stack(acc.org_imgs[b])
        dists = []
        for i in range(0, len(edited), batch):
            e = _host(embed_fn(edited[i:i + batch]))
            o = _host(embed_fn(orig[i:i + batch]))
            cos = np.sum(e * o, axis=1) / (
                np.linalg.norm(e, axis=1) * np.linalg.norm(o, axis=1) + 1e-12)
            dists.extend(1.0 - cos)  # scipy's cosine distance
        out.append(float(1.0 - np.mean(dists)))
    return out


def resize_for_embedding(imgs_u8, size: int = 160, ref_parity: bool = False,
                         device="cpu") -> torch.Tensor:
    """uint8 NHWC -> float NHWC at the facenet input size, on ``device``.

    Default ("whitened"): the antialiased bilinear resize of
    ``editor.bilinear_resize``, then facenet's (x - 127.5) / 128.
    ref_parity=True is the reference eval.py's preprocessing (eval.py:
    183-190): Pillow's ``Image.resize((size, size))`` with its default
    BICUBIC filter on the uint8 image, raw 0-255 values, computed bit for
    bit without Pillow (``utils.image.pil_resize_bicubic``). The two modes
    are not comparable with each other, so the CLI records which one made
    the report."""
    x = np.asarray(imgs_u8)
    if x.ndim == 3:
        x = x[None]
    if ref_parity:
        out = np.stack([pil_resize_bicubic(im.astype(np.uint8), (size, size)) for im in x])
        return torch.from_numpy(out.astype(np.float32)).to(device)
    t = torch.as_tensor(x, dtype=torch.float32, device=device)
    return (bilinear_resize(t, size, size) - 127.5) / 128.0


def make_vgg_embed_fn(vgg, taps=("relu_10",), ref_parity: bool = False) -> Callable:
    """The identity embedding used when no facenet checkpoint is given: the
    spatial mean of a VGG19 feature map (``relu_10``) of the resized images;
    relative comparisons stay meaningful. ref_parity selects the
    reference's preprocessing, so the report's provenance holds on this
    path too."""
    device = next(vgg.parameters()).device

    @torch.inference_mode()
    def fn(imgs_u8):
        x = resize_for_embedding(imgs_u8, 160, ref_parity=ref_parity, device=device)
        return vgg(x, taps)[taps[0]].mean((2, 3))

    return fn
