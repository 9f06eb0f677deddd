"""Walk-training losses, weighed as the reference weighs them — PyTorch port
of latent2im_tpu/engine/losses.py.

total = 10 * reg_BCE + 0.05 * VGG_content + 0.05 * GAN_BCE, with the
--no_content_loss / --no_gan_loss ablations (when both are dropped the reg
term is unweighted; pggan drops the weight when either is).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models import vgg as vggm

REG_WEIGHT = 10.0
CONTENT_WEIGHT = 0.05
GAN_WEIGHT = 0.05


def raw_bce(pred, target, eps: float = 1e-12):
    """The reference's handwritten BCE on *raw* (unbounded) regressor
    outputs: pred and 1 - pred are clamped at eps before the log, so a pred
    above 1 hits the clamp. Kept for parity, in f32 as the JAX package has
    it (the reference casts the target to f64)."""
    pred, target = pred.float(), target.float()
    t1 = target * torch.log(torch.clamp(pred, min=eps))
    t2 = (1.0 - target) * torch.log(torch.clamp(1.0 - pred, min=eps))
    return -torch.mean(t1 + t2)


def stable_bce(pred, target):
    """Numerically stable sigmoid BCE (opt-in via --stable_bce)."""
    pred, target = pred.float(), target.float()
    return torch.mean(torch.clamp(pred, min=0) - pred * target
                      + torch.log1p(torch.exp(-pred.abs())))


def reg_loss(pred, target, stable: bool = False):
    return stable_bce(pred, target) if stable else raw_bce(pred, target)


def gan_loss_from_logits(d_logits):
    """BCEWithLogits(D(edited), 1) = softplus(-logit), averaged."""
    return torch.mean(F.softplus(-d_logits.float()))


def content_loss(vgg, org_img, edited_img, taps=vggm.CONTENT_TAPS):
    """Mean over the taps of the MSE between VGG19 features of the original
    (no gradient) and the edited NHWC images, both ImageNet-normalized as
    they are in [-1, 1]."""
    with torch.no_grad():
        f_org = vgg(vggm.imagenet_normalize(org_img), taps)
    f_edi = vgg(vggm.imagenet_normalize(edited_img), taps)
    losses = [torch.mean(torch.square(f_org[t].float() - f_edi[t].float()))
              for t in taps]
    return sum(losses) / len(losses)


def combine(reg, content, gan, no_content_loss=False, no_gan_loss=False,
            pggan_gating=False):
    """Weighted sum with the reference's ablation gating: stylegan drops the
    10x when BOTH ablations are on, pggan when EITHER is."""
    bare = (no_content_loss or no_gan_loss) if pggan_gating else (
        no_content_loss and no_gan_loss
    )
    loss = reg if bare else REG_WEIGHT * reg
    if not no_content_loss:
        loss = loss + CONTENT_WEIGHT * content
    if not no_gan_loss:
        loss = loss + GAN_WEIGHT * gan
    return loss
