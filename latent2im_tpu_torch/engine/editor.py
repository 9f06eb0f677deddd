"""The editing engine: frozen towers + walk — PyTorch port.

The counterpart of latent2im_tpu/engine/editor.py:

    get_w           z -> W+ stack [B, L, D]
    synthesize      latent -> image NHWC (stored or fresh noise)
    regress         image -> attribute scores [B, A]
    regress_all     image -> every regressor output (eval)
    discriminate    image -> D logits
    unified_alphas  (org, sampled) -> (target, delta)
    edit            walk application
    apply_alpha     regress current, walk, synthesize
    sweep           panels folded into the batch, synthesized in chunks
    apply_alpha_combine / sweep_combine
                    two attributes moved together (the vis_w grid; W space)

The latent is W+ [B, L, D] (latent 'w': the walk moves the style MLP's
output, by the delta to the requested target) or z [B, D] (latent 'z':
StyleGAN2 through its style MLP, or an injected backend such as PGGAN; the
walk moves z and takes the requested alpha as it is). ``synth_fn(g,
latent, dtype)`` and ``disc_fn(d, img, dtype)`` inject a backend without
subclassing (engine/build.py makes the PGGAN ones); they take the editor's
current G and D and ``tower_dtype``. The 'embed' walk ignores alpha, so the
alpha-driven paths refuse it.

``EditorConfig.compute_dtype`` torch.bfloat16 (--bf16) runs G's synthesis,
the regressor, VGG19 and D in bf16 as the JAX package's ``compute_dtype``
does; the style MLP, the walk and the losses stay f32, and every tower
returns f32.

PyTorch runs eagerly, so there is nothing to compile and no static program
width: a sweep's last chunk is simply narrower. The public inference methods
run under ``torch.inference_mode``; the walk-training step
(engine/train.py) calls the same computations through ``latent_of``,
``synth``, ``scores`` and ``discriminate``, which keep autograd on, since a
tensor made under inference mode cannot be saved for a backward. Every tower
(G, the regressor, VGG19 and D) is frozen with ``requires_grad_(False)``: a
step differentiates the walk only (the --updateGAN fine-tune, engine/gan.py,
unfreezes G or D inside its own steps). The towers live on the editor's device;
inputs may be numpy or tensors, outputs are tensors on that device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..utils.remat import checkpoint
from ..walks import walks as W

# Default synthesis chunk width for panel sweeps (the JAX package's value).
SWEEP_CHUNK = 32


def _balanced_chunk(n: int, cap: int) -> int:
    """Chunk width <= cap that balances n across ceil(n/cap) chunks."""
    n_chunks = -(-n // cap)
    return -(-n // n_chunks)


def _u8(img):
    """[-1, 1] float -> uint8: clip (x + 1) * 127.5 to [0, 255], then
    truncate (utils.image.to_uint8 semantics; the clip comes first, so the
    truncating cast never sees an out-of-range value)."""
    return torch.clamp((img.float() + 1.0) * 127.5, 0.0, 255.0).to(torch.uint8)


@dataclasses.dataclass(frozen=True)
class EditorConfig:
    model: str = "stylegan_v2_real"
    latent: str = "w"
    walk_kind: str = "linear_w"
    attr_list: tuple[str, ...] = ("Smiling",)
    attr_idx: tuple[int, ...] = (31,)
    size: int = 256
    dim_z: int = 512
    layers: tuple[int, ...] | None = None
    alpha_mode: str = "target"  # 'target' (stylegan) | 'delta' (pggan)
    no_content_loss: bool = False
    no_gan_loss: bool = False
    stable_bce: bool = False
    fixed_noise: bool = False  # True = stored noise maps during training
    # resize images to this size before the regressor (None: feed the
    # generator's resolution); e.g. 256 for a 1024 px G, the regressor's own
    reg_input_size: int | None = None
    # resize both images to this size before the VGG content loss (None:
    # compare at the generator's resolution)
    content_input_size: int | None = None
    # rematerialize the edited synthesis in the step's backward: False, 'all'
    # (one checkpoint around it) or 'block' (one per synthesis block)
    remat_g: bool | str = False
    # rematerialize the loss towers (regressor, VGG content loss, D)
    remat_towers: bool = False
    # the towers' compute dtype: torch.float32, or torch.bfloat16 (--bf16)
    compute_dtype: torch.dtype = torch.float32

    @property
    def n_latent(self) -> int:
        return int(np.log2(self.size)) * 2 - 2


class Editor:
    """Capability surface over frozen towers."""

    def __init__(self, cfg: EditorConfig, g, reg, device=None, vgg=None, d=None,
                 synth_fn=None, disc_fn=None):
        """g: models.stylegan2.Generator, reg: models.resnet.ResNet50, and
        for training vgg: models.vgg.VGG19Features, d:
        models.stylegan2.Discriminator (None where the loss is off). All
        move to ``device`` (cuda unless the caller asks for the CPU).
        synth_fn(g, latent, dtype) / disc_fn(d, img, dtype) replace G's
        synthesis and D's call for another backend (G and D then are its
        modules; dtype the editor's ``tower_dtype``)."""
        self.cfg = cfg
        self._synth_fn, self._disc_fn = synth_fn, disc_fn
        self.device = resolve_device(device)
        self.g = g.to(self.device).eval().requires_grad_(False)

        def frozen(m):  # conv towers: channels_last, what cuDNN runs fastest
            if m is None:
                return None
            m = m.to(self.device, memory_format=torch.channels_last)
            return m.eval().requires_grad_(False)

        self.reg, self.vgg, self.d = frozen(reg), frozen(vgg), frozen(d)
        self._attr_idx = torch.as_tensor(cfg.attr_idx, device=self.device)

    def frozen_params(self) -> dict:
        """The frozen towers by the JAX package's names ("g", "reg", and
        "vgg", "d" where built), as modules: what
        parallel/mesh.py:frozen_tp_shardings lays out."""
        out = {"g": self.g, "reg": self.reg}
        out.update({k: m for k, m in (("vgg", self.vgg), ("d", self.d)) if m is not None})
        return out

    @property
    def tower_dtype(self):
        """The dtype the towers are asked to compute in: bf16 under
        compute_dtype bf16, else None (their inputs' own: f32, or an f64
        reference's, which an f32 cast would spoil)."""
        dt = self.cfg.compute_dtype
        return None if dt == torch.float32 else dt

    def _tensor(self, a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=self.device)

    # -- building blocks (autograd on, for the training step) -------------

    def latent_of(self, z):
        """z [B, D] -> W+ [B, n_latent, D] (style MLP output tiled)."""
        w = self.g.style_forward(self._tensor(z))
        return w[:, None, :].expand(-1, self.cfg.n_latent, -1)

    def edit_latent(self, z, given_w=None):
        """The latent a walk edits: given_w if set, else W+ of z (latent
        'w') or z itself (latent 'z')."""
        if given_w is not None:
            return self._tensor(given_w)
        return self.latent_of(z) if self.cfg.latent == "w" else self._tensor(z)

    @property
    def draws_noise(self) -> bool:
        """False for a backend without noise injection (an injected
        synth_fn, e.g. PGGAN)."""
        return self._synth_fn is None

    def make_noise(self, batch: int, generator):
        """Fresh per-layer noise for G, or None where G draws none."""
        return self.g.make_noise(batch, generator) if self.draws_noise else None

    def synth(self, latent, noise=None, block_remat: bool = False):
        """W+ [B, L, D] (latent 'w') or z [B, D] (latent 'z') -> image
        [B, H, W, 3]. noise: per-layer noise (Generator.make_noise), or None
        for the stored noise maps. block_remat checkpoints each synthesis
        block (Generator.synthesize); an injected synth_fn has no blocks to
        hook and becomes one checkpoint over its whole forward."""
        latent = self._tensor(latent)
        dt = self.tower_dtype
        if self._synth_fn is not None:
            if block_remat:
                return checkpoint(lambda lat: self._synth_fn(self.g, lat, dt), latent)
            return self._synth_fn(self.g, latent, dt)
        if self.cfg.latent == "z":
            return self.g(latent, noise=noise, block_remat=block_remat, dtype=dt)
        return self.g.synthesize(latent, noise=noise, block_remat=block_remat, dtype=dt)

    def _reg_input(self, img):
        s = self.cfg.reg_input_size
        if s and img.shape[1] != s:
            img = bilinear_resize(img, s, s)
        return img

    def _content_input(self, img):
        s = self.cfg.content_input_size
        if s and img.shape[1] != s:
            img = bilinear_resize(img, s, s)
        return img

    def scores(self, img):
        """image -> regressor scores at the configured attributes [B, A]
        (resized to reg_input_size first, where set)."""
        return self.reg(self._reg_input(img), dtype=self.tower_dtype)[:, self._attr_idx]

    def discriminate(self, img):
        """image NHWC -> D logits ([B, 1]; [B] through a disc_fn)."""
        if self.d is None:
            raise ValueError("this editor was built without a discriminator "
                             "(--no_gan_loss)")
        dt = self.tower_dtype
        return (self._disc_fn(self.d, img, dt) if self._disc_fn is not None
                else self.d(img, dtype=dt))

    # -- the same under inference mode --------------------------------------

    @torch.inference_mode()
    def get_w(self, z):
        return self.latent_of(z)

    @torch.inference_mode()
    def synthesize(self, latent, noise_generator=None):
        """noise_generator (a torch.Generator on the editor's device) draws
        fresh noise; None keeps the stored noise maps."""
        latent = self._tensor(latent)
        noise = (None if noise_generator is None
                 else self.make_noise(latent.shape[0], noise_generator))
        return self.synth(latent, noise)

    @torch.inference_mode()
    def regress(self, img):
        return self.scores(img)

    @torch.inference_mode()
    def regress_all(self, img):
        """image -> every regressor output [B, n_outputs] (eval)."""
        return self.reg(self._reg_input(self._tensor(img)), dtype=self.tower_dtype)

    def unified_alphas(self, alpha_org, sampled):
        """-> (alpha_target, alpha_delta); 'delta' mode clamps the target."""
        if self.cfg.alpha_mode == "delta":
            target = torch.clamp(alpha_org + sampled, 0.0, 1.0)
            return target, target - alpha_org
        return sampled, sampled - alpha_org

    def edit(self, walk_params, latent, alpha, **kw):
        """kw: the embed walk's bank ``name`` and ``index``."""
        return W.apply_walk(self.cfg.walk_kind, walk_params, latent, alpha,
                            layers=self.cfg.layers, **kw)

    def _require_alpha_walk(self, path: str) -> None:
        """The 'embed' walk (WalkEmbed) ignores alpha, so an alpha-driven edit
        over it would render the same image for every alpha; the reference
        has no working inference path for it either. Refuse, as the JAX
        package does."""
        if self.cfg.walk_kind == "embed":
            raise ValueError(
                f"{path} is alpha-driven and the 'embed' walk ignores alpha "
                "(reference WalkEmbed.forward drops it); apply a bank entry "
                "with edit(..., name=<attribute>, index=<bank index>)")

    def _require_w(self, path: str) -> None:
        """The combine paths move single bank columns of a W-space walk; on a
        z editor the JAX package's run them into a shape error."""
        if self.cfg.latent != "w":
            raise ValueError(f"{path} edits W+ (latent 'w'); this editor's "
                             f"latent is {self.cfg.latent!r}")

    def _bank_position(self, index) -> int:
        """Regressor-table attribute id -> column in the trained bank."""
        if index in self.cfg.attr_idx:
            return self.cfg.attr_idx.index(index)
        raise ValueError(
            f"attribute index {index} not in the trained bank "
            f"{self.cfg.attr_idx}"
        )

    # -- inference paths --------------------------------------------------

    @torch.inference_mode()
    def apply_alpha(self, walk_params, z, alpha_to_graph, given_w=None,
                    index=None, u8: bool = False):
        """Inference-time edit: regress the current attribute scores, walk by
        the delta to the requested target, re-synthesize. With ``index`` (a
        regressor-table id) only that bank column moves toward its target.
        u8=True returns uint8 images. In z space the walk takes the requested
        alpha itself, not a delta. -> (edited_img, alpha_org, orig_img)."""
        self._require_alpha_walk("apply_alpha")
        idx_pos = None if index is None else self._bank_position(index)
        ag = self._tensor(alpha_to_graph)
        if ag.dim() == 1:
            ag = ag[:, None]
        latent = self.edit_latent(z, given_w)
        orig = self.synth(latent)
        alpha_org = self.regress(orig)
        if self.cfg.latent == "z":
            walk_alpha = ag
        else:
            walk_alpha = ag - alpha_org
            if idx_pos is not None:
                walk_alpha[:, idx_pos] = (
                    (ag[:, 0] if ag.shape[1] == 1 else ag[:, idx_pos])
                    - alpha_org[:, idx_pos]
                )
        edited = self.synth(self.edit(walk_params, latent, walk_alpha))
        if u8:
            return _u8(edited), alpha_org, _u8(orig)
        return edited, alpha_org, orig

    @torch.inference_mode()
    def _synthesize_stream(self, latents, chunk: int, u8: bool = False):
        """Synthesize [N, ...] latents in chunks of width ``chunk`` into one
        preallocated result, so no more than one chunk's activations are
        alive at a time."""
        n = latents.shape[0]
        buf = None
        for start in range(0, n, chunk):
            img = self.synth(latents[start:start + chunk])
            if u8:
                img = _u8(img)
            if buf is None:
                buf = torch.empty((n,) + img.shape[1:], dtype=img.dtype,
                                  device=img.device)
            buf[start:start + img.shape[0]] = img
        return buf

    @torch.inference_mode()
    def sweep(self, walk_params, z, panel_alphas, given_w=None,
              chunk: int | None = None, u8: bool = False):
        """All-panels edit: panel_alphas [P, B] or [P, B, A] targets ->
        (images [P, B, H, W, 3], alpha_org, orig_img). The P panels fold into
        the batch dimension and synthesize in chunks of ``chunk`` (default
        balanced under SWEEP_CHUNK). In z space the panels' alphas go to the
        walk as they are."""
        self._require_alpha_walk("sweep")
        pa = self._tensor(panel_alphas)
        if pa.dim() == 2:
            pa = pa[:, :, None]
        p, b = int(pa.shape[0]), int(pa.shape[1])
        c = chunk or _balanced_chunk(p * b, SWEEP_CHUNK)
        latent = self.edit_latent(z, given_w)
        orig = self.synth(latent)
        alpha_org = self.regress(orig)
        # W space: the delta to each panel's target
        walk_alpha = pa if self.cfg.latent == "z" else pa - alpha_org[None]
        flat_alpha = walk_alpha.reshape((p * b,) + walk_alpha.shape[2:])
        flat_latent = latent[None].expand((p,) + latent.shape).reshape(
            (p * b,) + latent.shape[1:])
        edited = self.edit(walk_params, flat_latent, flat_alpha)
        imgs = self._synthesize_stream(edited, c, u8=u8)
        return imgs.reshape((p, b) + imgs.shape[1:]), alpha_org, orig

    @torch.inference_mode()
    def apply_alpha_combine(self, walk_params, z, alphas_per_attr, indices,
                            given_w=None):
        """Two-(or N-)attribute combined edit (transform_base.py:769-811): the
        delta starts at zero and only the listed attribute columns move toward
        their targets. alphas_per_attr: [B] or [B, 1] targets aligned with
        ``indices`` (regressor-table ids). -> (edited_img, alpha_org,
        orig_img)."""
        self._require_w("apply_alpha_combine")
        positions = [self._bank_position(i) for i in indices]
        latent = self.edit_latent(z, given_w)
        orig = self.synth(latent)
        alpha_org = self.regress(orig)
        delta = torch.zeros_like(alpha_org)
        for pos, ag in zip(positions, alphas_per_attr):
            delta[:, pos] = self._tensor(ag).reshape(-1) - alpha_org[:, pos]
        edited = self.synth(self.edit(walk_params, latent, delta))
        return edited, alpha_org, orig

    @torch.inference_mode()
    def sweep_combine(self, walk_params, z, panel_alphas, indices,
                      given_w=None, u8: bool = False):
        """All (alpha_i, alpha_j) pairs for a 2-attribute grid
        (transform_base.py:814-869): panel_alphas [P] -> (images [P, P, B, H,
        W, 3], alpha_org, orig_img), the first attribute's target on the
        outer axis. The P*P edited latents synthesize in chunks, as in
        ``sweep``."""
        self._require_w("sweep_combine")
        positions = [self._bank_position(i) for i in indices]
        panels = self._tensor(np.asarray(panel_alphas, np.float32))
        p = panels.shape[0]
        grid = torch.stack([panels.repeat_interleave(p), panels.repeat(p)], 1)  # [P*P, 2]
        latent = self.edit_latent(z, given_w)
        b = latent.shape[0]
        orig = self.synth(latent)
        alpha_org = self.regress(orig)
        n = grid.shape[0]
        delta = torch.zeros((n, b, alpha_org.shape[1]), dtype=alpha_org.dtype,
                            device=self.device)
        for k, pos in enumerate(positions):
            delta[:, :, pos] = grid[:, k, None] - alpha_org[None, :, pos]
        flat_latent = latent[None].expand((n,) + latent.shape).reshape(
            (n * b,) + latent.shape[1:])
        edited = self.edit(walk_params, flat_latent, delta.reshape(n * b, -1))
        imgs = self._synthesize_stream(edited, _balanced_chunk(n * b, SWEEP_CHUNK), u8=u8)
        return imgs.reshape((p, p, b) + imgs.shape[1:]), alpha_org, orig


def bilinear_resize(img, h: int, w: int):
    """NHWC images -> [B, h, w, C], as the JAX package's
    ``jax.image.resize(..., "linear")``: bilinear with half-pixel centres,
    antialiased on a downscale (the triangle filter widened by the scale).
    ``F.interpolate`` with ``antialias=True`` computes that function; it runs
    here on NCHW-contiguous memory, forward and backward, whatever layout the
    caller holds. The result is NHWC-contiguous, as the generator's output."""
    x = img.permute(0, 3, 1, 2).contiguous()
    out = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                        antialias=True)
    return out.permute(0, 2, 3, 1).contiguous()


def clip_ims(ims) -> np.ndarray:
    """[-1, 1] float -> uint8 (transform_base.py:551-552), on the host: the
    reference's name for utils.image.to_uint8."""
    from ..utils.image import to_uint8

    if isinstance(ims, torch.Tensor):
        ims = ims.detach().cpu().numpy()
    return to_uint8(ims)
