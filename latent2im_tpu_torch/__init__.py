"""latent2im_tpu_torch — the PyTorch + CUDA port of latent2im_tpu.

A second package beside the JAX one, which stays as the reference. Module
names mirror ``latent2im_tpu/`` so each counterpart sits at the same path.
The port imports torch, never jax, and nothing of ``latent2im_tpu``: it keeps
its own copies of what it needs. Its entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.

Layout
------
device.py  device resolution (cuda by default, cpu only when asked)
ops/       hand-written CUDA kernels (csrc/) with their plain PyTorch versions
models/    StyleGAN2 generator, ResNet-50 regressor (nn.Modules, NHWC API)
walks/     latent walks (linear_w)
tasks/     per-transform alpha schedules
engine/    the Editor and its builder
io/        parameter carry-over from the JAX package's pytrees
config/    CLI flags and attribute vocabularies
cli/       serve (HTTP edit/sweep)
"""

__version__ = "0.1.0"
