"""latent2im_tpu_torch — the PyTorch + CUDA port of latent2im_tpu.

A second package beside the JAX one, which stays as the reference. Module
names mirror ``latent2im_tpu/`` so each counterpart sits at the same path.
The port imports torch, never jax, and nothing of ``latent2im_tpu``: it keeps
its own copies of what it needs. Its entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.

Layout
------
device.py  device resolution (cuda by default, cpu only when asked)
ops/       hand-written CUDA kernels (csrc/) with their plain PyTorch versions,
           and the image loaders' host C++ (csrc/*.cpp)
models/    StyleGAN2 G and D, StyleGAN1 G, ResNet-50, VGG16/19, FaceNet, PGGAN
           (nn.Modules, NHWC API)
walks/     latent walks (linear_w, mlp_w, nn_w)
tasks/     per-transform alpha schedules
engine/    the Editor built from options, walk training, W+ inversion, eval
io/        checkpoints and parameter carry-over from the JAX package's pytrees
config/    CLI flags and attribute vocabularies
cli/       train, train_multi_attr, vis_w, serve, eval, bp (W+ inversion),
           train_regressor
utils/     PNG and JPEG files, Pillow's resamples, the threaded loader, grids,
           remat
compat.py  the reference's find_model_using_name facade (graphs.py: its alias)
"""

__version__ = "0.1.0"
