#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (latent2im_tpu_torch) on one GPU.

    python3 chip_smoke.py

Two main paths run at full width on seeded random weights (StyleGAN2
style_dim 512, n_mlp 8, channel multiplier 2; ResNet-50/40; Smiling): the
edit server and the walk-training loop, at 256 px (phases 3-10) and at
1024 px (phases 11-15, with the remat and input-size options and the eval
CLI); then the second derivatives a gradient penalty takes (16), W+
inversion and the bp CLI (17-19), the mlp_w/nn_w walks (20), the joint
GAN fine-tune, --updateGAN (21-24), and z-space editing with the PGGAN
backends (25-28), the geometric and color walks with the dsprites
sliders, LPIPS and parity_check (29-32), bf16 compute, --bf16, with the
kernels' bf16 instances (33-37), JPEG input (38), the regressor
trainer, its loader, StyleGAN1 and compat (39-42), data and spatial
parallelism over torch.distributed (43-46), and tensor parallelism with the
styled conv split at its all-reduce, --updateGAN under a mesh and sp of
PGGAN and StyleGAN1 (47-50), the geometric tasks' host targets
(--host_targets, 51), progressive, CMYK and YCCK JPEG (52), WEBP,
arithmetic-coded JPEG, 16-bit and Adam7 PNG (53), the native real-image
path (54), corrupt JPEGs with the rest of the image formats (55), DDS
(BC1-BC7), BLP, FTEX, PSD, JPEG 2000 and ICNS (56), and the legacy
formats (57).
Phases (a failed phase raises, and the script exits non-zero):
  1. the card: nvidia-smi name and power limit, torch and CUDA versions;
  2. build the hand-written kernels from ops/csrc with nvcc (sm_90a);
  3. kernels: each of the five kernels (fused_act, upfirdn2d, styled_conv3x3
     forward; fused_act and upfirdn2d backward) at every shape one 256 px
     apply_alpha (B=4) or one training step (B=4) gives it, held against its
     plain PyTorch version on the card (f32, TF32 off), then timed with CUDA
     events beside its bound, the plain version and one PyTorch library call
     computing the same function, and alone on the device (a CUDA graph of
     ten calls, no host gap); the styled conv's bound is its 3xTF32 work on
     the tensor cores (the f32 CUDA-core bound is logged beside it), with
     the tiling each shape took, and every upfirdn2d shape must take a
     templated form of its kernel;
  4. serving: the edit server (serve_batch 4, 5 panels) answers /healthz,
     /edit of 1 and 4 samples and /sweep over HTTP; the launch counts, set to
     0 just before, must show every request went through the three forward
     kernels;
  5. one apply_alpha (B=4) under torch.profiler: device time by kernel group
     and the device's busy share (trace in chiprun_out/);
  6. the same apply_alpha (B=1, same weights) on cuda and on cpu must agree;
  7. training: train_loop (Smiling, linear_w, B=4, 10*BCE + 0.05*VGG +
     0.05*GAN, Adam) for TRAIN_STEPS steps after a warmup; the launch counts,
     set to 0 just before, must equal TRAIN_STEPS times the per-step counts
     of all five kernels; losses finite, the walk moved;
  8. one training step under torch.profiler, as phase 5;
  9. one training step (128 px, F64_SIZE, B=2, same weights, stored noise,
     host alphas) on cuda and on cpu must agree in loss and walk gradient;
 10. the CLIs (chiprun_out/cli/): cli.train.run (Smiling, B=4, 8 samples,
     2 epochs) with a SIGTERM after its second step, then --resume to the
     final checkpoint, whose walk, and the last epoch's Adam state, must
     reload bit for bit; train_multi_attr (Smiling,Young, one step) through
     its main(); `python -m latent2im_tpu_torch.cli.vis_w` as two processes
     (2 samples x 5 panels; the --combine_indices grid), PNGs and
     index.html; the server with --save_path_w, warmed as its main() warms
     it, whose /edit of 4 must give apply_alpha's uint8 images exactly
     (cuDNN set to deterministic algorithms for this part). The launch
     counts, set to 0 before each
     in-process part, must show all five kernels in training and the three
     forward kernels in serving.
 11. kernels at the 1024 px shapes: phase 3 at 1024 px, B=8 (the styled
     conv at 512^2 x 64 and 1024^2 x 32, each of these thin layers timed
     beside cuDNN's bf16 grouped conv, upfirdn2d and fused_act at every
     site of one edit and one training step);
 12. the 1024 px generator (tests/fullscale_ref.py's seeded full-width
     g_ema, strict) against tests/fixtures/ref_outputs_1024px.npz, relative
     L2 and max-abs within 5e-3 of scale;
 13. the 1024 px edit server (serve_batch 8): apply_alpha at B=8 (CUDA
     events, then once under torch.profiler) and one /edit of 8, counted,
     equal to apply_alpha's uint8 images under deterministic cuDNN;
 14. walk training (B=8, Smiling, linear_w, full towers) under five
     configurations: plain at 1024 px; --remat_g, --remat_g block, --remat_g
     block --remat_towers, --reg_input_size 256 --content_input_size 256 at
     512 px (SIZE_MID, cut from 1024 px for the time budget); G's
     noise weights set to 0.3 (the seeded init's are 0, a trained G's are
     not); per configuration ms per train_loop step (mean and spread),
     samples/s, peak GB, and launch counts equal to the plain step's plus
     one forward of each checkpointed region (remat_extra); each remat
     configuration's step held to the plain 512 px step from the same state,
     alphas and fresh noise (loss terms 1e-5 relative, the walk gradient
     within phase 9's bound, which another noise draw must exceed); one
     plain step under torch.profiler;
 15. `python -m latent2im_tpu_torch.cli.eval` at 256 px on a zero walk,
     whitened, then --ref_parity: eval_report.json's keys,
     identity_is_relative_only, finite numbers in the non-empty buckets;
 16. second derivatives: the gradient wrt D's parameters of the WGAN-GP
     gradient penalty (128 px, full width, B=4), which differentiates the
     backward kernels of fused_act and upfirdn2d, on the card against f64
     on the CPU per parameter (phase 9's form of bound);
 17. W+ inversion (engine/inversion.py) at 256 px, B=4, Adam, 20 loops, of
     images G made: ms per loop, peak GB, the loss falling, launches per
     loop; then 3 loops at B=1 on the card against f64 on the CPU;
 18. the real-image flow: 6 PNGs (G's images, a gray and a palette one),
     `python -m latent2im_tpu_torch.cli.bp` at 256 px, 30 loops, then
     `python -m latent2im_tpu_torch.cli.vis_w --latents_dir` with phase 10's
     walk; every file checked;
 19. W+ inversion at 1024 px, B=4, 5 loops: ms per loop, peak GB;
 20. the mlp_w (--is_mlp) and nn_w (--walk_type NNz) walks: 5 train_loop
     steps each at 256 px, B=4 (ms per step, peak GB, launches equal to
     linear_w's step), a save -> reload -> reference-export round trip, and
     one step on the card against f64 on the CPU (phase 9's bound, which
     also admits 1.5 x the card's own error in the gradient wrt the edited
     W+, that error held within TOWERS_F32_MAX);
 21. --updateGAN at 256 px, B=4, full width: the CLI's provider
     (cli/train.py:_make_gan_provider: a WGAN-GP D step on real PNGs against
     the walk-edited images, a G step through both syntheses and the
     regressor, G's EMA) before each train_loop step; a warmup iteration,
     then 5 counted ones: ms per iteration, per D step and per G step (CUDA
     events), peak GB, launches equal to 5 x the warmup iteration's, all
     five kernels; losses finite, G, D, g_running and G's noise maps moved;
 22. one D step's and one G step's gradient (256 px, full width, B=2, over
     G(z)) on the card against f64 on the CPU per parameter (phase 9's form
     of bound, as phase 16);
 23. one D and one G step at 1024 px through the CLI's g_apply, at B=4 (B=2
     where 4 does not fit): ms, peak GB;
 24. the --updateGAN CLI (PNGs written here, a temporary run directory):
     SIGTERM after epoch 0, --resume (both Adam states restored equal to the
     preempted run's) to model_gan_2_final.ckpt, then `python -m
     latent2im_tpu_torch.cli.vis_w --save_path_gan` on it.
 25. StyleGAN2 in z at 256 px (--latent z --is_mlp, the mlp_z walk), B=4:
     the edit server's /edit of 4 (p50), apply_alpha's device ms, the launch
     counts of both paths (z_serve, z_train: phase 3's, plus the style MLP's
     8 fused_act in both syntheses and its 8 backward in a step, at phase
     3's (4, 512) shape), train_loop (ms per step, peak GB), and one B=2
     step's walk gradient against f64 on the card (the plain versions, as
     phase 22) within max(1e-3, 1.5 x the CPU's f32 error), the card's f32
     under deterministic cuDNN (PGGAN_TOWERS_F32_MAX's comment);
 26. model_256 PGGAN at step 6 (G 256 px, edits 128 px, D on the x2
     re-upsample), full G_LADDER/D_LADDER, B=4: apply_alpha and a sweep
     (ms, peak GB), train_loop for linear_z_free, mlp_z3 and embed
     (--trainEmbed), no launch of the five kernels, and one B=2 step's walk
     gradient against f64 (phase 25's bound, also 1.5 x the card's error
     at the edited z, itself within PGGAN_TOWERS_F32_MAX);
 27. the GAN-zoo PGAN with celebAHQ-512's depths, built through --g_path
     from a seeded zoo-layout state dict written here, --resolution 512:
     apply_alpha and train_loop steps at B=4 (ms, peak GB);
 28. the CLIs on model_256 (chiprun_out/pggan_cli/): train with a SIGTERM
     and --resume, `python -m latent2im_tpu_torch.cli.vis_w` on its walk,
     serve --save_path_w answering one /edit; host-clock seconds.
 29. the seven geometric and color tasks (color, colorlab, zoom, shiftx,
     shifty, rotate2d, rotate3d) at 256 px, full width, linear_w, B=4: per
     task a warmup step and 5 geometric_train_loop steps (ms per step by
     CUDA events, peak GB, launches equal to 5 x one style MLP and two
     syntheses forward plus the edited synthesis backward, no tower), its
     target and mask of G's images on the card against the CPU; zoom with
     --trainEmbed, 3 steps; one B=2 step of zoom and of colorlab on the card
     against f64 on the CPU (phase 9's bound);
 30. zoom at 1024 px, B=8: 3 steps, ms and peak GB, launches as phase 29's;
 31. the geometric CLI (chiprun_out/geo_cli/): train --transform zoom with a
     SIGTERM and --resume, whose walk reloads bit for bit, `python -m
     latent2im_tpu_torch.cli.vis_w` on it, the server answering one /edit,
     --transform dsprites --attrList scale,posx for one epoch through the
     host sampler; host-clock seconds;
 32. parity_check: record on the CPU, compare on the card with the same
     weights and seed, LPIPS with seeded heads written by the phase;
     max-abs, PSNR, LPIPS; images and scores within phase 6's bounds;
 33. the bf16 kernels (the five, bf16 in and out, f32 accumulation) at the
     256 px B=4 and 1024 px B=8 main-path shapes against their plain bf16
     versions (2^-8 of max|ref| for fused_act and upfirdn2d, 2^-7 for the
     styled conv), timed as phase 3, bound at bf16 bytes and the styled
     conv's 989 TFLOP/s dense bf16 rate, library calls in bf16; the styled
     conv's thin form (N = Cout) at 1024^2 x 32 and 512^2 x 64;
 34. the 256 px edit server with --bf16: /edit of 4 (p50, img/s), the
     launches of the f32 path, every one a bf16 instance's but the style
     MLP's; apply_alpha B=4; the bf16 image against the f32 one; card
     against CPU at B=1, both bf16, within 2e-2 relative L2;
 35. apply_alpha at 1024 px in bf16, B=32 (the JAX package's bench
     configuration) and B=8: ms, img/s, peak GB;
 36. train_loop with --bf16 at 256 px B=4 and B=16, at 1024 px B=8; the bf16
     walk gradient against an f64 reference on the card, within 1.5 x the
     distance of the same step through the plain versions (floor 1e-3);
 37. --bf16 through the CLIs (chiprun_out/cli_bf16/): train + SIGTERM +
     --resume, vis_w (python -m), /edit; --updateGAN, 3 iterations (ms per D
     and G step); model_256 PGGAN apply_alpha and one step, no launch.
 38. JPEG input: the fixtures of tests/fixtures/torch_jpeg/ (this machine has
     no Pillow to write one) decoded by utils/image.py:read_image_rgb, each
     equal to its recorded Pillow decode, the host decode ms per photo at
     218x178, 256^2 and 1024^2; `python -m latent2im_tpu_torch.cli.bp` on
     a directory of them at 256 px, then --updateGAN on them as real
     images (a warmup and 2 iterations, counted).
 39. the regressor trainer (cli/train_regressor.py's make_steps): ResNet-50
     with its 40-wide head at 256 px, B=32, train-mode BN, Adam 1e-4, seeded
     weights: 3 warmup and 10 timed steps (CUDA events and the host clock),
     samples/s, peak GB, one step under torch.profiler (the device's busy
     share); 3 steps at B=4 against the CPU, each card step from the CPU's
     state: loss and running statistics within 1e-4 (relative, relative
     L2), the parameters within 2 lr per element;
 40. `python -m latent2im_tpu_torch.cli.train_regressor` on
     tests/fixtures/torch_regressor/ (JPEGs, PNGs, a tab-separated label
     file, training.txt / test.txt), 2 epochs, --export_torch: the print
     lines (the test MSE), the checkpoint names and meta, the msgpack
     restored with Adam's step, the export loaded with strict=True;
 41. the loader: the JPEG decode per photo with the C entry
     (ops/csrc/jpeg_huffman.cpp) and in Python at phase 38's three sizes,
     bit-equal, and with the centre-crop resize (resample.cpp); the threaded
     loader's batches/s at B=32, 256 px (one thread and its pool) against
     phase 39's steps/s, and the trainer fed by it; --updateGAN ms per
     iteration on JPEGs (phase 38) against PNGs (phase 21);
 42. StyleGAN1 (models/stylegan1.py) at full width, step 5 (128 px, B=2,
     with mixing and truncation) and step 8 (1024 px, B=1), card against
     CPU within 1e-4 relative L2; the compat.py call sequence on the card
     (launches counted as path "compat"), its edit equal to apply_alpha's;
 43. the kernels at the row-shard shapes of two spatial ranks at 256 and
     1024 px, B=1 (the blur on halo-extended rows with y pads cropping, the
     skip upsample likewise, fused_act, the styled conv on x with its halo
     rows, the backwards), f32 and bf16, held to their plain versions at the
     gates of phases 3 and 33, the f32 calls timed beside their bounds;
 44. spatial partitioning: two ranks sharing the card over gloo (the
     launcher of parallel/launch.py; the all_gathers and halo swaps of
     CUDA tensors through host copies), StyleGAN2 at 1024 px, B=1, the
     towers and walk replicated
     from rank 0: apply_alpha and a sweep within 1e-5 relative L2 of the
     one-process run on the card, one training step's loss terms within
     2e-4 and walk gradient by phase 9's rule against the same step in f64
     on the card (within max(1e-3, 1.5 x the one-process f32 gradient's
     distance), the f32 noise of a full-width step); ms per edit and step
     by rank and one process, rank 0's collectives per step (ms, calls,
     halo and gather bytes), launches summed over the ranks (path "sp");
     which gloo collectives take CUDA tensors in this build;
 45. data parallelism: the same two ranks at 256 px, 2 samples each,
     against one process at B=4 under the same gates (path "dp");
 46. a one-rank NCCL group, which this process joins, running the dp path
     against the same one-process run (path "dp_nccl"). Two ranks on one card measure overhead, not
     speedup; the NCCL path across cards is not run on one card.
 47. the styled conv's tensor-parallel split, ops.styled_conv3x3_partial
     and ops.styled_conv3x3_epilogue, at the Cin/2 shard of every partner
     conv of the 256 px (B=4) and 1024 px (B=2) models, f32 and bf16, held
     to their plain versions at #5's gates (1e-5 and 2^-7 of max|ref|),
     timed beside their bounds and library calls (cuDNN's grouped conv on
     the shard; F.leaky_relu(acc * d + noise_w * noise + b) * sqrt(2));
 48. the tp training step on two gloo ranks sharing the card (a 1 x 2 data
     x model mesh, G tensor-parallel through frozen_tp_shardings) at full
     width: 256 px B=4 in f32 and bf16, 1024 px B=2 in bf16; the loss terms
     within 1e-6 (f32) or 2^-8 (bf16) relative of the one-process step's,
     the walk gradient by phase 9's rule against the f64 step (the f32
     steps under deterministic cuDNN), ms per step by rank, the
     all-reduces' ms, calls and bytes, launches (path "tp");
 49. --updateGAN on a 2-rank data mesh at 256 px (cli/train.py's provider,
     rank 0's D and G steps, G and D broadcast each iteration): G and D
     equal on both ranks, the broadcast's bytes and ms (path "gan_mesh");
 50. sp of model_256 PGGAN (apply_alpha, B=4) and StyleGAN1 (step 8, B=1)
     on the same two ranks against one process within 1e-5 relative L2.
 51. --host_targets: tasks/cv2_np.py's warps through each task's
     get_target_np on the seeded images of tests/fixtures/torch_host_targets/
     against the cv2 targets and masks recorded there (SHA-256; colorlab
     within 1e-6); the seven tasks at 256 px, full width, linear_w, B=4
     through geometric_train_loop(device_targets=False): a warmup and 3
     steps each (ms per step by CUDA events, the host warp's ms, peak GB,
     launches equal to 3 x geometric_host_step_launches()); one rotate2d
     step (B=2) card against CPU (the CPU half in the worker process): the
     original and its target within phase 6's 1e-3, the mask equal, the
     loss within 1e-3 and the walk gradient by phase 9's rule against f64;
     `train --transform rotate3d --host_targets` for two steps
     (chiprun_out/geo_host_cli/); launches counted as path "host_targets";
 52. the fixtures of tests/fixtures/torch_jpeg_progressive/ (progressive
     gray, 4:4:4, 4:2:2, 4:2:0, an odd size, restart intervals, CMYK
     sequential and progressive, YCCK) decoded in Python and in the host
     C++, each equal to its recorded Pillow decode, decode ms per photo of
     both; the regressor loader's batches of them (C equal to Python);
     `python -m latent2im_tpu_torch.cli.bp` on the 256 px progressive photo
     (path "bp_progressive");
 53. the fixtures of tests/fixtures/torch_image_kinds/ (WEBP lossless,
     lossy, with alpha and animated, and JPEG, arithmetic-coded, lossless
     and block-smoothed progressive, in Python and in the host C++; 16-bit
     and Adam7 PNG),
     each equal to its recorded Pillow decode, decode ms per photo on each
     route; `python -m latent2im_tpu_torch.cli.bp` on a folder of a 256 px
     lossy WEBP, an animated WEBP and a 16-bit PNG (path "bp_image_kinds");
 54. the native path (latent2im_tpu_torch/native/) against the JAX
     extension's recordings (tests/fixtures/torch_native/native.json):
     load_resize in Python and C++, --updateGAN on its stream, the regressor
     CLI on GIF, BMP and TIFF (``_native_phase``);
 55. the corrupt JPEGs of tests/fixtures/torch_jpeg_corrupt/ (libjpeg's
     recovery, ROADMAP C.11) in both modes, in Python and in the host C++,
     against Pillow's and the JAX extension's recordings, decode ms per
     photo; the native Loader over them; the Netpbm, QOI, TGA, PCX, SGI,
     ICO, CUR, DIB and TIFF fixtures of tests/fixtures/torch_image_formats/
     against their Pillow decodes; the regressor CLI on a split of both,
     every batch the JAX trainer's; then ms a photo of read_image_rgb at
     256 and 1024 px over the slowest forms (LZW and deflate TIFF, 16-bit
     and CMYK, CCITT, Netpbm, TGA) and of both JPEG modes over photos with
     overwritten scan bytes (``_corrupt_formats_phase``);
 56. the fixtures of tests/fixtures/torch_image_textures/ (DDS of BC1-BC7,
     masks and palettes, BLP, FTEX, PSD, J2K and JP2 of every tier-2 and
     tier-1 form, ICNS) through read_image_rgb in Python and with the JPEG
     2000 tier-1 in the host C++, each equal to its recorded Pillow decode;
     then ms a photo of read_image_rgb over JPEG 2000 photos (256 px
     reversible and irreversible, Python and C++; 1024 px, C++), a 256 px
     BC7 DDS and a 256 px PSD (``textures_phase``);
 57. the fixtures of tests/fixtures/torch_image_legacy/ (DCX, XBM, XPM,
     MSP, Sun raster, FLI/FLC, FITS, SPIDER, IM, McIdas, GBR, PhotoCD,
     PIXAR, XV thumbnail, IMT, IPTC) through read_image_rgb, each equal to
     its recorded Pillow decode; then ms a photo over a 256 px run-length
     Sun raster, a 256 px FLC whose first frame is BRUN and LC chunks, and
     a 256 px FITS float image (``legacy_phase``).
Phases 4, 13 and 14 also time apply_alpha (256 px B=4, 1024 px B=8) and a
512 px training step (B=8) under cuDNN's default and deterministic
algorithms. The CPU halves of phases 9, 16, 17, 20, 22, 25, 26, 29 and 51
(f32 steps on the CPU and their f64 references) run in two worker processes
of CPU_REF_THREADS threads each while the card runs (CpuReferences). A
`python -m` CLI of a phase runs in this process, as -m runs it (runpy,
``run_module``), but for phase 10's two vis_w processes: a new process
takes ~10 s to import torch and reach the card.
Phase 3 times fused_act's backward as both main paths call it (dx only;
the towers are frozen), and holds its bias gradient apart at one shape.
It prints the seconds of each phase, one line each (from its phase()
call to the next phase's), then one JSON line of the
kernels' numbers (the five f32 rows, the five bf16 rows, "fused_act[bf16]",
..., then the split's four, "styled_conv3x3_partial" ...; every row has a
"tp" path) and, last, the line
{"ok": true, "device": {...}}. Per-shape details go to
chiprun_out/chip_smoke.json. Exits non-zero, printing no result, without a
CUDA device or outside a checkout of the repository.
"""

from __future__ import annotations

import contextlib
import faulthandler
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
# seconds after the start at which every thread's stack goes to stderr, in
# case a run nears its 1200 s limit; a rank's own, after its start
WATCHDOG_S, RANK_WATCHDOG_S = 1080, 300
SIZE, BATCH, PANELS = 256, 4, 5
TRAIN_STEPS, TRAIN_WARMUP, CMP_BATCH = 10, 2, 2
# the resolution of the f64 CPU references of phases 9 and 16: 128 px, a
# block less deep than SIZE, which takes each from ~50 s to a quarter
F64_SIZE = 128
# NVIDIA H100 SXM data sheet (dense): HBM3 bytes/s, f32 on the CUDA cores,
# TF32 on the tensor cores (3xTF32 issues three TF32 products per f32 one)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12  # dense bf16 on the tensor cores
# peak rate of the operations each kernel runs: the styled conv's f32
# multiply-adds run as 3xTF32 on the tensor cores, the others on the CUDA cores
FLOPS = {"styled_conv3x3": TF32_FLOPS / 3}
# the bf16 instances (phase 33): the styled conv's bf16 products at the dense
# bf16 rate; of max|ref| against the plain version on the same bf16 tensors:
# one bf16 ulp where two f32 sums round either side (#1-#4), and for the
# styled conv its f32 accumulation in another order than cuDNN's (#5)
FLOPS_BF16 = {"styled_conv3x3": BF16_FLOPS}
TOL_BF16 = {"fused_act": 2.0 ** -8, "fused_act_bwd": 2.0 ** -8, "upfirdn2d": 2.0 ** -8,
            "upfirdn2d_bwd": 2.0 ** -8, "styled_conv3x3": 2.0 ** -7}
# of max|ref|; the styled conv reads ~4e-6 from its plain version (cuDNN's
# f32, itself 2e-6-4e-6 from f64), a variant without the flush of its
# partial sums ~4e-5 (it failed phase 9's walk gradient)
TOL = {"fused_act": 1e-6, "fused_act_bwd": 1e-6, "upfirdn2d": 1e-5,
       "upfirdn2d_bwd": 1e-5, "styled_conv3x3": 1e-5}
SOURCE = {
    "fused_act": ("latent2im_tpu_torch/ops/csrc/fused_act.cu",
                  "latent2im_tpu/ops/pallas_kernels.py:99"),
    "fused_act_bwd": ("latent2im_tpu_torch/ops/csrc/fused_act.cu",
                      "latent2im_tpu/ops/pallas_kernels.py:122"),
    "upfirdn2d": ("latent2im_tpu_torch/ops/csrc/upfirdn2d.cu",
                  "latent2im_tpu/ops/pallas_kernels.py:296"),
    "upfirdn2d_bwd": ("latent2im_tpu_torch/ops/csrc/upfirdn2d.cu",
                      "latent2im_tpu/ops/pallas_kernels.py:311"),
    "styled_conv3x3": ("latent2im_tpu_torch/ops/csrc/styled_conv3x3.cu",
                       "latent2im_tpu/ops/pair_conv.py:142"),
}
FORWARD = ("fused_act", "upfirdn2d", "styled_conv3x3")


T0 = time.perf_counter()


# (phase, seconds since T0 at its start), in the order the phases ran
PHASE_STARTS = []


def log(*a):
    print(f"[{time.perf_counter() - T0:6.1f} s]", *a, flush=True)


def phase(n, msg: str):
    """Start phase ``n`` (a number, or a label such as "44-45"): log
    ``[n] msg`` and record when it began; stderr gets the phase's number,
    so that its tail says how far a run got."""
    PHASE_STARTS.append((str(n), time.perf_counter() - T0))
    log(f"[{n}] {msg}")
    print(f"chip_smoke: phase {n} at {PHASE_STARTS[-1][1]:.1f} s", file=sys.stderr, flush=True)


def phase_seconds(end: float) -> list:
    """[(phase, seconds)]: each phase's time from its start to the next
    phase's (the last to ``end``, seconds since T0)."""
    marks = PHASE_STARTS + [("end", end)]
    return [(p, marks[i + 1][1] - t) for i, (p, t) in enumerate(marks[:-1])]


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


def determinism_cost(fn, warmup: int = 2, iters: int = 10,
                     turns=("default", "deterministic", "deterministic", "default")) -> dict:
    """fn's median CUDA-event time under cuDNN's default algorithms and under
    deterministic ones (``cudnn.deterministic`` on, ``benchmark`` off),
    measured in ``turns`` -> both means and the cost, deterministic over
    default - 1."""
    import torch

    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    runs = {"default": [], "deterministic": []}
    try:
        for mode in turns:
            torch.backends.cudnn.deterministic = mode == "deterministic"
            torch.backends.cudnn.benchmark = False
            runs[mode].append(time_ms(fn, warmup=warmup, iters=iters))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    d, t = (statistics.mean(runs[k]) for k in ("default", "deterministic"))
    return {"default_ms": d, "deterministic_ms": t, "cost": t / d - 1, "runs": runs}


def device_ms(fn, reps: int = 10, iters: int = 5) -> float:
    """Device time of one call without the host's launch gap: `reps` calls
    captured in one CUDA graph, the graph replayed `iters` times; median per
    call."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay, warmup=1, iters=iters) / reps


def bound_ms(nbytes: float, flops: float, flops_per_s: float = F32_FLOPS) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels at the main path's shapes
# ---------------------------------------------------------------------------


def main_path_shapes(size=SIZE, b=BATCH, mlp: bool = True):
    """{(kernel, case): [launches per apply_alpha, launches per training
    step]} at ``size`` px, batch ``b``. One apply_alpha = one style MLP
    (get_w) + two syntheses; one training step = the same forward, D on the
    edited image, and the backward of the edited synthesis and of D.
    mlp=False leaves out the style MLP's 8 fused_act launches (f32 under
    --bf16, which computes only the towers in bf16).

    Cases: fused_act / fused_act_bwd the shape; upfirdn2d / upfirdn2d_bwd
    (B, H, W, C, up, pad, gain) of the forward call (down is 1 on both
    paths); styled_conv3x3 (B, H, Cin, Cout)."""
    from collections import Counter

    from latent2im_tpu_torch.models.stylegan2 import channel_table

    ch = channel_table(2)
    res = [2 ** i for i in range(3, int(math.log2(size)) + 1)]  # 8 .. size
    serve, train = Counter(), Counter()

    def add(key, n_serve, n_train):
        serve[key] += n_serve
        train[key] += n_train

    # style MLP (8 layers); D's final_linear.0 has the same shape
    n_mlp = 8 if mlp else 0
    add(("fused_act", (b, 512)), n_mlp, n_mlp + 1)
    for r in res:
        # up styled conv (x2 forward), its act and blur backward (edited)
        add(("fused_act", (b, r, r, ch[r])), 2, 2)
        add(("fused_act_bwd", (b, r, r, ch[r])), 0, 1)
        blur = ("upfirdn2d", (b, r + 1, r + 1, ch[r], 1, (1, 1), 4.0))
        skip = ("upfirdn2d", (b, r // 2, r // 2, 3, 2, (2, 1), 4.0))
        for key in (blur, skip):
            add(key, 2, 2)
            add(("upfirdn2d_bwd", key[1]), 0, 1)
        # non-up styled conv: forward x2, backward through fused_act_bwd
        add(("styled_conv3x3", (b, r, ch[r], ch[r])), 2, 2)
        add(("fused_act_bwd", (b, r, r, ch[r])), 0, 1)
    add(("styled_conv3x3", (b, 4, ch[4], ch[4])), 2, 2)
    add(("fused_act_bwd", (b, 4, 4, ch[4])), 0, 1)
    # D on the edited image: from_rgb, per res block conv1, conv2 (after a
    # pad (2, 2) blur) and the 1x1 skip (after a pad (1, 1) blur),
    # final_conv, final_linear.0; each backpropagated once
    d_acts = [(b, size, size, ch[size])]
    for r in reversed(res):
        d_acts += [(b, r, r, ch[r]), (b, r // 2, r // 2, ch[r // 2])]
        for pad in ((2, 2), (1, 1)):
            key = (b, r, r, ch[r], 1, pad, 1.0)
            add(("upfirdn2d", key), 0, 1)
            add(("upfirdn2d_bwd", key), 0, 1)
    d_acts.append((b, 4, 4, ch[4]))
    for shape in d_acts:
        add(("fused_act", shape), 0, 1)
        add(("fused_act_bwd", shape), 0, 1)
    add(("fused_act_bwd", (b, 512)), 0, 1)
    return {key: (serve[key], train[key]) for key in {**serve, **train}}


def _upfirdn_library(x_nhwc, k, up, down, pads):
    """One depthwise cuDNN call computing upfirdn2d (up 1, negative pads
    cropping; or the x2 upsample as a transposed conv, whose pads (2, 1)
    output a row shard's pads (2 - 2r, 1 - 2r) crop)."""
    import torch
    import torch.nn.functional as F

    c = x_nhwc.shape[-1]
    x = x_nhwc.permute(0, 3, 1, 2)
    kh, kw = k.shape
    if up == 1:
        px0, px1, py0, py1 = pads
        wf = torch.flip(k, (0, 1)).expand(c, 1, kh, kw)
        return lambda: F.conv2d(F.pad(x, (px0, px1, py0, py1)), wf, stride=down, groups=c)
    px0, px1, py0, py1 = pads
    assert up == 2 and down == 1 and (px0, px1) == (2, 1) and k.shape == (4, 4)
    assert py0 - py1 == 1 and 0 <= 2 - py0, pads
    ke = k.expand(c, 1, kh, kw)
    oh = 2 * x.shape[2] + py0 + py1 - 3
    return lambda: F.conv_transpose2d(x, ke, stride=2, padding=1,
                                      groups=c)[:, :, 2 - py0:2 - py0 + oh]


def kernel_cases(name, case, gen, dev, dtype=None):
    """-> (kernel call, plain call, library call, bytes, flops, f64 call or
    None, the input tensor). Calls return a tensor or a tuple of tensors;
    the f64 call is the plain version on the same inputs in f64 (the styled
    conv's, in f32). dtype bf16: the activations (and the styled conv's w,
    s, d and noise) in bf16, biases and noise_w f32, the library call in
    bf16, bytes at 2 per bf16 element."""
    import torch
    import torch.nn.functional as F

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.ops.upfirdn2d import out_size

    dtype = dtype or torch.float32
    esz = torch.finfo(dtype).bits // 8

    def randn(*s):
        return torch.randn(s, generator=gen, device=dev)

    def act(*s):
        return randn(*s).to(dtype)

    sqrt2 = math.sqrt(2.0)
    if name == "fused_act":
        shape = case
        x, b = act(*shape), 0.1 * randn(shape[-1])
        n = x.numel()
        return (lambda: ops.fused_leaky_relu(x, b),
                lambda: ops.fused_leaky_relu_plain(x, b),
                lambda: F.leaky_relu(x + b.to(dtype), 0.2) * sqrt2,
                2 * esz * n + 4 * b.numel(), 3 * n, None, x)
    if name == "fused_act_bwd":
        # dx only, as both main paths call it: G, D and the towers are
        # frozen, so no bias gradient is asked for (fused_act_db_check holds
        # db apart)
        shape = case
        g, out = act(*shape), act(*shape)
        n = g.numel()
        return (lambda: ops.fused_leaky_relu_bwd(g, out, bias_grad=False)[0],
                lambda: ops.fused_leaky_relu_bwd_plain(g, out, bias_grad=False)[0],
                lambda: torch.where(out > 0, g, 0.2 * g) * sqrt2,
                3 * esz * n, 2 * n, None, g)
    if name in ("upfirdn2d", "upfirdn2d_bwd"):
        bsz, h, w, c, up, pad, gain = case
        k = torch.as_tensor(ops.make_kernel([1, 3, 3, 1]), device=dev) * gain
        pads = tuple(pad) if len(pad) == 4 else (pad[0], pad[1], pad[0], pad[1])
        pad = pads  # (px0, px1, py0, py1): a row shard's y pads differ
        oh, ow = out_size(h, up, 1, pads[2], pads[3], 4), out_size(w, up, 1, pads[0], pads[1], 4)
        if name == "upfirdn2d":
            x = act(bsz, h, w, c)
            out_n = bsz * oh * ow * c
            return (lambda: ops.upfirdn2d(x, k, up=up, pad=pad),
                    lambda: ops.upfirdn2d_plain(x, k, up=up, pad=pad),
                    _upfirdn_library(x, k.to(dtype), up, 1, pads),
                    esz * (x.numel() + out_n) + 64, 2 * (16 // (up * up)) * out_n, None, x)
        g = act(bsz, oh, ow, c)
        gup, gdown, gpads = ops.transposed_params((4, 4), up, 1, pad, (h, w), (oh, ow))
        kf = torch.flip(k, (0, 1))
        in_n = bsz * h * w * c
        return (lambda: ops.upfirdn2d_bwd(g, k, up, 1, pad, (h, w)),
                lambda: ops.upfirdn2d_plain(g, kf, gup, gdown, gpads),
                _upfirdn_library(g, kf.to(dtype), gup, gdown, gpads),
                esz * (g.numel() + in_n) + 64, 2 * 16 * in_n, None, g)
    bsz, h, wd, cin, cout = case if len(case) == 5 else (case[0], case[1]) + tuple(case[1:])
    x = act(bsz, h, wd, cin)
    w = (randn(3, 3, cin, cout) / math.sqrt(9 * cin)).to(dtype)
    s = (1.0 + 0.2 * randn(bsz, cin)).to(dtype)
    d = torch.rsqrt(s.float().square() @ w.float().square().sum((0, 1)) + 1e-8).to(dtype)
    noise, nw, bias = act(1, h, wd), torch.full((1,), 0.3, device=dev), 0.1 * randn(cout)
    x_nchw = x.permute(0, 3, 1, 2).contiguous()
    w_oihw = w.permute(3, 2, 0, 1).contiguous()

    def library():  # the rosinality grouped-conv form, in x's dtype
        wt = (w_oihw[None].float() * s.float()[:, None, :, None, None]
              * d.float()[:, :, None, None, None]).to(dtype)
        out = F.conv2d(x_nchw.reshape(1, bsz * cin, h, wd),
                       wt.reshape(bsz * cout, cin, 3, 3), padding=1, groups=bsz)
        out = (out.view(bsz, cout, h, wd) + nw.to(dtype) * noise[:, None]
               + bias.to(dtype)[:, None, None])
        return F.leaky_relu(out, 0.2) * sqrt2

    args = (x, w, s, d, noise, nw, bias)
    nbytes = (esz * (x.numel() + w.numel() + s.numel() + d.numel() + noise.numel()
                     + bsz * h * wd * cout) + 4 * (1 + cout))
    f64 = ((lambda: ops.styled_conv3x3_plain(*(a.double() for a in args)))
           if dtype == torch.float32 else None)
    return (lambda: ops.styled_conv3x3(*args), lambda: ops.styled_conv3x3_plain(*args),
            library, nbytes, 2 * bsz * h * wd * 9 * cin * cout, f64, x)


def kernel_variant(name, case, inp, got):
    """The kernel instance a main-path shape takes: the styled conv's form
    (thin: bf16 with Cout <= 64, N = Cout; else tiled), tiling and split
    count, upfirdn2d's form for the launch that read `inp` and wrote `got`
    (which must be a templated one)."""
    from latent2im_tpu_torch import ops

    if name == "styled_conv3x3":
        bsz, h, w, cin, cout = case if len(case) == 5 else (case[0], case[1]) + tuple(case[1:])
        plan = ops.styled_conv3x3_plan(bsz, h, w, cin, cout, inp.dtype)
        return {"form": "thin" if plan["tile"][1] < 128 else "tiled", **plan}
    if name in ("upfirdn2d", "upfirdn2d_bwd"):
        up = case[4]  # the gradient is the op with up and down swapped
        form = ops.upfirdn2d_form(inp, got, (4, 4), *((up, 1) if name == "upfirdn2d"
                                                      else (1, up)))
        if not form.startswith("templated"):
            raise AssertionError(f"{name} {case}: takes the {form} form")
        return form
    return None


def _max_err(got, want):
    """(max abs error, max |reference|) over a result or tuple of results."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    errs = [((a.float() - b.float()).abs().max().item(), b.float().abs().max().item())
            for a, b in zip(got, want)]
    return max(e for e, _ in errs), min(m for _, m in errs)


def fused_act_db_check(gen, dev):
    """The bias gradient of fused_act's backward (dx from the kernel, then a
    sum over rows), which no main path asks for, held against the plain
    version by value at the largest main-path shape; not timed."""
    import torch

    from latent2im_tpu_torch import ops

    shape = (BATCH, SIZE, SIZE, 128)
    g, out = (torch.randn(shape, generator=gen, device=dev) for _ in range(2))
    err, scale = _max_err(ops.fused_leaky_relu_bwd(g, out),
                          ops.fused_leaky_relu_bwd_plain(g, out))
    if not (math.isfinite(err) and err <= TOL["fused_act_bwd"] * scale):
        raise AssertionError(f"fused_act_bwd (dx, db) {shape}: max abs err {err:.3e}")
    log(f"    fused_act_bwd with db {shape}: max abs err {err:.3e} (not timed)")
    return err


def kernel_phase(dev, size=SIZE, batch=BATCH, iters=25, dtype=None):
    """Per kernel, per main path at ``size`` px, batch ``batch``: launches
    and the sums over shapes of launches x (kernel, plain, library, bound)
    ms. Each call is timed as the median of ``iters`` CUDA-event times
    (at SIZE_HI the plain and library calls of 3 after one warmup: they
    take ~0.9 s a pass over its shapes).
    dtype bf16: the bf16 instances at the same shapes (phase 33), the style
    MLP's f32 launches left out, held to TOL_BF16, bound at FLOPS_BF16."""
    import torch

    bf16 = dtype == torch.bfloat16
    tol, flops_of = (TOL_BF16, FLOPS_BF16) if bf16 else (TOL, FLOPS)
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {n: {p: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                       "bound_ms": 0.0, "bytes_ms": 0.0, "ops_ms": 0.0,
                       "device_ms": 0.0, "launches": 0}
                   for p in ("apply_alpha", "train_step")}
               for n in SOURCE}
    max_err = dict.fromkeys(SOURCE, 0.0)
    details = []
    for (name, case), counts in sorted(main_path_shapes(size, batch, mlp=not bf16).items(),
                                       key=str):
        kern, plain, lib, nbytes, flops, f64, inp = kernel_cases(name, case, gen, dev, dtype)
        got = kern()
        torch.cuda.synchronize()
        want = plain()
        err, scale = _max_err(got, want)
        ref = to_f64 = None  # the kernel's and the plain version's error / max|ref| in f64
        if f64 is not None:
            ref = f64()
            to_f64 = {k: (v.double() - ref).abs().max().item() / ref.abs().max().item()
                      for k, v in (("kernel", got), ("plain", want))}
        if got.dtype != want.dtype or not (math.isfinite(err) and err <= tol[name] * scale):
            raise AssertionError(
                f"{name} {case} {got.dtype}: max abs err {err:.3e} > {tol[name]} * "
                f"max|ref| {scale:.3e}")
        max_err[name] = max(max_err[name], err)
        t_k = time_ms(kern, iters=iters)
        t_p, t_l = ((time_ms(f, warmup=1, iters=3) if size == SIZE_HI else
                     time_ms(f, iters=iters)) for f in (plain, lib))
        t_d = device_ms(kern)
        rate = flops_of.get(name, F32_FLOPS)
        b_ms, _ = bound_ms(nbytes, flops, rate)
        f32_ms = bound_ms(nbytes, flops)[0] if rate != F32_FLOPS and not bf16 else None
        variant = kernel_variant(name, case, inp, got)
        lib_bf16 = None
        if name == "styled_conv3x3" and case[3] <= 64:  # a thin layer: beside cuDNN in bf16
            lib_bf16 = t_l if bf16 else time_ms(kernel_cases(
                name, case, torch.Generator(device=dev).manual_seed(1), dev,
                torch.bfloat16)[2], iters=iters)
            log(f"    thin layer {case}: {str(inp.dtype)[6:]} kernel {t_k:.4f} ms (device "
                f"{t_d:.4f}) against cuDNN's bf16 grouped conv {lib_bf16:.4f} ms")
        if variant is not None:
            log(f"    {name} {case}: {variant}; {t_k:.4f} ms (device {t_d:.4f}), "
                f"library {t_l:.4f}, bound {b_ms:.4f}"
                + (f" (f32 CUDA-core bound {f32_ms:.4f})" if f32_ms else ""))
        if to_f64 is not None:
            log(f"    {name} {case}: max error / max|ref| against f64: kernel "
                f"{to_f64['kernel']:.3e}, plain (cuDNN f32) {to_f64['plain']:.3e}")
        details.append({"kernel": name, "size": size, "case": repr(case), "variant": variant,
                        "dtype": str(inp.dtype),
                        "err_to_f64": to_f64,
                        "f32_bound_ms": f32_ms, "library_bf16_ms": lib_bf16,
                        "launches_per_apply_alpha": counts[0],
                        "launches_per_train_step": counts[1],
                        "max_abs_err": err, "max_abs_ref": scale, "ms": t_k,
                        "device_ms": t_d,
                        "plain_ms": t_p, "library_ms": t_l, "bound_ms": b_ms,
                        "bytes": nbytes, "flops": flops})
        for path, n in zip(("apply_alpha", "train_step"), counts):
            r = results[name][path]
            r["ms"] += n * t_k
            r["device_ms"] += n * t_d
            r["plain_ms"] += n * t_p
            r["library_ms"] += n * t_l
            r["bound_ms"] += n * b_ms
            r["bytes_ms"] += n * nbytes / HBM_BYTES_PER_S * 1e3
            r["ops_ms"] += n * flops / rate * 1e3
            r["launches"] += n
        del kern, plain, lib, f64, inp, got, want, ref
    if size == SIZE and not bf16:
        details.append({"kernel": "fused_act_bwd", "case": "with db (not on a main path)",
                        "max_abs_err": fused_act_db_check(gen, dev)})
    torch.cuda.empty_cache()
    for name, paths in results.items():
        for r in paths.values():
            r["bound_by"] = "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations"
        r = paths["train_step"]
        a = paths["apply_alpha"]
        log(f"  {name} ({size} px, B={batch}, {str(dtype or torch.float32)[6:]}): max abs err "
            f"{max_err[name]:.3e}; per training step "
            f"{r['launches']} launches, {r['ms']:.4f} ms (device {r['device_ms']:.4f}, plain "
            f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}; share of bound {r['bound_ms'] / r['ms']:.0%}, "
            f"on the device clock {r['bound_ms'] / r['device_ms']:.0%}); per apply_alpha "
            f"{a['launches']} launches, {a['ms']:.4f} ms")
    return results, max_err, details


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


@contextlib.contextmanager
def serving(service):
    """The edit server on a free localhost port, in a thread -> its URL;
    shut down on exit."""
    from latent2im_tpu_torch.cli.serve import make_server

    srv = make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}"
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


def serve_phase(results, dev):
    import argparse

    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.cli.serve import build_service
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
    with serving(service) as url:
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
        per_alpha = {name: r["apply_alpha"]["launches"] for name, r in results.items()}
        n_chunks = -(-PANELS * BATCH // _balanced_chunk(PANELS * BATCH, SWEEP_CHUNK))
        per_synth = {"fused_act": (per_alpha["fused_act"] - 8) // 2,
                     "upfirdn2d": per_alpha["upfirdn2d"] // 2,
                     "styled_conv3x3": per_alpha["styled_conv3x3"] // 2}
        expect = {k: 2 * per_alpha[k] + (1 + n_chunks) * per_synth.get(k, 0)
                  + (8 if k == "fused_act" else 0) for k in per_alpha}
        log(f"  launches over /healthz + 2 /edit + 1 /sweep: {counts} "
            f"(expected {expect})")
        assert counts == expect, (counts, expect)
        assert all(counts[k] > 0 for k in FORWARD)

        lat, n_img = [], 0
        t_all = time.perf_counter()
        for i in range(10):  # timed to the parsed JSON reply; no client decode
            t = time.perf_counter()
            out = _request(url + "/edit", {"seed": 10 + i, "num_samples": BATCH,
                                           "alpha": 0.7})
            lat.append((time.perf_counter() - t) * 1e3)
            n_img += len(out["images"])
        wall = time.perf_counter() - t_all
    z = np.random.RandomState(0).randn(BATCH, 512).astype(np.float32)
    a = np.full((BATCH,), 0.7, np.float32)
    dev_ms = time_ms(lambda: service.ed.apply_alpha(service.walk, z, a, u8=True),
                     warmup=2, iters=10)
    serve = {"p50_request_ms": statistics.median(lat), "img_per_s": n_img / wall,
             "requests": len(lat), "images": n_img,
             "apply_alpha_b4_device_ms": dev_ms,
             "deterministic_cudnn": determinism_cost(
                 lambda: service.ed.apply_alpha(service.walk, z, a, u8=True))}
    return service, conf, counts, serve


# ---------------------------------------------------------------------------
# phases 5 and 8: where the device time goes
# ---------------------------------------------------------------------------

KERNEL_GROUPS = (  # (group, substrings of the CUDA kernel name), first match
    ("styled_conv3x3 (ours)", ("styled_conv_tc_kernel", "styled_conv_bf16_kernel",
                               "styled_conv_splitk_reduce_kernel")),
    ("upfirdn2d (ours, forward and backward)", ("upfirdn2d_tiled_kernel",)),
    ("fused_act backward (ours)", ("fused_act_bwd_kernel",)),
    ("fused_act (ours)", ("fused_act_kernel",)),
    ("cuDNN/cuBLAS conv + GEMM", ("cudnn", "xmma", "gemm", "conv", "cutlass", "wgrad",
                                  "dgrad", "implicit", "sm90", "sm80")),
    ("PyTorch elementwise/reduce/copy", ("elementwise", "reduce", "copy", "fill",
                                        "index", "cat", "vectorized")),
)


def profile_call(fn, trace_name):
    """fn() once to warm, then once under torch.profiler: device time by
    kernel group and the device's busy share of the host-timed call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(REPO, "chiprun_out", trace_name)
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


def profile_phase(service):
    import numpy as np

    z = np.random.RandomState(1).randn(BATCH, 512).astype(np.float32)
    a = np.full((BATCH,), 0.7, np.float32)
    return profile_call(lambda: service.ed.apply_alpha(service.walk, z, a, u8=True),
                        "apply_alpha_trace.json")


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


# ---------------------------------------------------------------------------
# phases 7-9: walk training
# ---------------------------------------------------------------------------


def train_conf(*flags, size=None, batch=None, root=None, print_opt=False):
    """Training options (Smiling, linear_w) at ``size`` px, batch ``batch``
    (SIZE, BATCH by default); print_opt writes opt.yml under ``root``."""
    from latent2im_tpu_torch.config.options import TrainOptions

    return TrainOptions().parse(
        ["--model", "stylegan_v2_real", "--transform", "face", "--walk_type",
         "linear", "--latent", "w", "--attrList", "Smiling", "--resolution",
         str(size or SIZE), "--batch_size", str(batch or BATCH), "--models_dir",
         root or os.path.join(REPO, "chiprun_out"), "--overwrite_config", *flags],
        print_opt=print_opt)


def train_phase(results, dev):
    """train_loop at B=4: TRAIN_WARMUP steps, then TRAIN_STEPS counted and
    timed steps (losses read back every step, as the training CLI logs)."""
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.engine.train import train_loop
    from latent2im_tpu_torch.tasks.transforms import get_task

    conf = train_conf()
    t0 = time.perf_counter()
    ed, walk, _ = build_editor_from_options(conf)  # cuda: the default
    assert ed.device.type == dev.type and ed.d is not None and ed.vgg is not None
    task = get_task(conf.transform, walk_type=conf.walk_type, nsliders=1)
    run = dict(batch_size=BATCH, n_epochs=1, lr=conf.learning_rate, log_every=1)
    walk, _ = train_loop(ed, task, walk, num_samples=TRAIN_WARMUP * BATCH, **run)
    torch.cuda.synchronize()
    log(f"    editor with D and VGG19 built and {TRAIN_WARMUP} warmup steps in "
        f"{time.perf_counter() - t0:.1f} s")
    w0 = walk["w"].detach().clone()
    metrics = []
    ops.reset_launches()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ev0.record()
    walk, history = train_loop(ed, task, walk, num_samples=TRAIN_STEPS * BATCH, seed=1,
                               on_step=lambda e, i, m, dt, wp: metrics.append(m), **run)
    ev1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    per_step = {n: r["train_step"]["launches"] for n, r in results.items()}
    expect = {n: TRAIN_STEPS * v for n, v in per_step.items()}
    log(f"    launches over {TRAIN_STEPS} steps: {counts} (expected {expect})")
    assert counts == expect, (counts, expect)
    assert len(metrics) == TRAIN_STEPS
    for m in metrics:
        assert all(math.isfinite(v) for v in m.values()), m
    moved = (walk["w"].detach() - w0).abs().max().item()
    assert moved > 0, "the walk did not move"
    train = {"steps": TRAIN_STEPS, "batch": BATCH,
             "step_ms_cuda_events": ev0.elapsed_time(ev1) / TRAIN_STEPS,
             "samples_per_s": TRAIN_STEPS * BATCH / wall,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "walk_max_abs_change": moved, "first": metrics[0], "last": metrics[-1]}
    return ed, walk, task, counts, train


def train_profile_phase(ed, walk, task):
    """One training step (B=4) under torch.profiler."""
    import numpy as np
    import torch

    from latent2im_tpu_torch.engine.train import make_optimizer, make_train_step

    step = make_train_step(ed, task, make_optimizer(walk, 1e-4))
    z = torch.from_numpy(np.random.RandomState(2).randn(BATCH, 512).astype(np.float32))
    gen = torch.Generator(device=ed.device).manual_seed(0)
    return profile_call(lambda: step(walk, z, gen), "train_step_trace.json")


# The f32 towers' error in the gradient wrt the edited W+ at 256 px, B=2,
# against f64: 0.4e-3-2.0e-3 on the card, 0.4e-3-2.5e-3 on the CPU over 9
# draws of z and walk kind (scripts/torch_walk_grad_spread.py on an H100
# 80GB HBM3 at 700 W); a tower fault would reach far beyond this.
TOWERS_F32_MAX = 5e-3


def reference_step(ed, w0, z, sampled, dtype):
    """The step's loss terms, walk gradient (all the walk's tensors,
    flattened) and gradient wrt the edited W+ at walk w0 (a tree of arrays),
    composed here from the towers in ``dtype`` (an independent reference of
    make_train_step's arithmetic; the towers' f32 output casts are undone)."""
    import numpy as np
    import torch

    from latent2im_tpu_torch.engine import losses as L
    from latent2im_tpu_torch.walks import apply_walk, walk_leaves, walk_map

    dev = ed.device
    z, sampled = (torch.as_tensor(a, dtype=dtype, device=dev) for a in (z, sampled))
    w = walk_map(lambda a: torch.as_tensor(a, dtype=dtype, device=dev).requires_grad_(True),
                 w0)
    with torch.no_grad():
        latent = ed.g.style_forward(z)[:, None].expand(-1, ed.cfg.n_latent, -1)
        img_org = ed.g.synthesize(latent).to(dtype)
        alpha_org = ed.reg(img_org)[:, ed._attr_idx].to(dtype)
    if ed.cfg.walk_kind == "linear_w":
        latent_new = latent + torch.einsum("ba,ald->bld", sampled - alpha_org, w["w"])
    else:
        latent_new = apply_walk(ed.cfg.walk_kind, w, latent, sampled - alpha_org,
                                layers=ed.cfg.layers)
    latent_new.retain_grad()
    img_new = ed.g.synthesize(latent_new).to(dtype)
    reg = L.raw_bce(ed.reg(img_new)[:, ed._attr_idx], sampled)
    content = L.content_loss(ed.vgg, img_org, img_new)
    gan = L.gan_loss_from_logits(ed.d(img_new))
    loss = L.combine(reg, content, gan)
    loss.backward()
    terms = {"loss": loss, "reg_loss": reg, "content_loss": content, "gan_loss": gan}
    return ({k: v.item() for k, v in terms.items()},
            np.concatenate([t.grad.double().cpu().numpy().ravel() for t in walk_leaves(w)]),
            latent_new.grad.double().cpu().numpy())


# threads of each of the two workers that compute the CPU references while
# the card runs (the card's process keeps the other two of the machine's 8
# cores)
CPU_REF_THREADS = 3


def _cpu_worker_init():
    import torch

    sys.path.insert(0, REPO)
    torch.set_num_threads(CPU_REF_THREADS)


class CpuReferences:
    """The CPU halves of phases 9, 16, 17, 20, 22, 25, 26, 29 and 51 (f32
    steps on the CPU and f64 references, ~380 s of CPU work), computed in
    two worker processes so that the card's phases run meanwhile: the first
    starts with the script, the second (``start_second``) once the kernels
    are built, so that it does not slow nvcc; each queue holds its jobs in
    the order the phases take them. Each phase takes its half with ``get``
    (waiting if it is not done). ``close`` stops the workers."""

    def __init__(self):
        self.pools, self.jobs, self.waited = [], {}, {}
        self._submit({"train": (train_cpu_side, (), F64_SIZE), "gp": (gp_cpu_side,),
                      "mlp_w": (train_cpu_side, dict(WALK_KINDS)["mlp_w"], SIZE),
                      "z_z": (z_grad_cpu_side, "z"), "z_pggan": (z_grad_cpu_side, "pggan"),
                      "geo_zoom": (geo_grad_cpu_side, "zoom"),
                      "geo_host": (geo_host_cpu_side,)})

    def start_second(self):
        self._submit({"inversion": (inversion_cpu_side,),
                      "nn_w": (train_cpu_side, dict(WALK_KINDS)["nn_w"], SIZE),
                      "gan_grads": (gan_grads_cpu_side,),
                      "geo_colorlab": (geo_grad_cpu_side, "colorlab")})

    def _submit(self, jobs):
        import concurrent.futures
        import multiprocessing

        pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"), initializer=_cpu_worker_init)
        self.pools.append(pool)
        for key, (fn, *args) in jobs.items():
            self.jobs[key] = pool.submit(fn, *args)

    def get(self, key):
        """The result of job ``key``; the seconds this waited for it go to
        ``waited`` and, past a second, to the log."""
        t = time.perf_counter()
        out = self.jobs[key].result()
        self.waited[key] = time.perf_counter() - t
        if self.waited[key] > 1.0:
            log(f"    waited {self.waited[key]:.1f} s for the CPU reference {key!r}")
        return out

    def close(self):
        for job in self.jobs.values():
            job.cancel()
        for pool in self.pools:
            pool.shutdown(wait=True, cancel_futures=True)


def rel_l2(a, b):
    import numpy as np

    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def train_cpu_side(flags=(), size=F64_SIZE):
    """The CPU half of ``train_cpu_phase``: the f32 step on the CPU and the
    f64 reference of the same step (numpy), from the seeded editor of
    ``flags`` at ``size`` px. Runs in the CPU reference worker
    (``CpuReferences``) or in place."""
    import numpy as np
    import torch

    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.engine.train import make_optimizer, make_train_step
    from latent2im_tpu_torch.tasks.transforms import get_task
    from latent2im_tpu_torch.walks import walk_leaves, walk_map

    conf = train_conf("--fixed_noise", *flags, size=size)
    z = np.random.RandomState(8).randn(CMP_BATCH, 512).astype(np.float32)
    sampled, _ = get_task("face").train_alpha_np(np.random.RandomState(9), CMP_BATCH, 1)
    ed, walk, _ = build_editor_from_options(conf, device="cpu")
    w0 = walk_map(lambda t: t.detach().cpu().numpy().copy(), walk)
    for t in walk_leaves(walk):
        t.requires_grad_(True)
    step = make_train_step(ed, None, make_optimizer(walk, conf.learning_rate), host_alpha=True)
    t = time.perf_counter()
    m = step(walk, z, sampled=sampled)
    out = {"metrics": {k: float(v) for k, v in m.items()},
           "grad": np.concatenate([p.grad.detach().numpy().astype(np.float64).ravel()
                                   for p in walk_leaves(walk)]),
           "cpu_step_s": time.perf_counter() - t}
    t = time.perf_counter()
    for m in (ed.g, ed.reg, ed.vgg, ed.d):  # the CPU editor, in f64
        m.double()
    out["ref"] = reference_step(ed, w0, z, sampled, torch.float64)
    out["cpu_f64_reference_s"] = time.perf_counter() - t
    return out


def train_cpu_phase(*flags, towers_term: bool = False, size=F64_SIZE, cpu=None):
    """One step (``size`` px, B=2, stored noise, host alphas) from the same
    seed on cuda and on cpu through make_train_step: loss terms within 1e-3. The walk
    gradient of an f32 step at full width is fixed only to ~1e-3 (rounding
    flips LeakyReLU/ReLU kinks; cuDNN differs run to run), so the card's is
    held to an f64 reference on the CPU, at least as close as the CPU's
    own f32 gradient (x1.5), or within 1e-3. The card's step is also run
    again, through the reference's composition, for its own spread and its
    error in the gradient wrt the edited W+ (the towers' part, which every
    walk kind backpropagates). ``flags`` pick the walk (the linear_w of
    train_conf by default). towers_term also admits 1.5 x that towers'
    error, itself held within TOWERS_F32_MAX: a walk's gradient cannot be
    closer to f64 than the gradient it is fed, and where its edit lands
    decides how many kinks the f32 towers flip. cpu: ``train_cpu_side``'s
    result for the same flags and size (computed here when None)."""
    import numpy as np
    import torch

    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.engine.train import make_optimizer, make_train_step
    from latent2im_tpu_torch.tasks.transforms import get_task
    from latent2im_tpu_torch.walks import walk_leaves, walk_map

    cpu = cpu or train_cpu_side(flags, size)
    conf = train_conf("--fixed_noise", *flags, size=size)
    z = np.random.RandomState(8).randn(CMP_BATCH, 512).astype(np.float32)
    sampled, _ = get_task("face").train_alpha_np(np.random.RandomState(9), CMP_BATCH, 1)
    res, out = {}, {k: cpu[k] for k in ("cpu_step_s", "cpu_f64_reference_s")}
    ed, walk, _ = build_editor_from_options(conf, device="cuda")
    w0 = walk_map(lambda t: t.detach().cpu().numpy().copy(), walk)
    for t in walk_leaves(walk):
        t.requires_grad_(True)
    step = make_train_step(ed, None, make_optimizer(walk, conf.learning_rate), host_alpha=True)
    t = time.perf_counter()
    m = step(walk, z, sampled=sampled)
    res["cuda"] = ({k: float(v) for k, v in m.items()}, np.concatenate(
        [p.grad.detach().cpu().numpy().astype(np.float64).ravel() for p in walk_leaves(walk)]))
    out["cuda_step_s"] = time.perf_counter() - t
    # the card's own spread: the same step again
    res["cuda_again"] = reference_step(ed, w0, z, sampled, torch.float32)
    del step, walk, ed
    ref, ref_grad, ref_latent_grad = cpu["ref"]
    (mg, gg), (mc, gc) = res["cuda"], (cpu["metrics"], cpu["grad"])
    for k in ("loss", "reg_loss", "content_loss", "gan_loss"):
        rel = abs(mg[k] - mc[k]) / max(abs(mc[k]), 1e-30)
        out[f"{k}_rel"] = rel
        assert rel <= 1e-3, (k, mg[k], mc[k])
        assert abs(mc[k] - ref[k]) <= 1e-4 * max(abs(ref[k]), 1e-30), (k, mc[k], ref[k])
    assert np.isfinite(gg).all() and np.abs(gc).max() > 0

    out["walk_grad_rel_l2_card_cpu"] = rel_l2(gg, gc)
    out["walk_grad_rel_l2_card_card"] = rel_l2(res["cuda_again"][1], gg)
    out["walk_grad_rel_l2_card_f64"] = rel_l2(gg, ref_grad)
    out["walk_grad_rel_l2_cpu_f64"] = rel_l2(gc, ref_grad)
    out["latent_grad_rel_l2_card_f64"] = rel_l2(res["cuda_again"][2], ref_latent_grad)
    limit = max(1e-3, 1.5 * out["walk_grad_rel_l2_cpu_f64"],
                1.5 * out["latent_grad_rel_l2_card_f64"] if towers_term else 0.0)
    out["walk_grad_limit"] = limit
    if towers_term:
        assert out["latent_grad_rel_l2_card_f64"] <= TOWERS_F32_MAX, out
    assert out["walk_grad_rel_l2_card_f64"] <= limit, out
    out["loss"] = mc["loss"]
    return out


# ---------------------------------------------------------------------------
# phase 10: the CLI flow
# ---------------------------------------------------------------------------


def _cli_args(root, attrs, samples, epochs, *extra):
    return ["--model", "stylegan_v2_real", "--transform", "face", "--walk_type", "linear",
            "--latent", "w", "--attrList", attrs, "--resolution", str(SIZE),
            "--batch_size", str(BATCH), "--num_samples", str(samples), "--n_epochs",
            str(epochs), "--models_dir", root, "--overwrite_config", *extra]


def _vis_w(*args):
    """`python -m latent2im_tpu_torch.cli.vis_w ...` as a user types it."""
    return subprocess.Popen(
        [sys.executable, "-m", "latent2im_tpu_torch.cli.vis_w", *args], cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO}, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def run_module(module, *args) -> str:
    """``python -m <module> <args>`` in this process: runpy runs the module
    as ``__main__``, as ``-m`` does, with ``sys.argv`` set for it, and
    without the ~10 s a new process takes to import torch and reach the
    card -> what it printed (its tail goes to stderr if it raises)."""
    import gc
    import io
    import runpy

    import torch

    saved, buf = sys.argv, io.StringIO()
    sys.argv = [module, *args]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_module(module, run_name="__main__")
    except BaseException:
        print(buf.getvalue()[-3000:], file=sys.stderr, flush=True)
        raise
    finally:
        sys.argv = saved
    gc.collect()
    torch.cuda.empty_cache()
    return buf.getvalue()


def vis_w_here(out_dir, names, *args):
    """``python -m latent2im_tpu_torch.cli.vis_w <args>`` run in this process
    (``run_module``; phase 10 runs it as processes of their own) -> its
    PNGs in ``out_dir``, checked as ``_check_vis`` checks them."""
    run_module("latent2im_tpu_torch.cli.vis_w", *args, "--output_dir", out_dir)
    return _vis_pngs(out_dir, names)


def _check_vis(proc, out_dir, names):
    try:
        text, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise AssertionError(f"vis_w exited {proc.returncode}:\n{text[-3000:]}")
    return _vis_pngs(out_dir, names)


def _vis_pngs(out_dir, names):
    """The PNGs vis_w wrote in ``out_dir``, one a name prefix of ``names``,
    and its index.html."""
    pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    assert [p[:len(n)] for p, n in zip(pngs, names)] == names, (pngs, names)
    assert len(pngs) == len(names) and os.path.isfile(os.path.join(out_dir, "index.html"))
    return pngs


def cli_phase():
    """The CLIs at 256 px, full width, on the card, in chiprun_out/cli/:
    train (Smiling, SIGTERM after the second step of epoch 0, --resume to
    the final checkpoint), train_multi_attr (Smiling,Young), vis_w as two
    subprocesses (panel sweep; --combine_indices grid), and serve with
    --save_path_w. The launch counts are set to 0 before each in-process part
    and read just after."""
    import base64
    import copy
    import shutil
    import signal

    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.cli import train as tcli
    from latent2im_tpu_torch.cli import train_multi_attr
    from latent2im_tpu_torch.cli.serve import build_service
    from latent2im_tpu_torch.config.options import TrainOptions, VisOptions
    from latent2im_tpu_torch.engine.train import make_optimizer
    from latent2im_tpu_torch.io import checkpoint as ckpt

    root = os.path.join(REPO, "chiprun_out", "cli")
    shutil.rmtree(root, ignore_errors=True)
    out = {"seconds": {}, "launches": {}}
    epoch_end, fired = {}, {"n": 0, "kill": True}
    real_loop = tcli.train_loop

    def loop(*a, **kw):  # SIGTERM after the 2nd step; the epochs' last state
        on_step, on_epoch_end = kw["on_step"], kw["on_epoch_end"]

        def killing_on_step(epoch, i, metrics, dt, wp):
            on_step(epoch, i, metrics, dt, wp)
            fired["n"] += 1
            if fired["kill"] and fired["n"] == 2:
                os.kill(os.getpid(), signal.SIGTERM)

        def recording_on_epoch_end(epoch, wp, st):
            on_epoch_end(epoch, wp, st)
            epoch_end[epoch] = ({k: v.detach().clone() for k, v in wp.items()},
                                copy.deepcopy(st))

        kw.update(on_step=killing_on_step, on_epoch_end=recording_on_epoch_end)
        return real_loop(*a, **kw)

    # train, SIGTERM, --resume
    t0 = time.perf_counter()
    tcli.train_loop = loop
    try:
        ops.reset_launches()
        args = _cli_args(os.path.join(root, "single"), "Smiling", 2 * BATCH, 2,
                         "--model_save_freq", "1")
        opt = TrainOptions().parse(args, print_opt=True)
        tcli.run(opt)  # cuda: the entry point's default
        run_dir = opt.output_dir
        listing = sorted(os.listdir(run_dir))
        resume_from = ckpt.find_resume(run_dir)
        meta = ckpt.load_meta(resume_from)
        assert "model_w_2_final_walk_module.ckpt" not in listing, listing
        assert meta.get("preempted") is True, (resume_from, meta)
        fired["kill"] = False
        walk, history = tcli.run(TrainOptions().parse(args + ["--resume"], print_opt=False))
    finally:
        tcli.train_loop = real_loop
    torch.cuda.synchronize()
    out["launches"]["train"] = ops.launch_counts()
    out["seconds"]["train_sigterm_resume"] = time.perf_counter() - t0
    assert all(v > 0 for v in out["launches"]["train"].values()), out["launches"]
    assert all(math.isfinite(h) for h in history), history
    like = {"w": torch.zeros_like(walk["w"])}
    final_path = os.path.join(run_dir, "model_w_2_final_walk_module.ckpt")
    final, _, _ = ckpt.load_walk(final_path, like)
    assert torch.equal(final["w"], walk["w"].detach()), "final walk differs"
    last_walk, last_state = epoch_end[1]
    w1, st1, _ = ckpt.load_walk(os.path.join(run_dir, "model_w_1_walk_module.ckpt"), like,
                                opt_state_like=make_optimizer(like, 1e-4).state_dict())
    assert torch.equal(w1["w"], last_walk["w"]), "epoch 1 walk differs"
    for key in ("step", "exp_avg", "exp_avg_sq"):
        assert torch.equal(st1["state"][0][key].cpu(), last_state["state"][0][key].cpu()), key
    out.update(preempted_at=os.path.basename(resume_from), preempt_meta=meta,
               resumed_steps=len(history), adam_step=float(st1["state"][0]["step"]),
               run_dir=run_dir, walk_path=final_path)
    del walk, final, w1, st1
    torch.cuda.empty_cache()

    # train_multi_attr, as its main() runs from the command line
    t0 = time.perf_counter()
    multi_args = _cli_args(os.path.join(root, "multi"), "Smiling,Young", BATCH, 1,
                           "--model_save_freq", "0")
    saved_argv = sys.argv
    sys.argv = ["train_multi_attr", *multi_args]
    try:
        ops.reset_launches()
        train_multi_attr.main()
        torch.cuda.synchronize()
        out["launches"]["train_multi_attr"] = ops.launch_counts()
    finally:
        sys.argv = saved_argv
    out["seconds"]["train_multi_attr"] = time.perf_counter() - t0
    assert all(v > 0 for v in out["launches"]["train_multi_attr"].values()), out["launches"]
    multi_dir = TrainOptions().parse(multi_args, print_opt=False).output_dir
    assert len(np.load(os.path.join(multi_dir, "loss_values.npy"))) == 1
    multi_final = os.path.join(multi_dir, "model_w_1_final_walk_module.ckpt")
    torch.cuda.empty_cache()

    # vis_w: the panel sweep and the 2-attribute grid, two processes at once,
    # started here and checked after the server's part below, which runs
    # while they start (their seconds span both)
    t_vis = time.perf_counter()
    vis_dirs = (os.path.join(root, "vis"), os.path.join(root, "vis_combine"))
    procs = [
        _vis_w(os.path.join(run_dir, "opt.yml"), "--save_path_w", final_path,
               "--output_dir", vis_dirs[0], "--num_samples", "2", "--num_panels", "5"),
        _vis_w(os.path.join(multi_dir, "opt.yml"), "--save_path_w", multi_final,
               "--output_dir", vis_dirs[1], "--num_samples", "2", "--num_panels", "5",
               "--combine_indices", "31,39")]  # Smiling, Young
    try:
        # serve the trained walk: /edit of 4 over HTTP against apply_alpha. By
        # default cuDNN may pick algorithms that accumulate in a varying order
        # (G's transposed up convs), so two f32 calls can differ in the last bit
        # and a uint8 rounding boundary fall either side; with deterministic
        # algorithms the images must be equal
        t0 = time.perf_counter()
        torch.backends.cudnn.deterministic = True
        vo = VisOptions()
        vo.parser.add_argument("--serve_batch", type=int, default=BATCH)
        vopt, conf = vo.parse([os.path.join(run_dir, "opt.yml"), "--save_path_w", final_path,
                               "--num_panels", str(PANELS)])
        service = build_service(vopt, conf)
        service.warmup()  # as the server's main() does before it listens
        assert torch.equal(service.walk["w"], last_walk["w"]), "served walk differs"
        z = np.random.RandomState(11).randn(BATCH, 512).astype(np.float32)
        with serving(service) as url:
            ops.reset_launches()
            reply = _request(url + "/edit", {"z": z.tolist(), "alpha": 0.7})
            torch.cuda.synchronize()
            out["launches"]["serve"] = ops.launch_counts()
        out["seconds"]["serve_edit"] = time.perf_counter() - t0
        assert all(out["launches"]["serve"][k] > 0 for k in FORWARD), out["launches"]
        got = np.stack([png_decode(base64.b64decode(b)) for b in reply["images"]])

        def apply_alpha():
            edited, _, _ = service.ed.apply_alpha(
                service.walk, z, np.full(BATCH, 0.7, np.float32), u8=True)
            return edited.cpu().numpy()

        # also against a call from another thread, as the server's handler
        # thread makes it
        box = {}
        worker = threading.Thread(target=lambda: box.update(want=apply_alpha()))
        worker.start()
        worker.join(timeout=600)
        want = apply_alpha()
        torch.backends.cudnn.deterministic = False
        out["edit_vs_apply_alpha"] = {}
        for name, b in (("main_thread", want), ("other_thread", box["want"])):
            assert got.shape == b.shape and got.dtype == b.dtype == np.uint8, (name, b.shape)
            out["edit_vs_apply_alpha"][name] = int((got != b).sum())
        assert not any(out["edit_vs_apply_alpha"].values()), out["edit_vs_apply_alpha"]
        out["vis_pngs"] = (_check_vis(procs[0], vis_dirs[0], ["sample0_", "sample1_"])
                           + _check_vis(procs[1], vis_dirs[1], [
                               "combine_idx31_idx39_sample0", "combine_idx31_idx39_sample1"]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    out["seconds"]["vis_w_two_processes"] = time.perf_counter() - t_vis
    return out


# ---------------------------------------------------------------------------
# phases 11-15: the 1024 px configuration
# ---------------------------------------------------------------------------

SIZE_HI, BATCH_HI, TRAIN_HI_STEPS = 1024, 8, 3
# G's noise weights in phase 14: non-zero, so the edited synthesis's fresh
# noise reaches the gradient that the remat steps are held to
NOISE_WEIGHT = 0.3
# phase 14's remat and input-size configurations run at this size (cut
# from 1024 px to hold the script to its time budget); plain stays at
# SIZE_HI
SIZE_MID = 512
# (name, size, EditorConfig fields, the CLI flags that set them)
TRAIN_HI_CONFIGS = (
    ("plain", SIZE_HI, {}, ()),
    ("remat_g", SIZE_MID, {"remat_g": "all"}, ("--remat_g",)),
    ("remat_g block", SIZE_MID, {"remat_g": "block"}, ("--remat_g", "block")),
    ("remat_g block + remat_towers", SIZE_MID, {"remat_g": "block", "remat_towers": True},
     ("--remat_g", "block", "--remat_towers")),
    ("input sizes 256", SIZE_MID, {"reg_input_size": 256, "content_input_size": 256},
     ("--reg_input_size", "256", "--content_input_size", "256")),
)
# the fixture gates of tests/test_parity_fullscale.py:32-45, of image scale
FIXTURE_REL_L2 = FIXTURE_MAX_ABS_FRAC = 5e-3


def forward_1024_phase(dev):
    """tests/fullscale_ref.py's seeded full-width 1024 px g_ema, loaded with
    strict=True, on the card against the committed torch recording
    tests/fixtures/ref_outputs_1024px.npz (stored noise buffers)."""
    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.models.stylegan2 import Generator

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from fullscale_ref import N_MLP, STYLE_DIM, fixture_z, np_state_dict

    g = Generator(SIZE_HI, STYLE_DIM, N_MLP)
    g.load_state_dict({k: torch.from_numpy(v) for k, v in np_state_dict(SIZE_HI).items()},
                      strict=True)
    g = g.to(dev).eval().requires_grad_(False)
    ref = np.load(os.path.join(REPO, "tests", "fixtures", f"ref_outputs_{SIZE_HI}px.npz"))
    want = ref["images"].astype(np.float32)
    z = torch.from_numpy(fixture_z(SIZE_HI, want.shape[0])).to(dev)
    ops.reset_launches()
    with torch.inference_mode():
        got = g(z).cpu().numpy()
    counts = ops.launch_counts()
    scale = float(np.abs(want).max())
    out = {"rel_l2": float(np.linalg.norm(got - want) / np.linalg.norm(want)),
           "max_abs_frac": float(np.abs(got - want).max() / scale), "images": want.shape[0],
           "launches": counts}
    assert got.shape == want.shape and np.isfinite(got).all(), got.shape
    assert out["rel_l2"] < FIXTURE_REL_L2 and out["max_abs_frac"] < FIXTURE_MAX_ABS_FRAC, out
    assert all(counts[k] > 0 for k in FORWARD), counts
    return out


def edit_1024_phase(results_hi, dev):
    """The 1024 px edit server (serve_batch 8): apply_alpha at B=8 timed with
    CUDA events; one /edit of 8 over HTTP, counted, whose uint8 images must
    be apply_alpha's (cuDNN set to deterministic algorithms, as phase 10)."""
    import argparse
    import base64

    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.cli.serve import build_service

    conf = train_conf(size=SIZE_HI, batch=BATCH_HI)
    opt = argparse.Namespace(save_path_w=None, save_path_gan=None, attrList=None,
                             attrPath="", num_panels=PANELS, min_alpha=0.0,
                             max_alpha=1.0, serve_batch=BATCH_HI)
    t0 = time.perf_counter()
    service = build_service(opt, conf)  # cuda: the entry point's default
    service.warmup()
    torch.cuda.synchronize()
    out = {"build_warmup_s": time.perf_counter() - t0}
    z = np.random.RandomState(21).randn(BATCH_HI, service.dim_z).astype(np.float32)
    a = np.full((BATCH_HI,), 0.7, np.float32)

    def apply_alpha():
        return service.ed.apply_alpha(service.walk, z, a, u8=True)[0]

    out["apply_alpha_b8_device_ms"] = time_ms(apply_alpha, warmup=1, iters=5)
    out["deterministic_cudnn"] = determinism_cost(apply_alpha, warmup=1, iters=5)
    log(f"    apply_alpha B={BATCH_HI} under cuDNN's default and deterministic algorithms: "
        f"{json.dumps(out['deterministic_cudnn'])}")
    out["profile"] = profile_call(apply_alpha, f"apply_alpha_{SIZE_HI}_trace.json")
    torch.backends.cudnn.deterministic = True
    try:
        want = apply_alpha().cpu().numpy()
        with serving(service) as url:
            ops.reset_launches()
            t = time.perf_counter()
            reply = _request(url + "/edit", {"z": z.tolist(), "alpha": 0.7})
            out["edit_request_ms"] = (time.perf_counter() - t) * 1e3
            torch.cuda.synchronize()
            counts = ops.launch_counts()
    finally:
        torch.backends.cudnn.deterministic = False
    got = np.stack([png_decode(base64.b64decode(b)) for b in reply["images"]])
    assert got.shape == (BATCH_HI, SIZE_HI, SIZE_HI, 3) and got.dtype == np.uint8, got.shape
    out["edit_vs_apply_alpha_differing"] = int((got != want).sum())
    expect = {k: r["apply_alpha"]["launches"] for k, r in results_hi.items()}
    out["launches"] = counts
    log(f"    launches over one /edit of {BATCH_HI}: {counts} (expected {expect})")
    assert counts == expect, (counts, expect)
    assert out["edit_vs_apply_alpha_differing"] == 0, out
    return out


def remat_extra(flags, size=SIZE_HI) -> dict:
    """Launches a step's backward adds by recomputing its checkpointed
    regions (utils/remat.py re-runs a whole region): the edited synthesis
    ('all': conv1 and every block; 'block': the blocks), and D."""
    nb = int(math.log2(size)) - 2  # synthesis blocks = D's res blocks
    extra = {"fused_act": 0, "upfirdn2d": 0, "styled_conv3x3": 0}
    if flags.get("remat_g"):
        extra["fused_act"] += nb  # the up convs' activation
        extra["upfirdn2d"] += 2 * nb  # the up convs' blur and to_rgb's skip
        extra["styled_conv3x3"] += nb + (flags["remat_g"] == "all")
    if flags.get("remat_towers"):
        extra["fused_act"] += 2 * nb + 3  # from_rgb, 2 per res block, final conv, linear
        extra["upfirdn2d"] += 2 * nb  # the blurs before each stride-2 conv
    return extra


def train_1024_phase(results_hi, grad_limit, dev):
    """train_loop at B=8 (Smiling, linear_w, full towers) under the five
    configurations of TRAIN_HI_CONFIGS, plain at 1024 px and the others at
    SIZE_MID: a warmup step, then TRAIN_HI_STEPS counted and timed steps
    each; then one step of each remat configuration against the plain step
    at SIZE_MID from the same walk, z, host alphas and seeded noise
    generator. G's noise weights are NOISE_WEIGHT throughout. Saves the
    plain configuration's walk and an opt.yml with the 256 px input sizes
    for phase 15."""
    import dataclasses

    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.engine.editor import Editor
    from latent2im_tpu_torch.engine.train import make_optimizer, make_train_step, train_loop
    from latent2im_tpu_torch.io import checkpoint as ckpt
    from latent2im_tpu_torch.tasks.transforms import get_task

    root = os.path.join(REPO, "chiprun_out", "train1024")
    conf = train_conf(*TRAIN_HI_CONFIGS[-1][3], size=SIZE_HI, batch=BATCH_HI, root=root,
                      print_opt=True)  # writes opt.yml
    bases, w0 = {}, {}
    for size, c in ((SIZE_HI, conf), (SIZE_MID, train_conf(size=SIZE_MID, batch=BATCH_HI))):
        t0 = time.perf_counter()
        bases[size], walk, _ = build_editor_from_options(c)  # cuda: the default
        assert bases[size].d is not None and bases[size].vgg is not None
        log(f"    {size} px editor with D and VGG19 built in {time.perf_counter() - t0:.1f} s")
        with torch.no_grad():
            noise_ws = [p for n, p in bases[size].g.named_parameters()
                        if n.endswith("noise.weight")]
            for p in noise_ws:
                p.fill_(NOISE_WEIGHT)
        assert len(noise_ws) == 2 * int(math.log2(size)) - 3, len(noise_ws)
        w0[size] = walk["w"].detach().clone()
    assert bases[SIZE_HI].cfg.reg_input_size == int(TRAIN_HI_CONFIGS[-1][3][1])
    task = get_task("face")
    lr = conf.learning_rate
    per_step = {SIZE_HI: {n: r["train_step"]["launches"] for n, r in results_hi.items()},
                SIZE_MID: {n: 0 for n in SOURCE}}
    for (n, _), (_, per_train) in main_path_shapes(SIZE_MID, BATCH_HI).items():
        per_step[SIZE_MID][n] += per_train

    def editor(fields, size=SIZE_MID):
        base = bases[size]
        cfg = dataclasses.replace(base.cfg, **{"reg_input_size": None,
                                               "content_input_size": None, **fields})
        return Editor(cfg, base.g, base.reg, base.device, vgg=base.vgg, d=base.d)

    out = {"configs": {}}
    for name, size, fields, flags in TRAIN_HI_CONFIGS:
        ed = editor(fields, size)
        wp = {"w": w0[size].clone()}
        run = dict(batch_size=BATCH_HI, n_epochs=1, lr=lr, log_every=1)
        wp, _ = train_loop(ed, task, wp, num_samples=BATCH_HI, **run)  # warmup
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        metrics, step_s = [], []
        ops.reset_launches()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        ev0.record()
        wp, _ = train_loop(ed, task, wp, num_samples=TRAIN_HI_STEPS * BATCH_HI, seed=1,
                           on_step=lambda e, i, m, dt, w: (metrics.append(m),
                                                            step_s.append(dt)), **run)
        ev1.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        extra = remat_extra(fields, size)
        expect = {k: TRAIN_HI_STEPS * (v + extra.get(k, 0)) for k, v in per_step[size].items()}
        assert counts == expect, (name, counts, expect)
        assert len(metrics) == TRAIN_HI_STEPS and all(
            math.isfinite(v) for m in metrics for v in m.values()), metrics
        r = {"flags": " ".join(flags), "size": size, "steps": TRAIN_HI_STEPS, "batch": BATCH_HI,
             "step_ms_cuda_events": ev0.elapsed_time(ev1) / TRAIN_HI_STEPS,
             # each step's wall time up to reading its metrics (synchronising)
             "step_ms_wall": [dt * 1e3 for dt in step_s],
             "samples_per_s": TRAIN_HI_STEPS * BATCH_HI / wall,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": counts, "recompute_launches_per_step": extra,
             "last": metrics[-1]}
        out["configs"][name] = r
        log(f"    {name} ({size} px): {r['step_ms_cuda_events']:.1f} ms per step (wall per step "
            f"{min(r['step_ms_wall']):.1f}-{max(r['step_ms_wall']):.1f}), "
            f"{r['samples_per_s']:.2f} samples/s, peak {r['peak_mem_gb']:.2f} GB, "
            f"launches {counts} (recompute per step {extra})")
        if size == SIZE_HI:
            walk = wp  # the walk phase 15 evaluates
        del ed
        torch.cuda.empty_cache()

    # remat against plain from the same state at SIZE_MID: one
    # make_train_step step each, host alphas, so the seeded generator draws
    # only the noise
    rng = np.random.RandomState(22)
    z = torch.from_numpy(rng.randn(BATCH_HI, bases[SIZE_MID].cfg.dim_z)
                         .astype(np.float32))
    sampled, _ = task.train_alpha_np(rng, BATCH_HI, len(bases[SIZE_MID].cfg.attr_list))

    def one_step(fields, noise_seed=5):
        w = {"w": w0[SIZE_MID].clone().requires_grad_(True)}
        step = make_train_step(editor(fields), task, make_optimizer(w, lr), host_alpha=True)
        m = step(w, z, torch.Generator(device=dev).manual_seed(noise_seed), sampled)
        terms = {k: float(m[k]) for k in ("loss", "reg_loss", "content_loss", "gan_loss")}
        grad = w["w"].grad.double().cpu().numpy()
        torch.cuda.empty_cache()
        return terms, grad

    # at SIZE_MID (a deterministic 1024 px step took 25.8 s on an H100 at
    # 700 W); one turn each
    w = {"w": w0[SIZE_MID].clone().requires_grad_(True)}
    step = make_train_step(editor({}), task, make_optimizer(w, lr), host_alpha=True)
    out["deterministic_cudnn"] = determinism_cost(
        lambda: step(w, z, torch.Generator(device=dev).manual_seed(5), sampled),
        warmup=1, iters=1, turns=("default", "deterministic"))
    log(f"    one plain {SIZE_MID} px step under cuDNN's default and deterministic algorithms: "
        f"{json.dumps(out['deterministic_cudnn'])}")
    del step, w
    torch.cuda.empty_cache()
    plain_terms, plain_grad = one_step({})
    again_terms, again_grad = one_step({})
    _, other_noise_grad = one_step({}, noise_seed=7)
    w = {"w": w0[SIZE_HI].clone().requires_grad_(True)}
    step = make_train_step(editor({}, SIZE_HI), task, make_optimizer(w, lr))
    out["profile"] = profile_call(
        lambda: step(w, z, torch.Generator(device=dev).manual_seed(6)),
        f"train_step_{SIZE_HI}_trace.json")
    del step, w
    out["plain_vs_plain"] = {"grad_rel_l2": rel_l2(again_grad, plain_grad),
                             "terms_rel": {k: abs(again_terms[k] - v) / abs(v)
                                           for k, v in plain_terms.items()}}
    # a remat step whose recompute drew other noise would be this far off
    out["other_noise_vs_plain"] = {"grad_rel_l2": rel_l2(other_noise_grad, plain_grad)}
    assert out["other_noise_vs_plain"]["grad_rel_l2"] > grad_limit, out
    out["remat_vs_plain"] = {"grad_limit": grad_limit, "size": SIZE_MID}
    for name, _, fields, _ in TRAIN_HI_CONFIGS[1:4]:
        terms, grad = one_step(fields)
        cmp_ = {"grad_rel_l2": rel_l2(grad, plain_grad),
                "terms_rel": {k: abs(terms[k] - v) / abs(v) for k, v in plain_terms.items()}}
        out["remat_vs_plain"][name] = cmp_
        assert all(v <= 1e-5 for v in cmp_["terms_rel"].values()), (name, cmp_)
        assert cmp_["grad_rel_l2"] <= grad_limit, (name, cmp_, grad_limit)
    out["plain_terms"] = plain_terms
    out["walk_path"] = ckpt.save_walk(conf.output_dir, 1, walk, final=True)
    out["opt_yml"] = os.path.join(conf.output_dir, "opt.yml")
    return out


def eval_phase(opt_yml, walk_path):
    """`python -m latent2im_tpu_torch.cli.eval` on a saved walk (a 256 px
    one since PR 17, ``eval_256_walk``; phase 14's 1024 px one before), run
    in this process (``run_module``), one after the other: whitened and
    --ref_parity preprocessing."""
    root = os.path.join(REPO, "chiprun_out", "eval")
    runs = {"whitened": (), "reference": ("--ref_parity",)}
    out = {}
    for mode, extra in runs.items():
        run_module("latent2im_tpu_torch.cli.eval", opt_yml, "--save_path_w", walk_path,
                   "--num_samples", str(BATCH_HI), "--output_dir", os.path.join(root, mode),
                   *extra)
        with open(os.path.join(root, mode, "eval_report.json")) as f:
            report = json.load(f)
        assert set(report) == {"embedding", "embedding_preprocess",
                               "identity_is_relative_only", "results"}, report.keys()
        assert report["embedding"] == "vgg-fallback", report
        assert report["embedding_preprocess"] == mode, report
        assert report["identity_is_relative_only"] is True, report
        res = report["results"]["Smiling"]
        counts = res["bucket_counts"]
        assert len(counts) == 3 and 0 < sum(counts) <= 10 * BATCH_HI, res
        for key in ("identity_preservation", "attribute_preservation"):
            for n, v in zip(counts, res[key]):  # nan exactly where a bucket is empty
                assert (n > 0) == math.isfinite(v), (mode, key, res)
        out[mode] = res
    return out


def eval_256_walk():
    """Phase 15's input: a run directory at SIZE px (opt.yml) and a zero
    linear_w walk saved in it -> (opt.yml, the walk). On the random towers
    a walk trained at 256 px (phase 10's) moved every sample's target score
    by more than the last bucket's 1.0 (PR 17, run 1), so the buckets came
    out empty; a zero walk puts every sample in the first."""
    import torch

    from latent2im_tpu_torch.io import checkpoint as ckpt

    conf = train_conf(size=SIZE, batch=BATCH_HI, root=os.path.join(REPO, "chiprun_out", "eval"),
                      print_opt=True)
    walk = {"w": torch.zeros(1, 2 * int(math.log2(SIZE)) - 2, 512)}
    return (os.path.join(conf.output_dir, "opt.yml"),
            ckpt.save_walk(conf.output_dir, 1, walk, final=True))


def hi_phases(card, dev, grad_limit):
    """Phases 11-15 -> the 1024 px kernel results, their launches per path
    and the phases' reports; phase 15 runs the eval CLI at SIZE px."""
    import torch

    phase(11, f"kernels against their plain versions at the {SIZE_HI} px B={BATCH_HI} "
          "shapes of apply_alpha and of a training step")
    results, max_err, details = kernel_phase(dev, SIZE_HI, BATCH_HI, iters=10)
    out = {"results": results, "max_err": max_err, "details": details, "launches": {}}

    phase(12, f"the {SIZE_HI} px generator against tests/fixtures/ref_outputs_{SIZE_HI}px.npz")
    out["forward"] = forward_1024_phase(dev)
    out["launches"]["forward_1024"] = out["forward"].pop("launches")
    log(f"    {out['forward']}")
    torch.cuda.empty_cache()

    phase(13, f"the {SIZE_HI} px edit server: apply_alpha B={BATCH_HI}, one /edit")
    out["edit"] = edit_1024_phase(results, dev)
    out["launches"]["serve_1024"] = out["edit"].pop("launches")
    log(f"    apply_alpha B={BATCH_HI} under torch.profiler: {json.dumps(out['edit']['profile'])}")
    log(f"    apply_alpha B={BATCH_HI} {out['edit']['apply_alpha_b8_device_ms']:.2f} ms "
        f"(CUDA events), /edit {out['edit']['edit_request_ms']:.1f} ms, uint8 values "
        f"where /edit differs from apply_alpha {out['edit']['edit_vs_apply_alpha_differing']}"
        f", on {card}")
    torch.cuda.empty_cache()

    phase(14, f"{SIZE_HI} px walk training, train_loop B={BATCH_HI}, five configurations")
    train = train_1024_phase(results, grad_limit, dev)
    out["launches"]["train_1024"] = {
        k: sum(c["launches"][k] for c in train["configs"].values()) for k in SOURCE}
    out["train"] = train
    log(f"    remat against plain: {json.dumps(train['remat_vs_plain'])}; plain against "
        f"itself {json.dumps(train['plain_vs_plain'])}; plain with another noise draw "
        f"{json.dumps(train['other_noise_vs_plain'])}, on {card}")
    log(f"    one plain step under torch.profiler: {json.dumps(train['profile'])}")
    torch.cuda.empty_cache()

    phase(15, f"python -m latent2im_tpu_torch.cli.eval at {SIZE} px (a zero walk), "
          "whitened and --ref_parity")
    t = time.perf_counter()
    out["eval"] = eval_phase(*eval_256_walk())
    out["eval"]["seconds"] = time.perf_counter() - t
    log(f"    {json.dumps(out['eval'])}")
    return out


# ---------------------------------------------------------------------------
# phases 16-20: second derivatives, W+ inversion, the mlp_w and nn_w walks
# ---------------------------------------------------------------------------

GP_WEIGHT = 10.0
# inversion: loops at 256 px (phase 17), in the CLI (18), at 1024 px (19),
# and of the B=1 comparison with f64; Adam's lr (the CLI's default 1e-4
# moves W+ too little in 20 loops to show the loss fall)
# INV_CMP_LOOPS: the inversion steps held to f64 on the CPU, one (each f64
# loop on the CPU costs ~10 s of the script's time budget); Adam's first
# step moves each element by lr x sign(g), so the step's W+ gradient is
# held to f64 as well
INV_LOOPS, INV_CLI_LOOPS, INV_HI_LOOPS, INV_CMP_LOOPS, INV_LR = 20, 30, 5, 1, 1e-2
WALK_STEPS = 5
WALK_KINDS = (("mlp_w", ("--is_mlp",)), ("nn_w", ("--walk_type", "NNz")))
GP_PATH = ("fused_act", "fused_act_bwd", "upfirdn2d", "upfirdn2d_bwd")


def gradient_penalty(d, x_hat):
    """10 * mean_b((|grad_x sum D(x_hat)|_b - 1)^2): the penalty term of the
    JAX package's engine/gan.py:_d_loss, which differentiates D twice."""
    import torch

    x = x_hat.detach().requires_grad_(True)
    (gx,) = torch.autograd.grad(d(x).sum(), x, create_graph=True)
    norms = torch.sqrt(gx.square().sum((1, 2, 3)) + 1e-12)
    return GP_WEIGHT * (norms - 1.0).square().mean()


def gp_grads(d, x_hat):
    """-> (penalty, {parameter: its gradient as f64 numpy}); zeros where a
    parameter does not reach grad_x D (the last layer's bias)."""
    import numpy as np
    import torch

    gp = gradient_penalty(d, x_hat)
    names, params = zip(*d.named_parameters())
    grads = torch.autograd.grad(gp, params, allow_unused=True)
    return gp.item(), {n: np.zeros(tuple(p.shape)) if g is None else g.double().cpu().numpy()
                       for n, p, g in zip(names, params, grads)}


def _gp_inputs():
    """Phase 16's seeded D (F64_SIZE px, biases off zero) and x_hat."""
    import numpy as np
    import torch

    from latent2im_tpu_torch.models.stylegan2 import Discriminator

    gen = torch.Generator().manual_seed(16)
    d = Discriminator(F64_SIZE, generator=gen)
    with torch.no_grad():
        for name, p in d.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    rng = np.random.RandomState(16)
    real, fake = (rng.randn(BATCH, F64_SIZE, F64_SIZE, 3).astype(np.float32)
                  for _ in range(2))
    eps = rng.uniform(size=(BATCH, 1, 1, 1)).astype(np.float32)
    return d, torch.from_numpy(eps * real + (1.0 - eps) * fake)


def gp_cpu_side():
    """The CPU half of ``gp_phase``: the penalty and its gradient in f32 and
    in f64 on the CPU -> (gp f32, grads f32, gp f64, grads f64, seconds)."""
    import copy

    d, x_hat = _gp_inputs()
    t = time.perf_counter()
    gp_cpu, g_cpu = gp_grads(d, x_hat)
    gp_f64, g_f64 = gp_grads(copy.deepcopy(d).double(), x_hat.double())
    return gp_cpu, g_cpu, gp_f64, g_f64, time.perf_counter() - t


def gp_phase(dev, enforce: bool = True, cpu=None):
    """The gradient of the gradient penalty wrt D's parameters at F64_SIZE
    px, full width, B=4 (seeded weights, biases off zero): on the card, and in
    f32 on the CPU, each against f64 on the CPU, per parameter by relative
    L2, the card held to max(1e-3, 1.5 x the CPU f32 error) (phase 9's
    form). enforce=False only reports, for a tree whose backward kernels
    drop the second-order terms. cpu: ``gp_cpu_side()``'s result (computed
    here when None)."""
    import copy

    import numpy as np
    import torch

    from latent2im_tpu_torch import ops

    d, x_hat = _gp_inputs()
    d_card = copy.deepcopy(d).to(dev)
    gp_grads(d_card, x_hat.to(dev))  # warm
    torch.cuda.synchronize()
    ops.reset_launches()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    gp_card, g_card = gp_grads(d_card, x_hat.to(dev))
    ev1.record()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    gp_cpu, g_cpu, gp_f64, g_f64, cpu_s = cpu or gp_cpu_side()
    out = {"card_ms": ev0.elapsed_time(ev1), "cpu_s": cpu_s,
           "gp": {"card": gp_card, "cpu_f32": gp_cpu, "cpu_f64": gp_f64},
           "launches": counts, "groups": {}}
    scale = max(np.abs(g).max() for g in g_f64.values())
    for name, ref in g_f64.items():
        if not ref.any():  # exact zeros in f64: the card's must be at rounding level
            out["groups"][name] = {"zero": True, "card_max_abs": float(np.abs(g_card[name]).max())}
            if enforce:
                assert out["groups"][name]["card_max_abs"] <= 1e-6 * scale, (name, out)
            continue
        card, cpu = rel_l2(g_card[name], ref), rel_l2(g_cpu[name], ref)
        out["groups"][name] = {"card": card, "cpu_f32": cpu, "bound": max(1e-3, 1.5 * cpu)}
    ratios = [(r["card"] / r["bound"], n) for n, r in out["groups"].items() if "card" in r]
    out["worst"] = {"card_over_bound": max(ratios)[0], "group": max(ratios)[1],
                    "card_rel_l2_max": max(r["card"] for r in out["groups"].values()
                                           if "card" in r)}
    if enforce:
        assert max(ratios)[0] <= 1.0, out
        assert abs(gp_card - gp_f64) <= 1e-4 * abs(gp_f64), out["gp"]
        assert all(counts[k] > 0 for k in GP_PATH), counts
    return out


def inversion_towers(size, seed: int = 17):
    """A seeded full-width G (style dim 512, 8 MLP layers, the rosinality
    channels) and VGG16, on the CPU."""
    import torch

    from latent2im_tpu_torch.models.stylegan2 import Generator
    from latent2im_tpu_torch.models.vgg import VGG16Features

    return (Generator(size, 512, 8, generator=torch.Generator().manual_seed(seed)),
            VGG16Features(generator=torch.Generator().manual_seed(seed + 1)))


def g_images(g, n: int, seed: int):
    """Images G makes from n seeded z, one W per sample, stored noise."""
    import numpy as np
    import torch

    dev = next(g.parameters()).device
    z = torch.from_numpy(np.random.RandomState(seed).randn(n, g.style_dim)
                         .astype(np.float32)).to(dev)
    with torch.no_grad():
        return g.synthesize(g.style_forward(z)[:, None].expand(-1, g.n_latent, -1))


def inversion_phase(dev, size, batch, loops):
    """W+ inversion (Adam, lr INV_LR) of images G made, as engine.inversion.
    invert runs it: init_w (the mean latent over 4096 z), the target's grams
    once, then ``loops`` steps with the loss kept on the device; one warm
    step first, uncounted. Launches over the whole inversion (counts set to
    0 just before init_w), per loop, ms per loop (CUDA events) and the peak
    memory of the loops."""
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.engine.inversion import make_inverter, target_grams

    g, vgg16 = inversion_towers(size)
    init_w, step, optimizer = make_inverter(g, vgg16, g.n_latent, lr=INV_LR, device=dev)
    target = g_images(g, batch, seed=18)
    gen = torch.Generator(device=dev).manual_seed(0)
    w = init_w(batch, gen).requires_grad_(True)
    step(w, optimizer(w), target)  # warm
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    w = init_w(batch, gen.manual_seed(0)).requires_grad_(True)
    state, grams = optimizer(w), target_grams(vgg16, target)
    init = ops.launch_counts()
    history = torch.empty(loops, device=dev)
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    for i in range(loops):
        w, state, loss, _ = step(w, state, target, grams)
        history[i] = loss
    ev1.record()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    hist = history.double().cpu().tolist()
    per_loop = {k: (counts[k] - init[k]) / loops for k in counts}
    out = {"size": size, "batch": batch, "loops": loops, "lr": INV_LR,
           "ms_per_loop": ev0.elapsed_time(ev1) / loops,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss_first": hist[0], "loss_last": hist[-1], "launches": counts,
           "launches_init": init, "launches_per_loop": per_loop}
    assert all(math.isfinite(v) for v in hist) and hist[-1] < hist[0], hist
    assert all(v == int(v) and v > 0 for v in per_loop.values()), out
    del g, vgg16, w, state, target, grams
    torch.cuda.empty_cache()
    return out


def inversion_cpu_side():
    """The CPU half of ``inversion_cpu_phase`` (the CpuReferences worker):
    the starting W+ (init_w over 4096 seeded z) and G's target, then
    INV_CMP_LOOPS steps from them in f32 and in f64 on the CPU -> {"w0",
    "target", "runs": {name: (W+ moved, the last W+ gradient, the loss
    history)}, "<name>_s"}."""
    import copy

    import numpy as np
    import torch

    from latent2im_tpu_torch.engine.inversion import make_inverter

    g, vgg16 = inversion_towers(SIZE)
    target = g_images(g, 1, seed=19)
    z = np.random.RandomState(20).randn(4096, 512).astype(np.float32)
    w0 = make_inverter(copy.deepcopy(g), copy.deepcopy(vgg16), g.n_latent,
                       device="cpu")[0](1, z=z).numpy()
    out = {"w0": w0, "target": target.numpy(), "runs": {}}
    for name, dtype in (("cpu_f32", torch.float32), ("cpu_f64", torch.float64)):
        out["runs"][name], out[f"{name}_s"] = inversion_run(g, vgg16, w0, target, "cpu", dtype)
    return out


def inversion_run(g, vgg16, w0, target, device, dtype):
    """INV_CMP_LOOPS inversion steps of copies of ``g`` and ``vgg16`` on
    ``device`` in ``dtype`` from W+ ``w0`` towards ``target`` -> ((W+ moved,
    the last step's W+ gradient, the loss history), seconds)."""
    import copy

    import numpy as np
    import torch

    from latent2im_tpu_torch.engine.inversion import make_inverter

    t = time.perf_counter()
    gd, vd = (copy.deepcopy(m).to(dtype) for m in (g, vgg16))
    _, step, optimizer = make_inverter(gd, vd, g.n_latent, lr=INV_LR, device=device)
    w = torch.tensor(w0, dtype=dtype, device=device).requires_grad_(True)
    tgt, state, hist = torch.as_tensor(target).to(device, dtype), optimizer(w), []
    for _ in range(INV_CMP_LOOPS):
        w, state, loss, _ = step(w, state, tgt)
        hist.append(loss.item())
    run = (w.detach().double().cpu().numpy() - w0, w.grad.double().cpu().numpy(),
           np.asarray(hist))  # step keeps w.grad
    return run, time.perf_counter() - t


def inversion_cpu_phase(dev, cpu=None):
    """INV_CMP_LOOPS inversion steps at 256 px, B=1, from the same W+ and
    target, on the card, in f32 on the CPU and in f64 on the CPU: the
    movement of W+, the last step's W+ gradient and the loss history of
    each against f64, the card's movement and gradient each held to
    max(1e-3, 1.5 x the CPU f32 error) (phase 9's form). cpu:
    ``inversion_cpu_side``'s result (computed here when None), whose W+ and
    target the card's steps start from."""
    import numpy as np
    import torch

    cpu = cpu or inversion_cpu_side()
    g, vgg16 = inversion_towers(SIZE)
    runs, out = dict(cpu["runs"]), {k: cpu[k] for k in ("cpu_f32_s", "cpu_f64_s")}
    runs["card"], out["card_s"] = inversion_run(g, vgg16, cpu["w0"], cpu["target"], dev,
                                                torch.float32)
    (mc, gc, hc), (mf, gf, hf), (m64, g64, h64) = (runs[k] for k in ("card", "cpu_f32",
                                                                     "cpu_f64"))
    out.update(moved_rel_l2_card_f64=rel_l2(mc, m64), moved_rel_l2_cpu_f64=rel_l2(mf, m64),
               grad_rel_l2_card_f64=rel_l2(gc, g64), grad_rel_l2_cpu_f64=rel_l2(gf, g64),
               loss_rel_card_f64=float(np.abs(hc - h64).max() / np.abs(h64).max()),
               loss_rel_cpu_f64=float(np.abs(hf - h64).max() / np.abs(h64).max()))
    out["limit"] = max(1e-3, 1.5 * out["moved_rel_l2_cpu_f64"])
    out["grad_limit"] = max(1e-3, 1.5 * out["grad_rel_l2_cpu_f64"])
    assert np.abs(m64).max() > 0 and out["moved_rel_l2_card_f64"] <= out["limit"], out
    assert np.abs(g64).max() > 0 and out["grad_rel_l2_card_f64"] <= out["grad_limit"], out
    assert out["loss_rel_card_f64"] <= 1e-4, out
    torch.cuda.empty_cache()
    return out


def _palette_png(img_u8) -> bytes:
    """An 8-bit palette PNG (colour type 3, a 6x6x6 colour cube)."""
    import numpy as np

    levels = np.arange(6, dtype=np.uint8) * 51
    q = (img_u8.astype(np.int32) + 25) // 51
    idx = (q[..., 0] * 36 + q[..., 1] * 6 + q[..., 2]).astype(np.uint8)
    plte = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"), -1).reshape(-1, 3)
    h, w = idx.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), idx], axis=1).tobytes()

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
            + chunk(b"PLTE", plte.tobytes()) + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


def real_image_flow_phase(cli):
    """The real-image flow at 256 px in chiprun_out/bp/: 4 RGB PNGs of G's
    images, a gray one (320x288) and a palette one (256x200);
    ``python -m latent2im_tpu_torch.cli.bp`` (run in this process, as
    ``python -m`` runs it, so that its launches are counted) with
    INV_CLI_LOOPS loops; then ``python -m latent2im_tpu_torch.cli.vis_w
    --latents_dir`` on its latents with phase 10's walk (``vis_w_here``)."""
    import runpy
    import shutil

    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.utils import image as imgmod

    root = os.path.join(REPO, "chiprun_out", "bp")
    shutil.rmtree(root, ignore_errors=True)
    img_dir, save_dir, vis_dir = (os.path.join(root, d) for d in ("imgs", "out", "vis"))
    os.makedirs(img_dir)
    g, _ = inversion_towers(SIZE, seed=21)
    imgs = imgmod.to_uint8(g_images(g, 6, seed=22).numpy())
    for i in range(4):
        with open(os.path.join(img_dir, f"face{i}.png"), "wb") as f:
            f.write(imgmod.png_bytes(imgs[i]))
    gray = imgmod.pil_resize_lanczos(imgs[4].mean(-1, keepdims=True).astype(np.uint8),
                                     (288, 320))[..., 0]
    with open(os.path.join(img_dir, "face4_gray.png"), "wb") as f:
        f.write(imgmod.png_bytes(gray))
    with open(os.path.join(img_dir, "face5_palette.png"), "wb") as f:
        f.write(_palette_png(imgs[5][:200]))
    del g
    out = {"seconds": {}}
    t0 = time.perf_counter()
    saved_argv = sys.argv
    sys.argv = ["bp", "--img_dir", img_dir, "--save_dir", save_dir, "--resolution", str(SIZE),
                "--n_loops", str(INV_CLI_LOOPS), "--show_freq", "10", "--batch_size", str(BATCH)]
    try:
        ops.reset_launches()
        runpy.run_module("latent2im_tpu_torch.cli.bp", run_name="__main__")
        torch.cuda.synchronize()
        out["launches"] = ops.launch_counts()
    finally:
        sys.argv = saved_argv
    out["seconds"]["bp"] = time.perf_counter() - t0
    assert all(out["launches"][k] > 0 for k in SOURCE), out["launches"]
    n_latent = 2 * int(math.log2(SIZE)) - 2
    for bi, n in ((0, 4), (4, 2)):
        names = [f"org_{bi}.png", f"{bi}_final.png", f"{bi}_loss.npy"] + [
            f"{bi}_iterations_{k}.png" for k in (10, 20, 30)]
        missing = [f for f in names if not os.path.isfile(os.path.join(save_dir, f))]
        assert not missing, missing
        w = np.load(os.path.join(save_dir, "latent", f"{bi}_w.npy"))
        curve = np.load(os.path.join(save_dir, f"{bi}_loss.npy"))
        assert w.shape == (n, n_latent, 512) and np.isfinite(w).all(), w.shape
        assert curve.shape == (INV_CLI_LOOPS,) and np.isfinite(curve).all(), curve
        out[f"loss_{bi}"] = (float(curve[0]), float(curve[-1]))
    t0 = time.perf_counter()
    out["vis_pngs"] = vis_w_here(
        vis_dir, [f"sample{i}_" for i in range(6)], os.path.join(cli["run_dir"], "opt.yml"),
        "--save_path_w", cli["walk_path"], "--latents_dir", os.path.join(save_dir, "latent"),
        "--num_panels", "5")
    out["seconds"]["vis_w"] = time.perf_counter() - t0
    return out


def walk_kinds_phase(results, dev, refs=None):
    """train_loop at 256 px, B=4 for each new W-space walk (mlp_w from
    --is_mlp, nn_w from --walk_type NNz): a warmup step, then WALK_STEPS
    counted and timed steps (the towers' launches per step are linear_w's);
    a save -> reload -> reference-export round trip of the trained walk; one
    step on the card against the CPU and an f64 reference (phase 9, with
    the towers' term of train_cpu_phase)."""
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.engine.train import train_loop
    from latent2im_tpu_torch.io import checkpoint as ckpt
    from latent2im_tpu_torch.io.torch_convert import export_walk_torch
    from latent2im_tpu_torch.tasks.transforms import get_task
    from latent2im_tpu_torch.walks import walk_leaves, walk_map

    import tempfile

    per_step = {n: r["train_step"]["launches"] for n, r in results.items()}
    out = {}
    for kind, flags in WALK_KINDS:
        conf = train_conf(*flags)
        ed, walk, _ = build_editor_from_options(conf)  # cuda: the default
        assert ed.cfg.walk_kind == kind, (kind, ed.cfg.walk_kind)
        task = get_task(conf.transform, walk_type=conf.walk_type, nsliders=1)
        run = dict(batch_size=BATCH, n_epochs=1, lr=conf.learning_rate, log_every=1)
        walk, _ = train_loop(ed, task, walk, num_samples=BATCH, **run)  # warmup
        torch.cuda.synchronize()
        before = [t.detach().clone() for t in walk_leaves(walk)]
        metrics = []
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        walk, _ = train_loop(ed, task, walk, num_samples=WALK_STEPS * BATCH, seed=1,
                             on_step=lambda e, i, m, dt, wp: metrics.append(m), **run)
        ev1.record()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        expect = {k: WALK_STEPS * v for k, v in per_step.items()}
        assert counts == expect, (kind, counts, expect)
        assert len(metrics) == WALK_STEPS and all(
            math.isfinite(v) for m in metrics for v in m.values()), metrics
        moved = max((a.detach() - b).abs().max().item()
                    for a, b in zip(walk_leaves(walk), before))
        assert moved > 0, kind
        r = {"steps": WALK_STEPS, "batch": BATCH,
             "step_ms_cuda_events": ev0.elapsed_time(ev1) / WALK_STEPS,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts,
             "walk_max_abs_change": moved, "first": metrics[0], "last": metrics[-1]}
        # save -> reload -> the reference's pickled module -> reload
        like = walk_map(torch.zeros_like, walk)
        with tempfile.TemporaryDirectory() as root:  # ~10-20 MB of walks
            back, _, _ = ckpt.load_walk(ckpt.save_walk(root, 1, walk, final=True), like)
            ref_path = os.path.join(root, "model_w_1_final_ref_walk_module.ckpt")
            export_walk_torch(ref_path, kind, back)
            back2, _, meta = ckpt.load_walk(ref_path, like)
        for a, b, c in zip(walk_leaves(walk), walk_leaves(back), walk_leaves(back2)):
            assert torch.equal(a.detach(), b) and torch.equal(b, c), kind
        r["reference_class"] = meta["cls"]
        del ed, walk, back, back2
        torch.cuda.empty_cache()
        # at SIZE: at F64_SIZE the card's own f32 spread (2.9e-3) reached the bound
        r["cpu_vs_card"] = train_cpu_phase(*flags, towers_term=True, size=SIZE,
                                           cpu=refs and refs.get(kind))
        torch.cuda.empty_cache()
        out[kind] = r
    return out


def late_phases(card, dev, results, cli, refs=None):
    """Phases 16-20 -> their reports and, under "launches", each path's
    launch counts (gp, bp, bp_cli, bp_1024, walk_mlp_w, walk_nn_w). refs:
    the CpuReferences worker holding phases 16 and 20's CPU halves."""
    import torch

    phase(16, f"the gradient penalty's gradient wrt D's parameters ({F64_SIZE} px, B={BATCH}): "
          "second derivatives through the backward kernels, card against f64 on the CPU")
    gp = gp_phase(dev, cpu=refs and refs.get("gp"))
    log(f"    penalty {json.dumps(gp['gp'])}; worst group {json.dumps(gp['worst'])}; "
        f"card {gp['card_ms']:.2f} ms (CUDA events), launches {json.dumps(gp['launches'])}")
    log("    per parameter, relative L2 to f64 (card, CPU f32, bound): " + ", ".join(
        f"{n} {r['card']:.2e}/{r['cpu_f32']:.2e}/{r['bound']:.1e}" if "card" in r
        else f"{n} zero (card max {r['card_max_abs']:.1e})" for n, r in gp["groups"].items()))
    torch.cuda.empty_cache()

    phase(17, f"W+ inversion at {SIZE} px, B={BATCH}, Adam lr {INV_LR}, {INV_LOOPS} loops, "
          "of images G made")
    inv = inversion_phase(dev, SIZE, BATCH, INV_LOOPS)
    log(f"    {inv['ms_per_loop']:.2f} ms per loop (CUDA events), peak {inv['peak_gb']:.2f} GB, "
        f"loss {inv['loss_first']:.5f} -> {inv['loss_last']:.5f}, launches per loop "
        f"{json.dumps(inv['launches_per_loop'])}, on {card}")
    inv["cpu_vs_card"] = inversion_cpu_phase(dev, cpu=refs and refs.get("inversion"))
    log(f"    {INV_CMP_LOOPS} loops at B=1 against f64 on the CPU: "
        f"{json.dumps(inv['cpu_vs_card'])}")

    phase(18, f"the real-image flow: python -m latent2im_tpu_torch.cli.bp ({SIZE} px, "
          f"{INV_CLI_LOOPS} loops, 6 PNGs), then cli.vis_w --latents_dir")
    flow = real_image_flow_phase(cli)
    log(f"    wall seconds {json.dumps(flow['seconds'])}, loss (first, last) per batch "
        f"{flow['loss_0']}, {flow['loss_4']}, launches {json.dumps(flow['launches'])}, "
        f"vis_w wrote {flow['vis_pngs']}, on {card}")
    torch.cuda.empty_cache()

    phase(19, f"W+ inversion at {SIZE_HI} px, B={BATCH}, {INV_HI_LOOPS} loops")
    inv_hi = inversion_phase(dev, SIZE_HI, BATCH, INV_HI_LOOPS)
    log(f"    {inv_hi['ms_per_loop']:.1f} ms per loop (CUDA events), peak "
        f"{inv_hi['peak_gb']:.2f} GB, loss {inv_hi['loss_first']:.5f} -> "
        f"{inv_hi['loss_last']:.5f}, launches per loop "
        f"{json.dumps(inv_hi['launches_per_loop'])}, on {card}")

    phase(20, f"the mlp_w and nn_w walks at {SIZE} px, train_loop B={BATCH}")
    walks = walk_kinds_phase(results, dev, refs)
    for kind, r in walks.items():
        log(f"    {kind}: {r['step_ms_cuda_events']:.2f} ms per step (CUDA events over "
            f"{WALK_STEPS} steps), peak {r['peak_mem_gb']:.2f} GB, loss "
            f"{r['first']['loss']:.4f} -> {r['last']['loss']:.4f}, round trip through "
            f"{r['reference_class']}; step against the CPU {json.dumps(r['cpu_vs_card'])}, "
            f"on {card}")

    return {"gp": gp, "inversion": inv, "real_image_flow": flow, "inversion_1024": inv_hi,
            "walks": walks,
            "launches": {"gp": gp["launches"], "bp": inv["launches"], "bp_cli": flow["launches"],
                         "bp_1024": inv_hi["launches"],
                         **{f"walk_{k}": r["launches"] for k, r in walks.items()}}}


# ---------------------------------------------------------------------------
# phases 21-24: the joint GAN fine-tune (--updateGAN)
# ---------------------------------------------------------------------------

GAN_ITERS, GAN_CMP_BATCH = 5, 2
GAN_BATCH_HI = (4, 2)  # the 1024 px batch: 4, or 2 where 4 does not fit


def _gan_pngs(root, n=6, seed=24):
    """n PNGs of random colour blocks, not square, for --real_data_dir."""
    import numpy as np

    from latent2im_tpu_torch.utils import image as imgmod

    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(seed)
    for i in range(n):
        h, w = SIZE + 16 * (i % 3), SIZE + 8 * (i % 2) + 24
        blocks = rng.randint(0, 256, (h // 8 + 1, w // 8 + 1, 3)).astype(np.uint8)
        img = np.repeat(np.repeat(blocks, 8, 0), 8, 1)[:h, :w]
        with open(os.path.join(root, f"real{i}.png"), "wb") as f:
            f.write(imgmod.png_bytes(img))
    return root


def _timed_gan_steps(timings):
    """A make_gan_update_steps for cli.train that records CUDA events and the
    metrics around each D and G step in ``timings`` {"d": [...], "g": [...]}."""
    import torch

    from latent2im_tpu_torch.engine.gan import make_gan_update_steps

    def make(*a, **kw):
        steps = make_gan_update_steps(*a, **kw)

        def timed(fn, key):
            def run(*args, **kwargs):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                m = fn(*args, **kwargs)
                ev[1].record()
                timings[key].append((ev, m))
                return m
            return run

        return timed(steps[0], "d"), timed(steps[1], "g")

    return make


def _snapshot(named):
    return {n: p.detach().clone() for n, p in named}


def _moved(before, after) -> float:
    return max((after[n].detach() - t).abs().max().item() for n, t in before.items())


def gan_train_phase(dev, *flags, iters=GAN_ITERS, real_dir=None):
    """--updateGAN at 256 px, B=4, full width: the CLI's provider
    (cli/train.py:_make_gan_provider, real PNGs written here, or the images
    of ``real_dir``) before each train_loop step; a warmup iteration, then
    ``iters`` counted and timed ones. G's noise weights NOISE_WEIGHT, so the
    noise maps get a gradient. ``flags`` are further options (--bf16 in
    phase 37)."""
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.cli import train as tcli
    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.engine.train import train_loop
    from latent2im_tpu_torch.tasks.transforms import get_task

    real_dir = real_dir or _gan_pngs(os.path.join(REPO, "chiprun_out", "gan", "real"))
    conf = train_conf("--updateGAN", "--real_data_dir", real_dir, *flags,
                      root=os.path.join(REPO, "chiprun_out", "gan"))
    t0 = time.perf_counter()
    ed, walk, _ = build_editor_from_options(conf)
    with torch.no_grad():
        for n, p in ed.g.named_parameters():
            if n.endswith("noise.weight"):
                p.fill_(NOISE_WEIGHT)
    task = get_task("face")
    timings = {"d": [], "g": []}
    real_make = tcli.make_gan_update_steps
    tcli.make_gan_update_steps = _timed_gan_steps(timings)
    try:
        provider = tcli._make_gan_provider(ed, conf, task, walk)
    finally:
        tcli.make_gan_update_steps = real_make
    mod = provider.module
    g0, d0 = _snapshot(ed.g.named_parameters()), _snapshot(ed.d.named_parameters())
    ema0 = {n: t.clone() for n, t in mod.g_running.items()}
    run = dict(batch_size=BATCH, n_epochs=1, lr=conf.learning_rate, log_every=1,
               frozen_provider=provider)
    ops.reset_launches()
    walk, _ = train_loop(ed, task, walk, num_samples=BATCH, **run)  # warmup
    torch.cuda.synchronize()
    per_iter = ops.launch_counts()
    log(f"    editor built, provider made and one warmup iteration in "
        f"{time.perf_counter() - t0:.1f} s; launches per iteration {json.dumps(per_iter)}")
    timings["d"].clear()
    timings["g"].clear()
    metrics = []
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    t0 = time.perf_counter()
    ev[0].record()
    walk, _ = train_loop(ed, task, walk, num_samples=iters * BATCH, seed=1,
                         on_step=lambda e, i, m, dt, wp: metrics.append(m), **run)
    ev[1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    expect = {k: iters * v for k, v in per_iter.items()}
    assert counts == expect and all(v > 0 for v in counts.values()), (counts, expect)
    gan_m = [{k: v.item() for k, v in m.items()} for key in ("d", "g")
             for _, m in timings[key]]
    assert len(timings["d"]) == len(timings["g"]) == iters, timings
    assert all(math.isfinite(v) for m in gan_m + metrics for v in m.values()), (gan_m, metrics)
    noise = {n: t for n, t in g0.items() if n.startswith("noises.")}
    out = {"iterations": iters, "batch": BATCH,
           "iteration_ms_cuda_events": ev[0].elapsed_time(ev[1]) / iters,
           "d_step_ms_cuda_events": statistics.mean(
               e[0].elapsed_time(e[1]) for e, _ in timings["d"]),
           "g_step_ms_cuda_events": statistics.mean(
               e[0].elapsed_time(e[1]) for e, _ in timings["g"]),
           "samples_per_s": iters * BATCH / wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": counts, "launches_per_iteration": per_iter,
           "launches_bf16": ops.launch_counts(bf16=True),
           "moved": {"g": _moved(g0, dict(ed.g.named_parameters())),
                     "d": _moved(d0, dict(ed.d.named_parameters())),
                     "g_running": _moved(ema0, mod.g_running),
                     "noise_maps": _moved(noise, dict(ed.g.named_parameters()))},
           "gan_first": {**gan_m[0], **gan_m[iters]},
           "gan_last": {**gan_m[iters - 1], **gan_m[-1]},
           "walk_last": metrics[-1]}
    assert all(v > 0 for v in out["moved"].values()), out["moved"]
    assert not any(p.requires_grad for m in (ed.g, ed.d) for p in m.parameters())
    del ed, walk, provider, mod
    torch.cuda.empty_cache()
    return out


def gan_grads(g, d, z, real, eps):
    """One D step's and one G step's gradient per parameter (f64 numpy) over
    g_apply = G(z) (stored noise), Adam at lr 0, so both start from the same
    G and D, and the G step's gradient wrt G's image (where G's backward
    starts). -> ({"d_loss", "grad_penalty", "g_loss"}, {"d"|"g": {name:
    gradient}, "image": gradient}, {"d"|"g": seconds})."""
    from latent2im_tpu_torch.engine.gan import GANModule, make_gan_update_steps

    mod = GANModule.create(g.requires_grad_(False), d.requires_grad_(False), lr=0.0)
    grads = {}
    for key, opt, module in (("d", mod.d_opt, d), ("g", mod.g_opt, g)):
        names = [n for n, _ in module.named_parameters()]
        opt.register_step_pre_hook(
            lambda o, a, k, key=key, names=names: grads.update({key: {
                n: p.grad.double().cpu().numpy()
                for n, p in zip(names, o.param_groups[0]["params"])}}))
    def g_apply(zz):  # the towers' f32 output casts undone for the f64 reference
        img = g(zz).to(zz.dtype)
        if img.requires_grad:
            img.register_hook(lambda gr: grads.update(image=gr.double().cpu().numpy()))
        return img

    d_step, g_step = make_gan_update_steps(g_apply, lambda x: d(x).to(x.dtype), mod)
    t0 = time.perf_counter()
    dm = d_step(z, real, eps=eps)
    dm = {k: v.item() for k, v in dm.items()}
    t1 = time.perf_counter()
    gm = {k: v.item() for k, v in g_step(z).items()}
    return {**dm, **gm}, grads, {"d": t1 - t0, "g": time.perf_counter() - t1}


@contextlib.contextmanager
def plain_kernels():
    """The ops modules' kernel entry points (``_forward``, ``_backward``)
    replaced by their plain versions on every device, so that the model
    runs in f64 on the card: phase 22's reference."""
    import importlib

    import torch

    fa, ud, sc = (importlib.import_module(f"latent2im_tpu_torch.ops.{m}")
                  for m in ("fused_act", "upfirdn2d", "styled_conv"))

    def ufd_backward(g, k, up, down, pads, in_hw):  # the CPU branch of ud._backward
        gup, gdown, gpads = ud.transposed_params(tuple(k.shape), up, down, pads,
                                                 tuple(in_hw), tuple(g.shape[1:3]))
        return ud.upfirdn2d_plain(g, torch.flip(k, (0, 1)), gup, gdown, gpads)

    saved = (fa._forward, fa._backward, ud._forward, ud._backward, sc._forward,
             sc._partial_forward, sc._epilogue_forward)
    fa._forward = fa.fused_leaky_relu_plain
    fa._backward = lambda g, out, ns, scale: fa.fused_leaky_relu_bwd_plain(
        g, out, ns, scale, bias_grad=False)[0]
    ud._forward, ud._backward = ud.upfirdn2d_plain, ufd_backward
    sc._forward = sc.styled_conv3x3_plain
    sc._partial_forward = sc.styled_conv3x3_partial_plain
    sc._epilogue_forward = sc.styled_conv3x3_epilogue_plain
    try:
        yield
    finally:
        (fa._forward, fa._backward, ud._forward, ud._backward, sc._forward,
         sc._partial_forward, sc._epilogue_forward) = saved


# The gradient of a noise map sums 2 * C terms per pixel, each behind its own
# LeakyReLU mask, and a noise weight's sums those over the map, so a mask
# that the forward's f32 rounding flips moves them by 0.8 of a term. The
# card's f32 forward flips more masks than the CPU's: at 256 px, B=2, the
# maps and weights read up to 3.85e-3 relative L2 from f64 on the card
# (noises.noise_12) against up to 2.08e-3 on the CPU, convs.4's noise weight
# 0.18e-3-1.42e-3 over four runs, the same with the styled conv's forward on
# cuDNN and with deterministic cuDNN, while every other parameter of G and D
# stays within 1.1e-4 (scripts/torch_gan_grad_check.py, H100 80GB HBM3 at
# 700 W). A fault in that path (a lost sum, a frozen map) is off by O(1).
NOISE_F32_MAX = 1e-2


def _gan_grad_inputs():
    """Phase 22's seeded G (noise weights NOISE_WEIGHT) and D (biases off
    zero) at SIZE px, z, the real images and the penalty's eps, on the CPU."""
    import numpy as np
    import torch

    from latent2im_tpu_torch.models.stylegan2 import Discriminator, Generator

    gen = torch.Generator().manual_seed(25)
    g = Generator(SIZE, generator=gen)
    d = Discriminator(SIZE, generator=gen)
    with torch.no_grad():
        for n, p in g.named_parameters():
            if n.endswith("noise.weight"):
                p.fill_(NOISE_WEIGHT)
        for n, p in d.named_parameters():
            if n.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    rng = np.random.RandomState(25)
    z = torch.from_numpy(rng.randn(GAN_CMP_BATCH, 512).astype(np.float32))
    real = torch.from_numpy((0.5 * rng.randn(GAN_CMP_BATCH, SIZE, SIZE, 3)).astype(np.float32))
    eps = torch.from_numpy(rng.uniform(size=(GAN_CMP_BATCH, 1, 1, 1)).astype(np.float32))
    return g, d, z, real, eps


def gan_grads_cpu_side():
    """The CPU half of ``gan_grads_phase`` (the CpuReferences worker): the
    steps in f32 on the CPU -> gan_grads' three results."""
    return gan_grads(*_gan_grad_inputs())


def gan_grads_phase(dev, enforce: bool = True, cpu=None):
    """One D step's and one G step's gradients at 256 px, full width, B=2
    (``_gan_grad_inputs``): on the card, and in f32 on the CPU, each against
    f64 (the plain versions on the card: on the CPU the f64 steps take
    minutes), per parameter by relative L2, the card held to max(1e-3, 1.5 x
    the CPU f32 error) (phase 9's form, as phase 16), G's noise maps and
    noise weights to NOISE_F32_MAX where that is larger. enforce=False only
    reports. cpu: ``gan_grads_cpu_side``'s result (computed here when None)."""
    import copy

    import torch

    from latent2im_tpu_torch import ops

    g, d, z, real, eps = _gan_grad_inputs()
    ops.reset_launches()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    m_card, g_card, _ = gan_grads(copy.deepcopy(g).to(dev), copy.deepcopy(d).to(dev),
                                  z.to(dev), real.to(dev), eps.to(dev))
    ev[1].record()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    m_cpu, g_cpu, s_cpu = cpu or gan_grads_cpu_side()
    with plain_kernels():
        t = time.perf_counter()
        m_f64, g_f64, _ = gan_grads(copy.deepcopy(g).to(dev, torch.float64),
                                    copy.deepcopy(d).to(dev, torch.float64),
                                    *(t_.to(dev, torch.float64) for t_ in (z, real, eps)))
        s_f64 = time.perf_counter() - t
    out = {"card_ms": ev[0].elapsed_time(ev[1]), "cpu_f32_s": s_cpu, "card_f64_s": s_f64,
           "metrics": {"card": m_card, "cpu_f32": m_cpu, "cpu_f64": m_f64},
           "image_grad": {"card": rel_l2(g_card["image"], g_f64["image"]),
                          "cpu_f32": rel_l2(g_cpu["image"], g_f64["image"])},
           "launches": counts, "worst": {}, "groups": {}}
    for key in ("d", "g"):
        ratios = []
        for name, ref in g_f64[key].items():
            assert ref.any(), (key, name)  # every parameter reaches its loss
            card, cpu = rel_l2(g_card[key][name], ref), rel_l2(g_cpu[key][name], ref)
            noise = name.startswith("noises.") or name.endswith("noise.weight")
            floor = NOISE_F32_MAX if noise else 1e-3
            ratios.append((card / max(floor, 1.5 * cpu), name, card, cpu))
            out["groups"][f"{key}:{name}"] = {"card": card, "cpu_f32": cpu}
        worst = max(ratios)
        out["worst"][key] = {"card_over_bound": worst[0], "param": worst[1],
                             "card_rel_l2": worst[2], "cpu_f32_rel_l2": worst[3],
                             "card_rel_l2_max": max(r[2] for r in ratios)}
        if enforce:
            assert worst[0] <= 1.0, (key, out["worst"])
    if not enforce:
        return out
    for k, v in m_f64.items():
        assert abs(m_card[k] - v) <= 1e-3 * max(1.0, abs(v)), (k, out["metrics"])
    assert all(v > 0 for v in counts.values()), counts
    return out


def gan_1024_phase(dev):
    """One D step and one G step (after one of each as a warmup) at 1024 px,
    full width, through the CLI's g_apply: ms (CUDA events), peak GB and the
    batch, GAN_BATCH_HI[0] unless it does not fit."""
    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.cli.train import make_g_apply
    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.engine.gan import GANModule, draw_eps, make_gan_update_steps

    t0 = time.perf_counter()
    ed, walk, _ = build_editor_from_options(train_conf(size=SIZE_HI))
    mod = GANModule.create(ed.g, ed.d)
    d_step, g_step = make_gan_update_steps(make_g_apply(ed), ed.discriminate, mod)
    log(f"    1024 px editor built in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=ed.device).manual_seed(26)
    out = {"oom_at": []}
    for b in GAN_BATCH_HI:
        rng = np.random.RandomState(26)
        batch = {"z": ed._tensor(rng.randn(b, 512)), "alpha": ed._tensor(rng.uniform(size=(b, 1))),
                 "walk": {"w": walk["w"].detach()}}
        real = ed._tensor(0.5 * rng.randn(b, SIZE_HI, SIZE_HI, 3))
        try:
            d_step(batch, real, draw_eps(gen, b, ed.device))
            g_step(batch)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
            dm = d_step(batch, real, draw_eps(gen, b, ed.device))
            ev[1].record()
            gm = g_step(batch)
            ev[2].record()
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError:
            out["oom_at"].append(b)
            torch.cuda.empty_cache()
            continue
        out.update(batch=b, d_step_ms_cuda_events=ev[0].elapsed_time(ev[1]),
                   g_step_ms_cuda_events=ev[1].elapsed_time(ev[2]),
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches=ops.launch_counts(),
                   metrics={k: v.item() for k, v in {**dm, **gm}.items()})
        break
    assert "batch" in out, out
    assert all(math.isfinite(v) for v in out["metrics"].values()), out
    assert all(v > 0 for v in out["launches"].values()), out
    del ed, walk, mod, d_step, g_step
    torch.cuda.empty_cache()
    return out


def gan_cli_phase():
    """The --updateGAN CLI at 256 px, full width, in a temporary directory
    (a GAN checkpoint with its Adam states is ~0.7 GB), on PNGs written
    here: 2 epochs of one step, a SIGTERM after epoch 0's step
    (model_gan_resume.ckpt, no final), --resume to model_gan_2_final.ckpt
    (both Adam states restored equal to the preempted run's), then `python
    -m latent2im_tpu_torch.cli.vis_w --save_path_gan` on it, its PNGs in
    chiprun_out/gan_cli/. The launch counts are set to 0 before the two runs
    and read after."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        return _gan_cli_flow(root)


def _gan_cli_flow(root):
    import copy
    import shutil
    import signal

    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.cli import train as tcli
    from latent2im_tpu_torch.config.options import TrainOptions
    from latent2im_tpu_torch.io import checkpoint as ckpt

    real_dir = _gan_pngs(os.path.join(root, "real"), seed=27)
    out = {"seconds": {}}
    box = {"kill": True}
    real_loop, real_save, real_provider = (tcli.train_loop, tcli._save_gan,
                                           tcli._make_gan_provider)

    def loop(*a, **kw):
        on_step = kw["on_step"]

        def killing_on_step(epoch, i, metrics, dt, wp):
            on_step(epoch, i, metrics, dt, wp)
            if box["kill"]:
                os.kill(os.getpid(), signal.SIGTERM)

        kw.update(on_step=killing_on_step)
        return real_loop(*a, **kw)

    def saving(provider, path):
        real_save(provider, path)
        box.setdefault("saved", {})[os.path.basename(path)] = {
            k: copy.deepcopy(getattr(provider.module, k).state_dict())
            for k in ("g_opt", "d_opt")}

    def providing(*a, **kw):
        provider = real_provider(*a, **kw)
        box["restored"] = {k: copy.deepcopy(getattr(provider.module, k).state_dict())
                           for k in ("g_opt", "d_opt")}
        return provider

    args = _cli_args(os.path.join(root, "models"), "Smiling", BATCH, 2, "--model_save_freq",
                     "0", "--updateGAN", "--real_data_dir", real_dir)
    t0 = time.perf_counter()
    tcli.train_loop, tcli._save_gan, tcli._make_gan_provider = loop, saving, providing
    try:
        ops.reset_launches()
        opt = TrainOptions().parse(args, print_opt=True)
        tcli.run(opt)  # cuda: the entry point's default
        listing = sorted(os.listdir(opt.output_dir))
        box["kill"] = False
        walk, history = tcli.run(TrainOptions().parse(args + ["--resume"], print_opt=False))
        torch.cuda.synchronize()
        out["launches"] = ops.launch_counts()
    finally:
        tcli.train_loop, tcli._save_gan, tcli._make_gan_provider = (real_loop, real_save,
                                                                    real_provider)
    out["seconds"]["train_sigterm_resume"] = time.perf_counter() - t0
    assert "model_gan_resume.ckpt" in listing and "model_gan_2_final.ckpt" not in listing, \
        listing
    assert all(v > 0 for v in out["launches"].values()), out["launches"]
    assert len(history) == 1 and all(math.isfinite(h) for h in history), history
    saved = box["saved"]["model_gan_resume.ckpt"]
    for k in ("g_opt", "d_opt"):
        a, b = saved[k]["state"], box["restored"][k]["state"]
        assert set(a) == set(b) and a, k
        for i in a:
            for key in ("step", "exp_avg", "exp_avg_sq"):
                assert torch.equal(a[i][key].cpu(), b[i][key].cpu()), (k, i, key)
    final = os.path.join(opt.output_dir, "model_gan_2_final.ckpt")
    assert ckpt.load_meta(final) == {"gan_steps": 2}, ckpt.load_meta(final)
    out["adam_moments_restored"] = {k: len(saved[k]["state"]) for k in saved}
    t0 = time.perf_counter()
    vis_dir = os.path.join(REPO, "chiprun_out", "gan_cli")
    shutil.rmtree(vis_dir, ignore_errors=True)
    out["vis_pngs"] = vis_w_here(
        vis_dir, ["sample0_", "sample1_"], os.path.join(opt.output_dir, "opt.yml"),
        "--save_path_w", os.path.join(opt.output_dir, "model_w_2_final_walk_module.ckpt"),
        "--save_path_gan", final, "--num_samples", "2", "--num_panels", "3")
    out["seconds"]["vis_w_save_path_gan"] = time.perf_counter() - t0
    return out


def gan_phases(card, dev, refs=None):
    """Phases 21-24 -> their reports and, under "launches", each path's
    launch counts (gan, gan_grads, gan_1024, gan_cli). refs: the
    CpuReferences workers holding phase 22's CPU half."""
    import torch

    phase(21, f"--updateGAN at {SIZE} px, B={BATCH}: the CLI's provider (a D and a G "
          f"step) before each train_loop step, {GAN_ITERS} iterations")
    train = gan_train_phase(dev)
    log(f"    {train['iteration_ms_cuda_events']:.2f} ms per iteration, D step "
        f"{train['d_step_ms_cuda_events']:.2f} ms, G step {train['g_step_ms_cuda_events']:.2f} "
        f"ms (CUDA events), peak {train['peak_mem_gb']:.2f} GB, moved "
        f"{json.dumps(train['moved'])}, GAN {json.dumps(train['gan_first'])} -> "
        f"{json.dumps(train['gan_last'])}, on {card}")

    phase(22, f"one D and one G step's gradients ({SIZE} px, B={GAN_CMP_BATCH}): card and CPU "
          "against f64")
    grads = gan_grads_phase(dev, cpu=refs and refs.get("gan_grads"))
    log(f"    {json.dumps(grads['worst'])}; the image's gradient {json.dumps(grads['image_grad'])}; "
        f"metrics {json.dumps(grads['metrics'])}; card {grads['card_ms']:.2f} ms, CPU f32 "
        f"{json.dumps(grads['cpu_f32_s'])} s, card f64 {grads['card_f64_s']:.1f} s")
    torch.cuda.empty_cache()

    phase(23, f"one D and one G step at {SIZE_HI} px")
    hi = gan_1024_phase(dev)
    log(f"    B={hi['batch']} (out of memory at {hi['oom_at']}): D step "
        f"{hi['d_step_ms_cuda_events']:.1f} ms, G step {hi['g_step_ms_cuda_events']:.1f} ms "
        f"(CUDA events), peak {hi['peak_mem_gb']:.2f} GB, on {card}")

    phase(24, "the --updateGAN CLI: train + SIGTERM + --resume, then vis_w --save_path_gan")
    cli = gan_cli_phase()
    log(f"    wall seconds {json.dumps(cli['seconds'])}, launches {json.dumps(cli['launches'])}, "
        f"Adam moments restored {json.dumps(cli['adam_moments_restored'])}, vis_w wrote "
        f"{cli['vis_pngs']}")
    torch.cuda.empty_cache()
    return {"train": train, "grads": grads, "hi": hi, "cli": cli,
            "launches": {"gan": train["launches"], "gan_grads": grads["launches"],
                         "gan_1024": hi["launches"], "gan_cli": cli["launches"]}}


# ---------------------------------------------------------------------------
# phases 25-28: z-space editing and the PGGAN backends
# ---------------------------------------------------------------------------

Z_REQUESTS, Z_STEPS, PGGAN_STEPS, ZOO_STEPS = 10, 6, 5, 3
# the GAN-zoo PGAN's celebAHQ-512 depths (JAX pgan_zoo.init_generator's default)
ZOO_DEPTHS = (512, 512, 512, 512, 256, 128, 64, 32)
PGGAN_KINDS = (("linear_z_free", ()), ("mlp_z3", ("--walk_type", "NNz")),
               ("embed", ("--trainEmbed",)))
Z_FLAGS = ("--latent", "z", "--is_mlp")  # StyleGAN2 in z: the mlp_z walk


def pggan_conf(*flags, size=None, batch=None, root=None, print_opt=False):
    """--model pggan (Smiling; model_256 at step log2(size) - 2 unless a
    --g_path in flags names a zoo checkpoint)."""
    from latent2im_tpu_torch.config.options import TrainOptions

    return TrainOptions().parse(
        ["--model", "pggan", "--transform", "face", "--walk_type", "linear",
         "--attrList", "Smiling", "--resolution", str(size or SIZE), "--batch_size",
         str(batch or BATCH), "--models_dir", root or os.path.join(REPO, "chiprun_out"),
         "--overwrite_config", *flags], print_opt=print_opt)


def z_reference_step(ed, w0, z, sampled, dtype):
    """A z-space step's loss terms, walk gradient (flattened) and gradient
    wrt the edited z at walk w0, composed here from the editor's towers in
    ``dtype`` (an independent reference of make_train_step's z branch; the
    towers' f32 output casts are undone)."""
    import numpy as np
    import torch

    from latent2im_tpu_torch.engine import losses as L
    from latent2im_tpu_torch.walks import apply_walk, walk_leaves, walk_map

    cfg, dev = ed.cfg, ed.device
    z, sampled = (torch.as_tensor(a, dtype=dtype, device=dev) for a in (z, sampled))
    w = walk_map(lambda a: torch.as_tensor(a, dtype=dtype, device=dev).requires_grad_(True),
                 w0)

    def synth(lat):
        return (ed._synth_fn(ed.g, lat) if ed._synth_fn is not None else ed.g(lat)).to(dtype)

    with torch.no_grad():
        img_org = synth(z)
        alpha_org = ed.reg(img_org)[:, ed._attr_idx].to(dtype)
    target, delta = ed.unified_alphas(alpha_org, sampled)
    walk_alpha = delta if cfg.alpha_mode == "delta" else sampled
    latent_new = apply_walk(cfg.walk_kind, w, z, walk_alpha)
    latent_new.retain_grad()
    img_new = synth(latent_new)
    zero = torch.zeros((), dtype=dtype, device=dev)
    reg = L.raw_bce(ed.reg(img_new)[:, ed._attr_idx].to(dtype), target)
    content = zero if cfg.no_content_loss else L.content_loss(ed.vgg, img_org, img_new)
    gan = zero if cfg.no_gan_loss else L.gan_loss_from_logits(
        ed.discriminate(img_new).to(dtype))
    loss = L.combine(reg, content, gan, no_content_loss=cfg.no_content_loss,
                     no_gan_loss=cfg.no_gan_loss, pggan_gating=cfg.model == "pggan")
    loss.backward()
    terms = {"loss": loss, "reg_loss": reg, "content_loss": content, "gan_loss": gan}
    return ({k: v.item() for k, v in terms.items()},
            np.concatenate([t.grad.double().cpu().numpy().ravel() for t in walk_leaves(w)]),
            latent_new.grad.double().cpu().numpy())


# The f32 error of a z step's gradient at 256 px, B=2, against f64 on the
# card, of the walk and of the gradient wrt the edited z it is made from
# (scripts/torch_z_grad_check.py, two draws x four loss configurations, H100
# 80GB HBM3 at 700 W): StyleGAN2 in z 0.52e-3-1.54e-3 on the card under
# cuDNN's default algorithms (the same step moves by that much between
# runs), 0.49e-3-0.76e-3 under deterministic ones, 0.53e-3-0.97e-3 on the
# CPU; model_256 PGGAN 1.8e-3-4.7e-3 on the card in either mode, 2.9e-3-
# 1.45e-2 on the CPU, the walk's error 0.82-1.18 of the edited z's in every
# row. So the checks run the card's f32 under deterministic cuDNN, and the
# PGGAN's walk is also allowed 1.5 x the card's error at the edited z
# (phase 20's form), that error itself held within PGGAN_TOWERS_F32_MAX,
# twice the largest seen on either device (1.23e-2).
PGGAN_TOWERS_F32_MAX = 2.5e-2


def _z_grad_conf(kind):
    """The options of z_grad_phase's step: "z" (StyleGAN2 in z, mlp_z) or
    "pggan" (model_256)."""
    return train_conf(*Z_FLAGS, "--fixed_noise") if kind == "z" else pggan_conf()


def _z_grad_inputs():
    import numpy as np

    from latent2im_tpu_torch.tasks.transforms import get_task

    z = np.random.RandomState(30).randn(CMP_BATCH, 512).astype(np.float32)
    sampled, _ = get_task("face").train_alpha_np(np.random.RandomState(31), CMP_BATCH, 1)
    return z, sampled


def _z_grad_step(ed, w0, conf, z, sampled):
    """One make_train_step step of the walk w0 -> (metrics, walk gradient,
    seconds)."""
    import numpy as np
    import torch

    from latent2im_tpu_torch.engine.train import make_optimizer, make_train_step
    from latent2im_tpu_torch.walks import walk_leaves, walk_map

    walk = walk_map(lambda a: torch.tensor(a, device=ed.device, requires_grad=True), w0)
    step = make_train_step(ed, None, make_optimizer(walk, conf.learning_rate), host_alpha=True)
    t0 = time.perf_counter()
    m = step(walk, z, sampled=sampled)
    grad = np.concatenate([p.grad.detach().cpu().numpy().astype(np.float64).ravel()
                           for p in walk_leaves(walk)])
    return {k: float(v) for k, v in m.items()}, grad, time.perf_counter() - t0


def z_grad_cpu_side(kind):
    """The CPU half of ``z_grad_phase`` (the CpuReferences worker): the f32
    step on the CPU."""
    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.walks import walk_map

    conf = _z_grad_conf(kind)
    ed, walk0, _ = build_editor_from_options(conf, device="cpu")
    w0 = walk_map(lambda t: t.detach().cpu().numpy().copy(), walk0)
    metrics, grad, secs = _z_grad_step(ed, w0, conf, *_z_grad_inputs())
    return {"metrics": metrics, "grad": grad, "cpu_step_s": secs}


def z_grad_phase(kind, towers_max=None, cpu=None):
    """One step (B=CMP_BATCH, host alphas, stored noise) of ``kind``'s z
    walk (``_z_grad_conf``) through make_train_step on the card
    (deterministic cuDNN; once more under the default algorithms, reported
    only) and on the CPU (``cpu``: that half, computed here where None),
    each walk gradient against f64 on the card (the towers in f64, the
    kernels' plain versions: plain_kernels(), as phase 22): the card within
    max(1e-3, 1.5 x the CPU's f32 error) (phase 9's form), and with
    ``towers_max`` also 1.5 x the card's f32 error in the gradient wrt the
    edited z (z_reference_step, deterministic cuDNN), held within
    towers_max; loss terms within 1e-3 of f64."""
    import numpy as np
    import torch

    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.walks import walk_map

    conf = _z_grad_conf(kind)
    z, sampled = _z_grad_inputs()
    cpu = cpu or z_grad_cpu_side(kind)
    res, out = {"cpu": (cpu["metrics"], cpu["grad"])}, {"cpu_step_s": cpu["cpu_step_s"]}
    ed, walk0, _ = build_editor_from_options(conf, device="cuda")
    w0 = walk_map(lambda t: t.detach().cpu().numpy().copy(), walk0)
    del walk0
    for mode in ("deterministic", "default"):
        key = "cuda_default" if mode == "default" else "cuda"
        torch.backends.cudnn.deterministic = mode == "deterministic"
        try:
            metrics, grad, out[f"{key}_step_s"] = _z_grad_step(ed, w0, conf, z, sampled)
            res[key] = (metrics, grad)
            if key == "cuda":
                res["cuda_composed"] = z_reference_step(ed, w0, z, sampled, torch.float32)
        finally:
            torch.backends.cudnn.deterministic = False
    t0 = time.perf_counter()
    with plain_kernels():
        for m in (ed.g, ed.reg, ed.vgg, ed.d):
            if m is not None:
                m.double()
        ref, ref_grad, ref_z_grad = z_reference_step(ed, w0, z, sampled, torch.float64)
    out["card_f64_reference_s"] = time.perf_counter() - t0
    del ed
    torch.cuda.empty_cache()
    (mg, gg), (mc, gc) = res["cuda"], res["cpu"]
    for k in ("loss", "reg_loss", "content_loss", "gan_loss"):
        out[f"{k}_rel"] = abs(mg[k] - ref[k]) / max(abs(ref[k]), 1e-30)
        assert abs(mg[k] - ref[k]) <= 1e-3 * max(abs(ref[k]), 1e-30) or ref[k] == mg[k] == 0, \
            (k, mg[k], ref[k])
    assert np.isfinite(gg).all() and np.abs(ref_grad).max() > 0
    out["walk_grad_rel_l2_card_f64"] = rel_l2(gg, ref_grad)
    out["walk_grad_rel_l2_card_default_cudnn_f64"] = rel_l2(res["cuda_default"][1], ref_grad)
    out["walk_grad_rel_l2_cpu_f64"] = rel_l2(gc, ref_grad)
    out["walk_grad_rel_l2_card_cpu"] = rel_l2(gg, gc)
    out["edited_z_grad_rel_l2_card_f64"] = rel_l2(res["cuda_composed"][2], ref_z_grad)
    limit = max(1e-3, 1.5 * out["walk_grad_rel_l2_cpu_f64"])
    if towers_max is not None:
        assert out["edited_z_grad_rel_l2_card_f64"] <= towers_max, out
        limit = max(limit, 1.5 * out["edited_z_grad_rel_l2_card_f64"])
    out["walk_grad_limit"] = limit
    assert out["walk_grad_rel_l2_card_f64"] <= limit, out
    out["loss"] = ref["loss"]
    return out


def _timed_train(ed, task, walk, steps, lr, loop=None, batch=BATCH):
    """A warmup step of ``loop`` (train_loop by default), then ``steps``
    counted ones (losses read back every step) -> (walk, report with ms per
    step by CUDA events, peak GB, launch counts, the first and last
    metrics)."""
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.engine.train import train_loop
    from latent2im_tpu_torch.walks import walk_leaves

    loop = loop or train_loop
    run = dict(batch_size=batch, n_epochs=1, lr=lr, log_every=1)
    walk, _ = loop(ed, task, walk, num_samples=batch, **run)
    torch.cuda.synchronize()
    before = [t.detach().clone() for t in walk_leaves(walk)]
    metrics = []
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    walk, _ = loop(ed, task, walk, num_samples=steps * batch, seed=1,
                   on_step=lambda e, i, m, dt, wp: metrics.append(m), **run)
    ev1.record()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert len(metrics) == steps and all(
        math.isfinite(v) for m in metrics for v in m.values()), metrics
    moved = max((a.detach() - b).abs().max().item() for a, b in zip(walk_leaves(walk), before))
    assert moved > 0, "the walk did not move"
    return walk, {"steps": steps, "batch": batch,
                  "step_ms_cuda_events": ev0.elapsed_time(ev1) / steps,
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "launches": counts, "launches_bf16": ops.launch_counts(bf16=True),
                  "walk_max_abs_change": moved,
                  "first": metrics[0], "last": metrics[-1]}


def z_phase(results, dev, refs=None):
    """Phase 25: StyleGAN2 at SIZE px in z (--latent z --is_mlp, mlp_z):
    the edit server (/edit of BATCH, Z_REQUESTS times), apply_alpha device
    ms, train_loop, and one step's walk gradient against f64."""
    import argparse

    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.cli.serve import build_service
    from latent2im_tpu_torch.tasks.transforms import get_task

    # the style MLP runs in both syntheses of a z edit, and its backward in a
    # z step: fused_act and its backward at (B, 512), phase 3's shapes
    shapes = main_path_shapes()
    assert ("fused_act", (BATCH, 512)) in shapes and ("fused_act_bwd", (BATCH, 512)) in shapes
    mlp = {"fused_act": 8}
    conf = train_conf(*Z_FLAGS)
    opt = argparse.Namespace(save_path_w=None, save_path_gan=None, attrList=None, attrPath="",
                             num_panels=PANELS, min_alpha=0.0, max_alpha=1.0, serve_batch=BATCH)
    t0 = time.perf_counter()
    service = build_service(opt, conf)  # cuda: the entry point's default
    ed = service.ed
    assert (ed.cfg.latent, ed.cfg.walk_kind, ed.device.type) == ("z", "mlp_z", dev.type)
    service.warmup()
    torch.cuda.synchronize()
    out = {"build_and_warmup_s": time.perf_counter() - t0}
    per_alpha = {n: r["apply_alpha"]["launches"] + mlp.get(n, 0) for n, r in results.items()}
    with serving(service) as url:
        ops.reset_launches()
        lat, first = [], None
        for i in range(Z_REQUESTS):
            t = time.perf_counter()
            reply, ims = _post(url + "/edit", {"seed": 40 + i, "num_samples": BATCH,
                                               "alpha": 0.7})
            lat.append((time.perf_counter() - t) * 1e3)
            first = first or (reply, ims)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    expect = {k: Z_REQUESTS * v for k, v in per_alpha.items()}
    assert counts == expect, (counts, expect)
    assert len(first[1]) == BATCH and all(im.shape == (SIZE, SIZE, 3) for im in first[1])
    assert all(math.isfinite(v) for a in first[0]["alpha_org"] for v in a)
    z = np.random.RandomState(41).randn(BATCH, 512).astype(np.float32)
    a = np.full((BATCH,), 0.7, np.float32)
    edited, _, orig = ed.apply_alpha(service.walk, z, a)
    assert torch.isfinite(edited).all() and not torch.equal(edited, orig)
    out.update(serve_launches=counts, p50_request_ms=statistics.median(lat),
               apply_alpha_b4_device_ms=time_ms(
                   lambda: ed.apply_alpha(service.walk, z, a, u8=True), warmup=2, iters=10))

    task = get_task(conf.transform, walk_type=conf.walk_type, nsliders=1)
    walk, train = _timed_train(ed, task, service.walk, Z_STEPS, conf.learning_rate)
    per_step = {n: Z_STEPS * (r["train_step"]["launches"] + 8 * (n in ("fused_act",
                                                                       "fused_act_bwd")))
                for n, r in results.items()}
    assert train["launches"] == per_step, (train["launches"], per_step)
    out["train"] = train
    del service, ed, walk
    torch.cuda.empty_cache()
    out["grad"] = z_grad_phase("z", cpu=refs and refs.get("z_z"))
    return out


def pggan_phase(dev, refs=None):
    """Phase 26: model_256 at step log2(SIZE) - 2 (G at SIZE px, edited
    images SIZE/2, D on the x2 re-upsample), full ladders, B=BATCH:
    apply_alpha and sweep; train_loop for linear_z_free, mlp_z3 and
    --trainEmbed (embed); one step's walk gradient against f64. No
    hand-written kernel runs on this path."""
    import dataclasses

    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.models import pggan
    from latent2im_tpu_torch.tasks.transforms import get_task
    from latent2im_tpu_torch.walks import init_walk

    conf = pggan_conf()
    t0 = time.perf_counter()
    ed, walk, _ = build_editor_from_options(conf)  # cuda: the default
    assert isinstance(ed.g, pggan.Generator) and isinstance(ed.d, pggan.Discriminator)
    assert (ed.cfg.latent, ed.cfg.alpha_mode, ed.cfg.walk_kind) == ("z", "delta", "linear_z_free")
    out = {"build_s": time.perf_counter() - t0}
    task = get_task(conf.transform, walk_type=conf.walk_type, nsliders=1)
    z = np.random.RandomState(50).randn(BATCH, 512).astype(np.float32)
    a = np.full((BATCH,), 0.3, np.float32)
    panels = np.stack([task.scale_test_alpha(x, BATCH)
                       for x in np.linspace(-1.0, 1.0, PANELS)]).astype(np.float32)
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    edited, alpha_org, orig = ed.apply_alpha(walk, z, a)
    imgs, _, _ = ed.sweep(walk, z, panels)
    half = SIZE // 2
    assert edited.shape == orig.shape == (BATCH, half, half, 3) and torch.isfinite(edited).all()
    assert imgs.shape == (PANELS, BATCH, half, half, 3) and torch.isfinite(imgs).all()
    assert not torch.equal(imgs[0], imgs[-1])
    out["apply_alpha_ms_cuda_events"] = time_ms(lambda: ed.apply_alpha(walk, z, a),
                                                warmup=2, iters=10)
    out["sweep_ms_cuda_events"] = time_ms(lambda: ed.sweep(walk, z, panels), warmup=1,
                                          iters=5)
    out["edit_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.synchronize()
    assert set(ops.launch_counts().values()) == {0}, ops.launch_counts()
    out["walks"] = {}
    gen = torch.Generator().manual_seed(51)
    for kind, _flags in PGGAN_KINDS:  # the build's kinds (tests/test_torch_pggan.py)
        ed.cfg = dataclasses.replace(ed.cfg, walk_kind=kind)
        walk = init_walk(kind, 512, ed.cfg.n_latent, list(ed.cfg.attr_list), generator=gen,
                         device=ed.device)
        walk, r = _timed_train(ed, task, walk, PGGAN_STEPS, conf.learning_rate)
        assert set(r["launches"].values()) == {0}, r["launches"]
        out["walks"][kind] = r
    del ed, walk
    torch.cuda.empty_cache()
    out["grad"] = z_grad_phase("pggan", towers_max=PGGAN_TOWERS_F32_MAX,
                               cpu=refs and refs.get("z_pggan"))
    return out


def zoo_phase(dev):
    """Phase 27: the GAN-zoo PGAN with celebAHQ-512's depths, loaded through
    --g_path from a seeded zoo-layout state dict written here, at
    --resolution 512 (G 512 px, edited images 256, model_256's D at step 7):
    apply_alpha and train_loop steps at B=BATCH."""
    import tempfile

    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.models import pgan_zoo
    from latent2im_tpu_torch.tasks.transforms import get_task

    size = 2 * SIZE
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:  # ~90 MB
        g = pgan_zoo.GNet(512, ZOO_DEPTHS, generator=torch.Generator().manual_seed(27))
        path = os.path.join(root, "pgan_zoo_celebahq512.pt")
        torch.save({"netG": {f"module.{k}": v for k, v in g.state_dict().items()}}, path)
        conf = pggan_conf("--g_path", path, size=size)
        ed, walk, _ = build_editor_from_options(conf)  # cuda: the default
    assert isinstance(ed.g, pgan_zoo.GNet) and ed.g.resolution == size
    out = {"build_s": time.perf_counter() - t0}
    z = np.random.RandomState(52).randn(BATCH, 512).astype(np.float32)
    a = np.full((BATCH,), 0.3, np.float32)
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    edited, _, orig = ed.apply_alpha(walk, z, a)
    assert edited.shape == (BATCH, SIZE, SIZE, 3) and torch.isfinite(edited).all()
    out["apply_alpha_ms_cuda_events"] = time_ms(lambda: ed.apply_alpha(walk, z, a),
                                                warmup=2, iters=10)
    out["apply_alpha_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    task = get_task(conf.transform, walk_type=conf.walk_type, nsliders=1)
    walk, out["train"] = _timed_train(ed, task, walk, ZOO_STEPS, conf.learning_rate)
    assert set(ops.launch_counts().values()) == {0}
    del ed, walk
    torch.cuda.empty_cache()
    return out


def pggan_cli_phase():
    """Phase 28: the CLIs on model_256 (SIZE px) in chiprun_out/pggan_cli/:
    train (2 epochs of 2 steps, SIGTERM after the second step, --resume to
    the final checkpoint), `python -m latent2im_tpu_torch.cli.vis_w` on its
    walk, and the server with --save_path_w answering one /edit of BATCH.
    Host-clock seconds per part."""
    import shutil
    import signal

    import numpy as np
    import torch

    from latent2im_tpu_torch.cli import train as tcli
    from latent2im_tpu_torch.cli.serve import build_service
    from latent2im_tpu_torch.config.options import VisOptions
    from latent2im_tpu_torch.io import checkpoint as ckpt

    root = os.path.join(REPO, "chiprun_out", "pggan_cli")
    shutil.rmtree(root, ignore_errors=True)
    out = {"seconds": {}}
    fired = {"n": 0, "kill": True}
    real_loop = tcli.train_loop

    def loop(*a, **kw):  # SIGTERM after the 2nd step
        on_step = kw["on_step"]

        def killing_on_step(epoch, i, metrics, dt, wp):
            on_step(epoch, i, metrics, dt, wp)
            fired["n"] += 1
            if fired["kill"] and fired["n"] == 2:
                os.kill(os.getpid(), signal.SIGTERM)

        kw.update(on_step=killing_on_step)
        return real_loop(*a, **kw)

    args = ["--num_samples", str(2 * BATCH), "--n_epochs", "2", "--model_save_freq", "1"]
    t0 = time.perf_counter()
    tcli.train_loop = loop
    try:
        opt = pggan_conf(*args, root=root, print_opt=True)
        tcli.run(opt)  # cuda: the entry point's default
        preempted = ckpt.find_resume(opt.output_dir)
        meta = ckpt.load_meta(preempted)
        assert meta.get("preempted") is True, (preempted, meta)
        fired["kill"] = False
        walk, history = tcli.run(pggan_conf(*args, "--resume", root=root))
    finally:
        tcli.train_loop = real_loop
    torch.cuda.synchronize()
    out["seconds"]["train_sigterm_resume"] = time.perf_counter() - t0
    assert len(history) == 2 and all(math.isfinite(h) for h in history), history
    final = os.path.join(opt.output_dir, "model_w_2_final_walk_module.ckpt")
    back, _, _ = ckpt.load_walk(final, {"w": torch.zeros_like(walk["w"])})
    assert torch.equal(back["w"], walk["w"].detach())
    out.update(preempted_at=os.path.basename(preempted), preempt_meta=meta,
               grids=len(os.listdir(os.path.join(opt.output_dir, "results"))))

    t0 = time.perf_counter()
    vis_dir = os.path.join(root, "vis")
    out["vis_pngs"] = vis_w_here(vis_dir, ["sample0_", "sample1_"],
                                 os.path.join(opt.output_dir, "opt.yml"), "--save_path_w", final,
                                 "--num_samples", "2", "--num_panels", "5")
    out["seconds"]["vis_w"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    vo = VisOptions()
    vo.parser.add_argument("--serve_batch", type=int, default=BATCH)
    vopt, conf = vo.parse([os.path.join(opt.output_dir, "opt.yml"), "--save_path_w", final,
                           "--num_panels", str(PANELS)])
    service = build_service(vopt, conf)
    service.warmup()
    assert torch.equal(service.walk["w"], walk["w"].detach())
    with serving(service) as url:
        reply, ims = _post(url + "/edit", {"seed": 5, "num_samples": BATCH, "alpha": 0.4})
    assert len(ims) == BATCH and all(im.shape == (SIZE // 2, SIZE // 2, 3) for im in ims)
    assert np.isfinite(reply["alpha_org"]).all()
    out["seconds"]["serve_edit"] = time.perf_counter() - t0
    return out


def z_phases(card, dev, results, refs=None):
    """Phases 25-28 -> their reports and, under "launches", the z paths'
    launch counts (z_serve, z_train)."""
    import torch

    phase(25, f"StyleGAN2 in z ({SIZE} px, --latent z --is_mlp, mlp_z): the edit server, "
          f"train_loop B={BATCH}, a step's walk gradient against f64")
    z = z_phase(results, dev, refs)
    log(f"    /edit of {BATCH} p50 {z['p50_request_ms']:.1f} ms, apply_alpha B={BATCH} "
        f"{z['apply_alpha_b4_device_ms']:.2f} ms (CUDA events), train "
        f"{z['train']['step_ms_cuda_events']:.2f} ms per step, peak "
        f"{z['train']['peak_mem_gb']:.2f} GB, loss {z['train']['first']['loss']:.4f} -> "
        f"{z['train']['last']['loss']:.4f}; step against f64 {json.dumps(z['grad'])}, on {card}")
    torch.cuda.empty_cache()

    phase(26, f"model_256 PGGAN at step {int(math.log2(SIZE)) - 2} (G {SIZE} px, edits "
          f"{SIZE // 2} px), B={BATCH}: apply_alpha, sweep, three walks, a gradient")
    pg = pggan_phase(dev, refs)
    log(f"    apply_alpha {pg['apply_alpha_ms_cuda_events']:.2f} ms, sweep of {PANELS} panels "
        f"{pg['sweep_ms_cuda_events']:.2f} ms (CUDA events), peak {pg['edit_peak_mem_gb']:.2f} "
        f"GB; " + ", ".join(f"{k} {r['step_ms_cuda_events']:.2f} ms per step, peak "
                            f"{r['peak_mem_gb']:.2f} GB" for k, r in pg["walks"].items())
        + f"; step against f64 {json.dumps(pg['grad'])}, on {card}")
    torch.cuda.empty_cache()

    phase(27, f"the GAN-zoo PGAN (celebAHQ-512 depths) through --g_path, --resolution "
          f"{2 * SIZE}, B={BATCH}")
    zoo = zoo_phase(dev)
    log(f"    apply_alpha {zoo['apply_alpha_ms_cuda_events']:.2f} ms (CUDA events), peak "
        f"{zoo['apply_alpha_peak_mem_gb']:.2f} GB; walk step "
        f"{zoo['train']['step_ms_cuda_events']:.2f} ms, peak {zoo['train']['peak_mem_gb']:.2f} "
        f"GB, on {card}")
    torch.cuda.empty_cache()

    phase(28, "the CLIs on the PGGAN: train + SIGTERM + --resume, vis_w (python -m), "
          "serve --save_path_w")
    cli = pggan_cli_phase()
    log(f"    wall seconds {json.dumps(cli['seconds'])}; preempted at {cli['preempted_at']}, "
        f"vis_w wrote {cli['vis_pngs']}, on {card}")
    torch.cuda.empty_cache()
    return {"z": z, "pggan": pg, "zoo": zoo, "cli": cli,
            "launches": {"z_serve": z["serve_launches"], "z_train": z["train"]["launches"]}}


# ---------------------------------------------------------------------------
# phases 29-32: the geometric and color walks, the dsprites sliders, LPIPS
# and parity_check
# ---------------------------------------------------------------------------

GEO_TASKS = ("color", "colorlab", "zoom", "shiftx", "shifty", "rotate2d", "rotate3d")
GEO_STEPS, GEO_EMBED_STEPS, GEO_HI_STEPS, GEO_BATCH_HI = 5, 3, 3, 8
# A geometric target of G's image, card against CPU: a warp's coordinates
# come from a 3x3 matrix product (cuBLAS on the card), the Lab round trip
# from f32 powers and products; an ulp of either moves a target pixel by
# ~1e-5 at unit scale (the JAX package's own eager and jitted colorlab
# targets lie 1.2e-5 apart on the CPU, tests/test_torch_geometric.py). A
# wrong pixel, matrix or colour space is off by O(0.1).
GEO_TARGET_TOL = 1e-4
# mask pixels that may differ between devices, as a share of the pixels:
# none for the shifts and the colour tasks (exact by construction); a
# borderline pixel of a rotation or zoom-out whose source coordinate lies
# within a rounding of the border
GEO_MASK_SHARE = {"zoom": 1e-3, "rotate2d": 1e-3, "rotate3d": 1e-3}


def geo_conf(transform, *flags, size=None, batch=None, root=None, print_opt=False):
    """Training options of a geometric task (linear_w; no D or VGG19: the
    masked L2 uses neither)."""
    return train_conf("--transform", transform, "--no_gan_loss", "--no_content_loss",
                      *flags, size=size, batch=batch, root=root, print_opt=print_opt)


def geometric_step_launches(size=SIZE):
    """{kernel: launches per geometric training step} at ``size`` px: one
    style MLP and two syntheses forward (apply_alpha's), the edited
    synthesis backward, no tower (main_path_shapes' G terms)."""
    n = dict.fromkeys(SOURCE, 0)
    n["fused_act"] += 8  # the style MLP, once
    for _ in range(3, int(math.log2(size)) + 1):  # 8 .. size px
        n["fused_act"] += 2  # the up conv's activation, in both syntheses
        n["upfirdn2d"] += 4  # its blur and to_rgb's skip upsample, x2
        n["styled_conv3x3"] += 2
        n["fused_act_bwd"] += 2  # the up conv's and the styled conv's
        n["upfirdn2d_bwd"] += 2
    n["styled_conv3x3"] += 2  # conv1 at 4 px
    n["fused_act_bwd"] += 1
    return n


def geo_targets_check(name, task, imgs):
    """The task's target and mask of the card's images [B, H, W, 3], on the
    card against the plain version on the CPU (the same function on CPU
    tensors), over a few draws of its alpha."""
    import numpy as np
    import torch

    from latent2im_tpu_torch.tasks.geometric import device_target

    rng = np.random.RandomState(60)
    worst, flips, total = 0.0, 0, 0
    for _ in range(4):
        spec = task.device_spec(task.train_alpha_np(rng, imgs.shape[0])[1], imgs.shape[1])
        got_t, got_m = device_target(spec, imgs)
        want_t, want_m = device_target(spec, imgs.cpu())
        assert got_t.device == imgs.device and torch.isfinite(got_t).all()
        worst = max(worst, (got_t.cpu() - want_t).abs().max().item())
        flips += int((got_m.cpu() != want_m).sum())
        total += want_m.numel()
    assert worst <= GEO_TARGET_TOL, (name, worst)
    assert flips <= GEO_MASK_SHARE.get(name, 0.0) * total, (name, flips, total)
    return {"target_max_abs_err": worst, "mask_flips": flips, "mask_pixels": total}


def geo_reference_step(ed, w0, z, alpha_graph, spec, dtype):
    """A geometric step's loss and walk gradient (linear_w) at walk w0,
    composed here from G in ``dtype`` (an independent reference of
    make_geometric_device_step's arithmetic)."""
    import torch

    from latent2im_tpu_torch.engine import losses as L
    from latent2im_tpu_torch.tasks.geometric import device_target

    dev = ed.device
    z, a = (torch.as_tensor(x, dtype=dtype, device=dev) for x in (z, alpha_graph))
    w = torch.as_tensor(w0, dtype=dtype, device=dev).requires_grad_(True)
    with torch.no_grad():
        latent = ed.g.style_forward(z)[:, None].expand(-1, ed.cfg.n_latent, -1)
        target, mask = device_target(spec, ed.g.synthesize(latent).to(dtype))
    img_new = ed.g.synthesize(latent + torch.einsum("ba,ald->bld", a, w)).to(dtype)
    loss = L.masked_l2(img_new, target, mask)
    loss.backward()
    return loss.item(), w.grad.double().cpu().numpy().ravel()


def _geo_grad_step(name, device):
    """One geometric step (B=CMP_BATCH) of ``name`` on ``device`` from the
    phase's seeds -> (its editor, the walk's start w0, z, the alphas, the
    device spec, the loss, the walk gradient, seconds)."""
    import numpy as np

    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.engine.train import make_geometric_device_step, make_optimizer
    from latent2im_tpu_torch.tasks.transforms import get_task

    conf = geo_conf(name)
    alpha_graph, alpha_target = get_task(name).train_alpha_np(np.random.RandomState(62),
                                                              CMP_BATCH)
    spec = get_task(name).device_spec(alpha_target, SIZE)
    ed, walk, _ = build_editor_from_options(conf, device=device)
    z = np.random.RandomState(61).randn(CMP_BATCH, ed.cfg.dim_z).astype(np.float32)
    w0 = walk["w"].detach().cpu().numpy().copy()
    walk["w"].requires_grad_(True)
    step = make_geometric_device_step(ed, make_optimizer(walk, conf.learning_rate))
    t0 = time.perf_counter()
    m = step(walk, z, alpha_graph, spec)
    grad = walk["w"].grad.detach().cpu().numpy().astype(np.float64).ravel()
    return (ed, w0, z, alpha_graph, alpha_target, spec, float(m["loss"]), grad,
            time.perf_counter() - t0)


def geo_grad_cpu_side(name):
    """The CPU half of ``geo_grad_phase`` (the CpuReferences worker): the
    f32 step on the CPU and the same step in f64 (geo_reference_step)."""
    import torch

    ed, w0, z, alpha_graph, _, spec, loss, grad, secs = _geo_grad_step(name, "cpu")
    t0 = time.perf_counter()
    ed.g.double()  # the CPU editor's G
    ref_loss, ref_grad = geo_reference_step(ed, w0, z, alpha_graph, spec, torch.float64)
    return {"loss": loss, "grad": grad, "cpu_step_s": secs, "ref_loss": ref_loss,
            "ref_grad": ref_grad, "cpu_f64_reference_s": time.perf_counter() - t0}


def geo_grad_phase(name, cpu=None):
    """One geometric step (B=CMP_BATCH) of ``name`` through
    make_geometric_device_step on the card and on the CPU from the same
    seed, each against f64 on the CPU (geo_reference_step): the loss within
    1e-3, the card's walk gradient within max(1e-3, 1.5 x the CPU's f32
    error) (phase 9's bound). cpu: the CPU half, computed here where None."""
    import numpy as np

    cpu = cpu or geo_grad_cpu_side(name)
    _, _, _, _, alpha_target, _, lg, gg, secs = _geo_grad_step(name, "cuda")
    out = {"alpha": np.asarray(alpha_target).tolist(), "cuda_step_s": secs,
           "cpu_step_s": cpu["cpu_step_s"], "cpu_f64_reference_s": cpu["cpu_f64_reference_s"]}
    lc, gc, ref_loss, ref_grad = cpu["loss"], cpu["grad"], cpu["ref_loss"], cpu["ref_grad"]
    out.update(loss=ref_loss, loss_rel_card=abs(lg - ref_loss) / abs(ref_loss),
               loss_rel_cpu=abs(lc - ref_loss) / abs(ref_loss),
               walk_grad_rel_l2_card_f64=rel_l2(gg, ref_grad),
               walk_grad_rel_l2_cpu_f64=rel_l2(gc, ref_grad),
               walk_grad_rel_l2_card_cpu=rel_l2(gg, gc))
    out["walk_grad_limit"] = max(1e-3, 1.5 * out["walk_grad_rel_l2_cpu_f64"])
    assert out["loss_rel_card"] <= 1e-3 and out["loss_rel_cpu"] <= 1e-3, out
    assert np.isfinite(gg).all() and np.abs(ref_grad).max() > 0
    assert out["walk_grad_rel_l2_card_f64"] <= out["walk_grad_limit"], out
    return out


def geo_phase(dev, refs=None):
    """Phase 29: the seven geometric tasks at SIZE px, full width, linear_w,
    B=BATCH: per task a warmup step and GEO_STEPS counted steps (ms, peak
    GB, launches equal to GEO_STEPS x geometric_step_launches()), its target
    and mask on the card against the CPU; zoom with --trainEmbed for
    GEO_EMBED_STEPS steps; zoom's and colorlab's step against f64."""
    import dataclasses

    import numpy as np
    import torch

    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.engine.train import geometric_train_loop
    from latent2im_tpu_torch.tasks.transforms import get_task
    from latent2im_tpu_torch.walks import init_walk

    per_step = geometric_step_launches()
    conf = geo_conf("zoom")
    t0 = time.perf_counter()
    ed, _, info = build_editor_from_options(conf)  # cuda: the default
    assert ed.d is None and ed.vgg is None and info["attr_list"] == ["zoom"]
    out = {"build_s": time.perf_counter() - t0, "per_step_launches": per_step, "tasks": {}}
    z = np.random.RandomState(63).randn(BATCH, ed.cfg.dim_z).astype(np.float32)
    imgs = ed.synthesize(ed.get_w(z))
    gen = torch.Generator().manual_seed(64)
    for name in GEO_TASKS + ("zoom_embed",):
        task_name, kind = (("zoom", "embed") if name == "zoom_embed" else (name, "linear_w"))
        ed.cfg = dataclasses.replace(ed.cfg, attr_list=(task_name,), walk_kind=kind)
        task = get_task(task_name)
        walk = init_walk(kind, ed.cfg.dim_z, ed.cfg.n_latent, [task_name], generator=gen,
                         device=ed.device)
        steps = GEO_EMBED_STEPS if kind == "embed" else GEO_STEPS
        walk, r = _timed_train(ed, task, walk, steps, conf.learning_rate,
                               loop=geometric_train_loop)
        expect = {k: steps * v for k, v in per_step.items()}
        assert r["launches"] == expect, (name, r["launches"], expect)
        if kind == "linear_w":
            r["targets"] = geo_targets_check(name, task, imgs)
        out["tasks"][name] = r
    del ed, walk, imgs
    torch.cuda.empty_cache()
    out["grad"] = {name: geo_grad_phase(name, refs and refs.get(f"geo_{name}"))
                   for name in ("zoom", "colorlab")}
    return out


def geo_hi_phase(dev):
    """Phase 30: zoom at SIZE_HI px, B=GEO_BATCH_HI: a warmup step and
    GEO_HI_STEPS counted ones (ms, peak GB, launches)."""
    import torch

    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.engine.train import geometric_train_loop
    from latent2im_tpu_torch.tasks.transforms import get_task

    conf = geo_conf("zoom", size=SIZE_HI, batch=GEO_BATCH_HI)
    t0 = time.perf_counter()
    ed, walk, _ = build_editor_from_options(conf)  # cuda: the default
    out = {"build_s": time.perf_counter() - t0}
    walk, r = _timed_train(ed, get_task("zoom"), walk, GEO_HI_STEPS, conf.learning_rate,
                           loop=geometric_train_loop, batch=GEO_BATCH_HI)
    expect = {k: GEO_HI_STEPS * v
              for k, v in geometric_step_launches(SIZE_HI).items()}
    assert r["launches"] == expect, (r["launches"], expect)
    out.update(r)
    del ed, walk
    torch.cuda.empty_cache()
    return out


def geo_cli_phase():
    """Phase 31: the geometric CLI at SIZE px in chiprun_out/geo_cli/:
    ``cli.train --transform zoom`` (2 epochs of 2 steps, SIGTERM after the
    third step, --resume to the final checkpoint, whose walk reloads bit for
    bit), `python -m latent2im_tpu_torch.cli.vis_w` on that walk, the
    server with --save_path_w answering one /edit of BATCH, and
    ``--transform dsprites --attrList scale,posx`` for one epoch, whose
    sliders the device sampler declines (host sampling). Host-clock
    seconds per part."""
    import io
    import shutil
    import signal

    import numpy as np
    import torch

    from latent2im_tpu_torch.cli import train as tcli
    from latent2im_tpu_torch.cli.serve import build_service
    from latent2im_tpu_torch.config.options import VisOptions
    from latent2im_tpu_torch.io import checkpoint as ckpt

    root = os.path.join(REPO, "chiprun_out", "geo_cli")
    shutil.rmtree(root, ignore_errors=True)
    out = {"seconds": {}}
    fired = {"n": 0, "kill": True}
    real_loop = tcli.geometric_train_loop

    def loop(*a, **kw):  # SIGTERM after the 3rd step
        on_step = kw["on_step"]

        def killing_on_step(epoch, i, metrics, dt, wp):
            on_step(epoch, i, metrics, dt, wp)
            fired["n"] += 1
            if fired["kill"] and fired["n"] == 3:
                os.kill(os.getpid(), signal.SIGTERM)

        kw.update(on_step=killing_on_step)
        return real_loop(*a, **kw)

    args = ["--num_samples", str(2 * BATCH), "--n_epochs", "2", "--model_save_freq", "1"]
    t0 = time.perf_counter()
    tcli.geometric_train_loop = loop
    try:
        opt = geo_conf("zoom", *args, root=root, print_opt=True)
        _, first = tcli.run(opt)  # cuda: the entry point's default
        preempted = ckpt.find_resume(opt.output_dir)
        meta = ckpt.load_meta(preempted)
        assert meta.get("preempted") is True and len(first) == 3, (preempted, meta, first)
        fired["kill"] = False
        walk, history = tcli.run(geo_conf("zoom", *args, "--resume", root=root))
    finally:
        tcli.geometric_train_loop = real_loop
    torch.cuda.synchronize()
    out["seconds"]["train_sigterm_resume"] = time.perf_counter() - t0
    assert len(history) == 2 and all(math.isfinite(h) for h in history), history
    final = os.path.join(opt.output_dir, "model_w_2_final_walk_module.ckpt")
    back, _, _ = ckpt.load_walk(final, {"w": torch.zeros_like(walk["w"])})
    assert torch.equal(back["w"], walk["w"].detach())
    assert os.listdir(os.path.join(opt.output_dir, "results")) == []  # no sample grids
    out.update(preempted_at=os.path.basename(preempted), preempt_meta=meta)

    t0 = time.perf_counter()
    vis_dir = os.path.join(root, "vis")
    out["vis_pngs"] = vis_w_here(vis_dir, ["sample0_", "sample1_"],
                                 os.path.join(opt.output_dir, "opt.yml"), "--save_path_w", final,
                                 "--num_samples", "2", "--num_panels", "5",
                                 "--min_alpha", "0.5", "--max_alpha", "2")
    out["seconds"]["vis_w"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    vo = VisOptions()
    vo.parser.add_argument("--serve_batch", type=int, default=BATCH)
    vopt, conf = vo.parse([os.path.join(opt.output_dir, "opt.yml"), "--save_path_w", final,
                           "--num_panels", str(PANELS), "--min_alpha", "0.5",
                           "--max_alpha", "2"])
    service = build_service(vopt, conf)
    service.warmup()
    assert torch.equal(service.walk["w"], walk["w"].detach())
    with serving(service) as url:
        reply, ims = _post(url + "/edit", {"seed": 5, "num_samples": BATCH, "alpha": 0.7})
    assert len(ims) == BATCH and all(im.shape == (SIZE, SIZE, 3) for im in ims)
    assert np.isfinite(reply["alpha_org"]).all()
    out["seconds"]["serve_edit"] = time.perf_counter() - t0
    del service

    t0 = time.perf_counter()
    note = io.StringIO()
    with contextlib.redirect_stdout(note):
        _, dhist = tcli.run(train_conf("--transform", "dsprites", "--attrList", "scale,posx",
                                       "--num_samples", str(2 * BATCH), "--n_epochs", "1",
                                       "--model_save_freq", "0", root=root))
    torch.cuda.synchronize()
    assert "falling back to host-numpy sampling" in note.getvalue(), note.getvalue()[-2000:]
    assert len(dhist) == 2 and all(math.isfinite(h) for h in dhist), dhist
    out["seconds"]["dsprites_epoch"] = time.perf_counter() - t0
    out["dsprites_losses"] = dhist
    return out


def parity_phase(dev):
    """Phase 32: ``python -m latent2im_tpu_torch.cli.parity_check``'s main:
    ``record`` on the CPU, then ``compare`` on the card, with the same
    weights (the build's seed) and z seed, and LPIPS with seeded heads and
    a seeded vgg16 written here: max-abs, PSNR, the VGG-feature distance,
    the score difference and LPIPS, within phase 6's card-against-CPU bounds
    (images 1e-3 relative L2 and max-abs, scores 1e-3 of max(1, max|s|))."""
    import contextlib as cl
    import io
    import tempfile

    import numpy as np
    import torch

    from latent2im_tpu_torch.cli import parity_check
    from latent2im_tpu_torch.models.lpips import LPIPS

    out = {}
    with tempfile.TemporaryDirectory() as root:
        net = LPIPS(generator=torch.Generator().manual_seed(65))
        sd = net.state_dict()
        lpips_path, vgg16_path = (os.path.join(root, f) for f in ("lpips_vgg.pth", "vgg16.pth"))
        torch.save({k: v for k, v in sd.items() if k.startswith("lin")}, lpips_path)
        torch.save({k[len("vgg."):]: v for k, v in sd.items() if k.startswith("vgg.")},
                   vgg16_path)
        ref = os.path.join(root, "cpu.npz")
        flags = ["--resolution", str(SIZE), "--n", str(CMP_BATCH), "--seed", "66"]
        text = io.StringIO()
        t0 = time.perf_counter()
        with cl.redirect_stdout(text):
            parity_check.main(["record", "--out", ref, "--device", "cpu", *flags])
        out["record_cpu_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with cl.redirect_stdout(text):
            report = parity_check.main(["compare", "--ref", ref, *flags, "--lpips_path",
                                        lpips_path, "--vgg16_path", vgg16_path])
        out["compare_card_s"] = time.perf_counter() - t0
        recorded = np.load(ref)
        cpu_imgs, cpu_scores = recorded["images"], recorded["scores"]
    assert "lpips:" in text.getvalue()
    out.update(report)
    # the images' relative L2 from the report's PSNR (an MSE over [-1, 1])
    mse = 4.0 / 10 ** (report["psnr_db"] / 10)
    out["images_rel_l2"] = math.sqrt(mse * cpu_imgs.size) / float(np.linalg.norm(cpu_imgs))
    # phase 6's card-against-CPU bounds: images 1e-3 (relative L2, and here
    # max-abs at their unit scale), scores 1e-3 of max(1, max|score|)
    assert out["images_rel_l2"] < 1e-3 and report["max_abs_pixel_diff"] <= 1e-3, out
    assert report["max_abs_score_diff"] <= 1e-3 * max(1.0, float(np.abs(cpu_scores).max())), out
    assert all(math.isfinite(v) for k, v in report.items() if k != "psnr_db"), report
    assert 0 <= report["lpips"] < 1e-4, report  # LPIPS of images this close
    return out


def geo_phases(card, dev, refs=None):
    """Phases 29-32 -> their reports and, under "launches", the counted
    geometric steps' launch counts (geo_256: all tasks of phase 29,
    geo_1024: phase 30)."""
    import torch

    phase(29, f"the geometric and color walks at {SIZE} px ({', '.join(GEO_TASKS)}), "
          f"linear_w, B={BATCH}: steps, targets card against CPU, zoom --trainEmbed, "
          "zoom's and colorlab's step against f64")
    geo = geo_phase(dev, refs)
    for name, r in geo["tasks"].items():
        log(f"    {name}: {r['step_ms_cuda_events']:.2f} ms per step (CUDA events over "
            f"{r['steps']}), peak {r['peak_mem_gb']:.2f} GB, loss {r['first']['loss']:.4f} -> "
            f"{r['last']['loss']:.4f}; targets {json.dumps(r.get('targets'))}, on {card}")
    log(f"    step against f64 {json.dumps(geo['grad'])}")
    torch.cuda.empty_cache()

    phase(30, f"zoom at {SIZE_HI} px, B={GEO_BATCH_HI}")
    hi = geo_hi_phase(dev)
    log(f"    {hi['step_ms_cuda_events']:.2f} ms per step (CUDA events over {hi['steps']}), "
        f"peak {hi['peak_mem_gb']:.2f} GB, on {card}")
    torch.cuda.empty_cache()

    phase(31, "the geometric CLI: train --transform zoom + SIGTERM + --resume, vis_w "
          "(python -m), serve --save_path_w, --transform dsprites through the host sampler")
    cli = geo_cli_phase()
    log(f"    wall seconds {json.dumps(cli['seconds'])}; preempted at {cli['preempted_at']}, "
        f"vis_w wrote {cli['vis_pngs']}, dsprites losses {cli['dsprites_losses']}, on {card}")
    torch.cuda.empty_cache()

    phase(32, "parity_check: record on the CPU, compare on the card with LPIPS")
    par = parity_phase(dev)
    log(f"    {json.dumps(par)}, on {card}")
    torch.cuda.empty_cache()
    geo_counts = dict.fromkeys(SOURCE, 0)
    for r in geo["tasks"].values():
        for k, v in r["launches"].items():
            geo_counts[k] += v
    return {"geo": geo, "hi": hi, "cli": cli, "parity": par,
            "launches": {"geo_256": geo_counts, "geo_1024": hi["launches"]}}


# ---------------------------------------------------------------------------
# phases 33-37: bf16 compute (--bf16)
# ---------------------------------------------------------------------------

# the JAX package's bench configurations in bf16 (bench.py:72-79): the 1024 px
# edit at B=32 and the 256 px training at B=16
BF16_EDIT_BATCH_HI, BF16_TRAIN_BATCH = 32, 16
BF16_REQUESTS, BF16_STEPS, BF16_HI_STEPS, BF16_GAN_ITERS = 5, 5, 3, 3
# images card against CPU, both bf16: tests/helpers.py's TPU-class gate
# (relative L2), which tests/test_torch_bf16.py applies to the JAX package's
# bf16; the scores to the same share of max(1, |score|)
BF16_IMG_REL_L2 = 0.02
MLP_FUSED_ACT = 8  # the style MLP's fused_act launches per get_w: f32 under --bf16


def bf16_conf(*flags, size=None, batch=None, root=None, print_opt=False):
    return train_conf("--bf16", *flags, size=size, batch=batch, root=root,
                      print_opt=print_opt)


def _bf16_only(counts, counts_bf16, mlp_fused_act):
    """Every launch is a bf16 instance's but the style MLP's f32 fused_act."""
    want = {**counts, "fused_act": counts["fused_act"] - mlp_fused_act}
    assert counts_bf16 == want, (counts, counts_bf16, mlp_fused_act)


def bf16_serve_phase(results, dev):
    """Phase 34: the SIZE px edit server with --bf16: BF16_REQUESTS /edit of
    BATCH over HTTP (p50, img/s; the launches of as many f32 apply_alpha
    calls, all bf16 instances but the style MLP's), apply_alpha at B=BATCH
    by CUDA events; at B=1 the bf16 image's distance from the f32 one (the
    same editor with compute_dtype f32) and the card against the CPU, both
    bf16."""
    import argparse
    import dataclasses

    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.cli.serve import build_service
    from latent2im_tpu_torch.engine.build import build_editor_from_options

    conf = bf16_conf()
    opt = argparse.Namespace(save_path_w=None, save_path_gan=None, attrList=None, attrPath="",
                             num_panels=PANELS, min_alpha=0.0, max_alpha=1.0, serve_batch=BATCH)
    t0 = time.perf_counter()
    service = build_service(opt, conf)  # cuda: the entry point's default
    ed = service.ed
    assert ed.cfg.compute_dtype == torch.bfloat16 and ed.device.type == dev.type
    service.warmup()
    torch.cuda.synchronize()
    out = {"build_and_warmup_s": time.perf_counter() - t0}
    per_alpha = {n: r["apply_alpha"]["launches"] for n, r in results.items()}
    with serving(service) as url:
        ops.reset_launches()
        lat, n_img = [], 0
        t_all = time.perf_counter()
        for i in range(BF16_REQUESTS):
            t = time.perf_counter()
            reply = _request(url + "/edit", {"seed": 60 + i, "num_samples": BATCH,
                                             "alpha": 0.7})
            lat.append((time.perf_counter() - t) * 1e3)
            n_img += len(reply["images"])
        wall = time.perf_counter() - t_all
        torch.cuda.synchronize()
        counts, counts_bf16 = ops.launch_counts(), ops.launch_counts(bf16=True)
    expect = {k: BF16_REQUESTS * v for k, v in per_alpha.items()}
    assert counts == expect, (counts, expect)
    _bf16_only(counts, counts_bf16, BF16_REQUESTS * MLP_FUSED_ACT)
    assert n_img == BF16_REQUESTS * BATCH
    assert all(math.isfinite(v) for a in reply["alpha_org"] for v in a)
    z = np.random.RandomState(61).randn(BATCH, service.dim_z).astype(np.float32)
    a = np.full((BATCH,), 0.7, np.float32)
    out.update(p50_request_ms=statistics.median(lat), img_per_s=n_img / wall,
               requests=len(lat), launches=counts, launches_bf16=counts_bf16,
               apply_alpha_b4_ms=time_ms(lambda: ed.apply_alpha(service.walk, z, a, u8=True),
                                         warmup=2, iters=10),
               profile=profile_call(lambda: ed.apply_alpha(service.walk, z, a, u8=True),
                                    "apply_alpha_bf16_trace.json"))
    z1 = np.random.RandomState(7).randn(1, service.dim_z).astype(np.float32)
    a1 = np.asarray([0.8], np.float32)
    ge, ga, go = (v.cpu().numpy() for v in ed.apply_alpha(service.walk, z1, a1))
    cfg = ed.cfg
    ed.cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    try:
        fe, fa, fo = (v.cpu().numpy() for v in ed.apply_alpha(service.walk, z1, a1))
    finally:
        ed.cfg = cfg
    out["bf16_vs_f32"] = {"edited_rel_l2": rel_l2(ge, fe), "orig_rel_l2": rel_l2(go, fo),
                          "alpha_org_abs": float(np.abs(ga - fa).max()),
                          "alpha_org_f32": float(fa[0, 0])}
    t = time.perf_counter()
    cpu_ed, cpu_walk, _ = build_editor_from_options(conf, device="cpu")
    ce, ca, co = (v.numpy() for v in cpu_ed.apply_alpha(cpu_walk, z1, a1))
    out["cpu_apply_alpha_s"] = time.perf_counter() - t
    for name, g, c in (("edited", ge, ce), ("orig", go, co)):
        assert np.isfinite(g).all() and g.shape == (1, SIZE, SIZE, 3)
        out[f"card_vs_cpu_{name}_rel_l2"] = rel = rel_l2(g, c)
        assert rel < BF16_IMG_REL_L2, (name, rel)
    out["card_vs_cpu_alpha_org_abs"] = err = float(np.abs(ga - ca).max())
    assert err <= BF16_IMG_REL_L2 * max(1.0, float(np.abs(ca).max())), (ga, ca)
    del service, ed, cpu_ed
    torch.cuda.empty_cache()
    return out


def bf16_edit_1024_phase(dev):
    """Phase 35: the JAX package's own edit configuration, apply_alpha at
    SIZE_HI px in bf16 (bench.py:72-73,302): B=BF16_EDIT_BATCH_HI and
    B=BATCH_HI, ms by CUDA events, img/s, peak GB."""
    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.engine.build import build_editor_from_options

    conf = bf16_conf("--no_gan_loss", "--no_content_loss", size=SIZE_HI, batch=BATCH_HI)
    t0 = time.perf_counter()
    ed, walk, _ = build_editor_from_options(conf)
    assert ed.cfg.compute_dtype == torch.bfloat16
    out = {"build_s": time.perf_counter() - t0}
    ops.reset_launches()
    for b in (BATCH_HI, BF16_EDIT_BATCH_HI):
        z = np.random.RandomState(62).randn(b, ed.cfg.dim_z).astype(np.float32)
        a = np.full((b,), 0.7, np.float32)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        edited, _, orig = ed.apply_alpha(walk, z, a)
        assert edited.shape == (b, SIZE_HI, SIZE_HI, 3) and torch.isfinite(edited).all()
        assert not torch.equal(edited, orig)
        del edited, orig
        ms = time_ms(lambda: ed.apply_alpha(walk, z, a, u8=True), warmup=1,
                     iters=5 if b == BATCH_HI else 3)
        out[f"b{b}"] = {"ms": ms, "img_per_s": b * 1e3 / ms,
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    torch.cuda.synchronize()
    out["launches"], out["launches_bf16"] = ops.launch_counts(), ops.launch_counts(bf16=True)
    assert all(out["launches_bf16"][k] > 0 for k in FORWARD), out
    del ed, walk
    torch.cuda.empty_cache()
    return out


def bf16_grad_phase():
    """One bf16 step (SIZE px, B=CMP_BATCH, stored noise, host alphas) on the
    card: the walk gradient with the kernels against an f64 reference on
    the card (the towers in f64 through plain_kernels()), held within
    max(1e-3, 1.5 x the distance of the same bf16 step through
    plain_kernels() from it): bf16's own rounding sets the scale, never
    f32's bound."""
    import numpy as np
    import torch

    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.engine.train import make_optimizer, make_train_step
    from latent2im_tpu_torch.tasks.transforms import get_task
    from latent2im_tpu_torch.walks import walk_leaves, walk_map

    conf = bf16_conf("--fixed_noise")
    ed, walk, _ = build_editor_from_options(conf)
    z = np.random.RandomState(8).randn(CMP_BATCH, ed.cfg.dim_z).astype(np.float32)
    sampled, _ = get_task("face").train_alpha_np(np.random.RandomState(9), CMP_BATCH, 1)
    w0 = walk_map(lambda t: t.detach().cpu().numpy().copy(), walk)
    out, grads = {}, {}
    for name, ctx in (("kernels", contextlib.nullcontext()), ("plain", plain_kernels())):
        w = walk_map(lambda a: torch.tensor(a, device=ed.device).requires_grad_(True), w0)
        step = make_train_step(ed, None, make_optimizer(w, conf.learning_rate), host_alpha=True)
        with ctx:
            m = step(w, z, sampled=sampled)
        out[f"{name}_loss"] = float(m["loss"])
        grads[name] = np.concatenate([p.grad.detach().double().cpu().numpy().ravel()
                                      for p in walk_leaves(w)])
    t = time.perf_counter()
    with plain_kernels():
        for mod in (ed.g, ed.reg, ed.vgg, ed.d):
            mod.double()
        ref, ref_grad, _ = reference_step(ed, w0, z, sampled, torch.float64)
    out["f64_reference_s"] = time.perf_counter() - t
    out["f64_loss"] = ref["loss"]
    out["walk_grad_rel_l2_kernels_f64"] = rel_l2(grads["kernels"], ref_grad)
    out["walk_grad_rel_l2_plain_f64"] = rel_l2(grads["plain"], ref_grad)
    out["walk_grad_rel_l2_kernels_plain"] = rel_l2(grads["kernels"], grads["plain"])
    out["limit"] = limit = max(1e-3, 1.5 * out["walk_grad_rel_l2_plain_f64"])
    assert np.isfinite(grads["kernels"]).all(), out
    assert out["walk_grad_rel_l2_kernels_f64"] <= limit, out
    del ed, walk
    torch.cuda.empty_cache()
    return out


def bf16_train_phase(results, dev):
    """Phase 36: train_loop with --bf16 at SIZE px, B=BATCH (the launches of
    as many f32 steps, all bf16 instances but the style MLP's) and
    B=BF16_TRAIN_BATCH, and at SIZE_HI px, B=BATCH_HI (plain); ms per step
    by CUDA events, samples/s, peak GB; then the walk gradient against f64."""
    import numpy as np
    import torch

    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.engine.train import make_optimizer, make_train_step
    from latent2im_tpu_torch.tasks.transforms import get_task

    task = get_task("face")
    per_step = {n: r["train_step"]["launches"] for n, r in results.items()}
    out = {}
    for name, size, b, steps in (("b4", SIZE, BATCH, BF16_STEPS),
                                 ("b16", SIZE, BF16_TRAIN_BATCH, BF16_STEPS),
                                 (f"{SIZE_HI}_b8", SIZE_HI, BATCH_HI, BF16_HI_STEPS)):
        conf = bf16_conf(size=size, batch=b)
        ed, walk, _ = build_editor_from_options(conf)
        assert ed.cfg.compute_dtype == torch.bfloat16
        walk, r = _timed_train(ed, task, walk, steps, conf.learning_rate, batch=b)
        r["samples_per_s"] = b * 1e3 / r["step_ms_cuda_events"]
        r["size"] = size
        if name == "b4":
            expect = {k: steps * v for k, v in per_step.items()}
            assert r["launches"] == expect, (r["launches"], expect)
            z = torch.from_numpy(np.random.RandomState(2).randn(b, ed.cfg.dim_z)
                                 .astype(np.float32))
            gen = torch.Generator(device=dev).manual_seed(0)
            step = make_train_step(ed, task, make_optimizer(walk, conf.learning_rate))
            r["profile"] = profile_call(lambda: step(walk, z, gen), "train_step_bf16_trace.json")
        _bf16_only(r["launches"], r["launches_bf16"], steps * MLP_FUSED_ACT)
        out[name] = r
        log(f"    {size} px B={b}: {r['step_ms_cuda_events']:.2f} ms per step (CUDA events "
            f"over {steps}), {r['samples_per_s']:.2f} samples/s, peak {r['peak_mem_gb']:.2f} "
            f"GB, loss {r['first']['loss']:.4f} -> {r['last']['loss']:.4f}")
        del ed, walk
        torch.cuda.empty_cache()
    out["grad"] = bf16_grad_phase()
    return out


def bf16_cli_phase(dev):
    """Phase 37: --bf16 through the CLIs at SIZE px (chiprun_out/cli_bf16/):
    train with a SIGTERM after the second step and --resume, `python -m
    latent2im_tpu_torch.cli.vis_w` on its opt.yml (bf16: true) and walk, the
    server's /edit of BATCH; --bf16 --updateGAN for BF16_GAN_ITERS
    iterations (ms per D and G step); model_256 PGGAN --bf16 apply_alpha and
    one step, which launch no kernel."""
    import shutil
    import signal

    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.cli import train as tcli
    from latent2im_tpu_torch.cli.serve import build_service
    from latent2im_tpu_torch.config.options import TrainOptions, VisOptions
    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.io import checkpoint as ckpt
    from latent2im_tpu_torch.tasks.transforms import get_task

    root = os.path.join(REPO, "chiprun_out", "cli_bf16")
    shutil.rmtree(root, ignore_errors=True)
    out = {"seconds": {}, "launches": {}, "launches_bf16": {}}
    fired = {"n": 0, "kill": True}
    real_loop = tcli.train_loop

    def loop(*a, **kw):  # SIGTERM after the 2nd step
        on_step = kw["on_step"]

        def killing_on_step(epoch, i, metrics, dt, wp):
            on_step(epoch, i, metrics, dt, wp)
            fired["n"] += 1
            if fired["kill"] and fired["n"] == 2:
                os.kill(os.getpid(), signal.SIGTERM)

        kw["on_step"] = killing_on_step
        return real_loop(*a, **kw)

    t0 = time.perf_counter()
    args = _cli_args(root, "Smiling", 2 * BATCH, 2, "--model_save_freq", "1", "--bf16")
    tcli.train_loop = loop
    try:
        ops.reset_launches()
        opt = TrainOptions().parse(args, print_opt=True)
        tcli.run(opt)  # cuda: the entry point's default
        run_dir = opt.output_dir
        meta = ckpt.load_meta(ckpt.find_resume(run_dir))
        assert meta.get("preempted") is True, meta
        fired["kill"] = False
        walk, history = tcli.run(TrainOptions().parse(args + ["--resume"], print_opt=False))
    finally:
        tcli.train_loop = real_loop
    torch.cuda.synchronize()
    counts, counts_bf16 = ops.launch_counts(), ops.launch_counts(bf16=True)
    out["launches"]["train"], out["launches_bf16"]["train"] = counts, counts_bf16
    out["seconds"]["train_sigterm_resume"] = time.perf_counter() - t0
    assert all(counts_bf16[k] == counts[k] > 0 for k in counts if k != "fused_act"), out
    assert (counts["fused_act"] - counts_bf16["fused_act"]) % MLP_FUSED_ACT == 0, out
    assert all(math.isfinite(h) for h in history), history
    yml = os.path.join(run_dir, "opt.yml")
    with open(yml) as f:
        assert "bf16: true" in f.read().splitlines()
    final_path = os.path.join(run_dir, "model_w_2_final_walk_module.ckpt")
    assert os.path.isfile(final_path) and walk["w"].dtype == torch.float32
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    vis_dir = os.path.join(root, "vis")
    out["vis_pngs"] = vis_w_here(vis_dir, ["sample0_", "sample1_"], yml, "--save_path_w",
                                 final_path, "--num_samples", "2", "--num_panels", "5")
    out["seconds"]["vis_w"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    vo = VisOptions()
    vo.parser.add_argument("--serve_batch", type=int, default=BATCH)
    vopt, conf = vo.parse([yml, "--save_path_w", final_path, "--num_panels", str(PANELS)])
    service = build_service(vopt, conf)
    assert service.ed.cfg.compute_dtype == torch.bfloat16
    service.warmup()
    z = np.random.RandomState(63).randn(BATCH, service.dim_z).astype(np.float32)
    with serving(service) as url:
        ops.reset_launches()
        reply = _request(url + "/edit", {"z": z.tolist(), "alpha": 0.7})
        torch.cuda.synchronize()
        counts, counts_bf16 = ops.launch_counts(), ops.launch_counts(bf16=True)
    out["launches"]["serve"], out["launches_bf16"]["serve"] = counts, counts_bf16
    _bf16_only(counts, counts_bf16, MLP_FUSED_ACT)
    assert len(reply["images"]) == BATCH and all(counts[k] > 0 for k in FORWARD)
    out["seconds"]["serve_edit"] = time.perf_counter() - t0
    del service
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    out["gan"] = gan = gan_train_phase(dev, "--bf16", iters=BF16_GAN_ITERS)
    assert all(v > 0 for v in gan["launches_bf16"].values()), gan["launches_bf16"]
    out["seconds"]["update_gan"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    conf = pggan_conf("--bf16")
    ed, walk, _ = build_editor_from_options(conf)
    assert ed.cfg.compute_dtype == torch.bfloat16
    z = np.random.RandomState(64).randn(BATCH, 512).astype(np.float32)
    a = np.full((BATCH,), 0.3, np.float32)
    ops.reset_launches()
    edited, _, orig = ed.apply_alpha(walk, z, a)
    assert torch.isfinite(edited).all() and edited.shape == (BATCH, SIZE // 2, SIZE // 2, 3)
    assert not torch.equal(edited, orig)
    pg = {"apply_alpha_ms_cuda_events": time_ms(lambda: ed.apply_alpha(walk, z, a),
                                                warmup=2, iters=10)}
    torch.cuda.synchronize()
    assert set(ops.launch_counts().values()) == {0}, ops.launch_counts()
    task = get_task(conf.transform, walk_type=conf.walk_type, nsliders=1)
    walk, pg["train"] = _timed_train(ed, task, walk, 1, conf.learning_rate)
    assert set(pg["train"]["launches"].values()) == {0}, pg["train"]["launches"]
    out["pggan"] = pg
    del ed, walk
    torch.cuda.empty_cache()
    return out


def bf16_phases(card, dev, results, hi):
    """Phases 33-37 -> the bf16 kernel results at SIZE and SIZE_HI px, their
    errors and details, the bf16 paths' launch counts of the bf16 instances
    (under "launches") and the phases' reports."""
    import torch

    out = {"launches": {}}
    phase(33, f"the bf16 kernels against their plain bf16 versions at the {SIZE} px B={BATCH} "
          f"and {SIZE_HI} px B={BATCH_HI} shapes")
    out["results"], out["max_err"], out["details"] = kernel_phase(
        dev, SIZE, BATCH, iters=10, dtype=torch.bfloat16)
    out["results_hi"], max_hi, details_hi = kernel_phase(
        dev, SIZE_HI, BATCH_HI, iters=5, dtype=torch.bfloat16)
    out["max_err"] = {k: max(v, max_hi[k]) for k, v in out["max_err"].items()}
    out["details"] += details_hi
    torch.cuda.empty_cache()

    phase(34, f"the {SIZE} px edit server with --bf16")
    sv = out["serve"] = bf16_serve_phase(results, dev)
    out["launches"]["serve_bf16"] = sv.pop("launches_bf16")
    log(f"    /edit of {BATCH} p50 {sv['p50_request_ms']:.1f} ms, {sv['img_per_s']:.2f} img/s, "
        f"apply_alpha B={BATCH} {sv['apply_alpha_b4_ms']:.2f} ms (CUDA events); bf16 against "
        f"f32 {json.dumps(sv['bf16_vs_f32'])}; card against CPU edited "
        f"{sv['card_vs_cpu_edited_rel_l2']:.3e}, orig {sv['card_vs_cpu_orig_rel_l2']:.3e}, "
        f"scores {sv['card_vs_cpu_alpha_org_abs']:.3e}, on {card}")
    log(f"    apply_alpha B={BATCH} under torch.profiler: {json.dumps(sv['profile'])}")

    phase(35, f"apply_alpha at {SIZE_HI} px in bf16, B={BF16_EDIT_BATCH_HI} and B={BATCH_HI}")
    ed = out["edit_1024"] = bf16_edit_1024_phase(dev)
    out["launches"]["edit_1024_bf16"] = ed.pop("launches_bf16")
    log(f"    {json.dumps({k: v for k, v in ed.items() if k != 'launches'})}; f32 B={BATCH_HI} "
        f"{hi['edit']['apply_alpha_b8_device_ms']:.2f} ms (phase 13), on {card}")

    phase(36, f"walk training with --bf16: {SIZE} px B={BATCH} and B={BF16_TRAIN_BATCH}, "
          f"{SIZE_HI} px B={BATCH_HI}; the walk gradient against f64")
    tr = out["train"] = bf16_train_phase(results, dev)
    for k in ("b4", "b16", f"{SIZE_HI}_b8"):
        out["launches"][f"train_bf16_{k}"] = tr[k].pop("launches_bf16")
    log(f"    one step (B={BATCH}) under torch.profiler: {json.dumps(tr['b4']['profile'])}")
    log(f"    step against f64 {json.dumps(tr['grad'])}, on {card}")

    phase(37, "--bf16 through the CLIs: train + SIGTERM + --resume, vis_w (python -m), "
          "/edit; --updateGAN; model_256 PGGAN")
    cli = out["cli"] = bf16_cli_phase(dev)
    for k in ("train", "serve"):
        out["launches"][f"cli_bf16_{k}"] = cli["launches_bf16"][k]
    out["launches"]["gan_bf16"] = cli["gan"]["launches_bf16"]
    log(f"    wall seconds {json.dumps(cli['seconds'])}; vis_w wrote {cli['vis_pngs']}; "
        f"--updateGAN {cli['gan']['iteration_ms_cuda_events']:.2f} ms per iteration, D step "
        f"{cli['gan']['d_step_ms_cuda_events']:.2f} ms, G step "
        f"{cli['gan']['g_step_ms_cuda_events']:.2f} ms, peak {cli['gan']['peak_mem_gb']:.2f} "
        f"GB; PGGAN apply_alpha {cli['pggan']['apply_alpha_ms_cuda_events']:.2f} ms, step "
        f"{cli['pggan']['train']['step_ms_cuda_events']:.2f} ms, on {card}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 38: JPEG input (the committed fixtures: this machine cannot write one)
# ---------------------------------------------------------------------------

JPEG_FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_jpeg")
JPEG_TIMED = {"218x178": "photo_218x178_420", "256x256": "photo_256_422",
              "1024x1024": "photo_1024_420"}
JPEG_BP_LOOPS, JPEG_GAN_ITERS = 10, 2


def jpeg_phase(dev):
    """Phase 38: every fixture of tests/fixtures/torch_jpeg/ decoded by
    utils/image.py:read_image_rgb, equal to its recorded Pillow decode
    (decodes.npz, and the SHA-256 of decodes.json); the host decode time per
    photo at 218x178, 256x256 and 1024x1024 (median of 3); then, on a
    directory of those JPEGs, ``python -m latent2im_tpu_torch.cli.bp`` at
    SIZE px (run in this process, counted) and JPEG_GAN_ITERS --updateGAN
    iterations after a warmup (gan_train_phase with the JPEGs as its real
    images). Its files go to a temporary directory, so that the output
    directory holds only the small results of the run."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        return _jpeg_phase(dev, root)


def _jpeg_phase(dev, root):
    import hashlib
    import runpy
    import shutil

    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.utils import image as imgmod

    with open(os.path.join(JPEG_FIXTURES, "decodes.json")) as f:
        meta = json.load(f)
    npz = np.load(os.path.join(JPEG_FIXTURES, "decodes.npz"))
    names = sorted(k for k in meta if k != "pillow")
    out = {"decode_ms": {}, "equal_to_pillow": {}}
    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir)
    for name in names:
        path = os.path.join(JPEG_FIXTURES, f"{name}.jpg")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = imgmod.read_image_rgb(path)
            times.append((time.perf_counter() - t0) * 1e3)
        ok = (list(got.shape) == meta[name]["shape"]
              and hashlib.sha256(got.tobytes()).hexdigest() == meta[name]["sha256"]
              and (name not in npz.files or np.array_equal(got, npz[name])))
        if not ok:
            raise AssertionError(f"{name}.jpg does not decode to its Pillow decode")
        out["equal_to_pillow"][name] = True
        out["decode_ms"][name] = statistics.median(times)
        shutil.copy(path, img_dir)
    out["decode_ms_per_photo"] = {k: out["decode_ms"][v] for k, v in JPEG_TIMED.items()}
    log(f"    {len(names)} fixtures equal to their Pillow decodes; host decode ms per photo "
        f"{json.dumps(out['decode_ms_per_photo'])}")

    save_dir = os.path.join(root, "bp")
    saved_argv = sys.argv
    sys.argv = ["bp", "--img_dir", img_dir, "--save_dir", save_dir, "--resolution", str(SIZE),
                "--n_loops", str(JPEG_BP_LOOPS), "--show_freq", "5",
                "--batch_size", str(BATCH)]
    t0 = time.perf_counter()
    try:
        ops.reset_launches()
        runpy.run_module("latent2im_tpu_torch.cli.bp", run_name="__main__")
        torch.cuda.synchronize()
        out["launches"] = {"bp_jpeg": ops.launch_counts()}
    finally:
        sys.argv = saved_argv
    out["bp_seconds"] = time.perf_counter() - t0
    assert all(out["launches"]["bp_jpeg"][k] > 0 for k in SOURCE), out["launches"]
    for bi, n in ((0, BATCH), (BATCH, len(names) - BATCH)):
        w = np.load(os.path.join(save_dir, "latent", f"{bi}_w.npy"))
        curve = np.load(os.path.join(save_dir, f"{bi}_loss.npy"))
        assert w.shape == (n, 2 * int(math.log2(SIZE)) - 2, 512) and np.isfinite(w).all()
        assert curve.shape == (JPEG_BP_LOOPS,) and np.isfinite(curve).all(), curve
        out[f"bp_loss_{bi}"] = (float(curve[0]), float(curve[-1]))
    log(f"    bp on {len(names)} JPEGs: {out['bp_seconds']:.1f} s, loss (first, last) "
        f"{out['bp_loss_0']}, {out[f'bp_loss_{BATCH}']}")
    torch.cuda.empty_cache()

    gan = out["gan"] = gan_train_phase(dev, iters=JPEG_GAN_ITERS, real_dir=img_dir)
    out["launches"]["gan_jpeg"] = gan.pop("launches")
    log(f"    --updateGAN on the JPEGs: {gan['iteration_ms_cuda_events']:.2f} ms per "
        f"iteration (CUDA events over {JPEG_GAN_ITERS}), D step "
        f"{gan['d_step_ms_cuda_events']:.2f} ms, G step {gan['g_step_ms_cuda_events']:.2f} ms, "
        f"{gan['samples_per_s']:.2f} samples/s on the host clock")
    return out


# ---------------------------------------------------------------------------
# phases 39-42: the regressor trainer, its loader, StyleGAN1 and compat
# ---------------------------------------------------------------------------

REG_SIZE, REG_BATCH, REG_WARMUP, REG_STEPS = 256, 32, 3, 10
REG_CMP_BATCH, REG_CMP_STEPS, REG_LR = 4, 3, 1e-4
REG_OUT = 40
# one step from the same state, card against CPU, both f32 (TF32 off): the
# loss and the running statistics come from one forward in another
# summation order; the parameters from Adam's sign-like first moves, where a
# gradient element near zero may flip (2 lr per element, as the CPU tests
# hold the port to the JAX package)
REG_LOSS_TOL, REG_STATS_TOL = 1e-4, 1e-4
REG_FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_regressor")
LOADER_BATCHES = 8
S1_STEPS = ((5, 2), (8, 1))  # (step, batch): 128 px and 1024 px
S1_TOL = 1e-4  # relative L2 of the image, card against CPU, f32


def _reg_batch(rng, b, size):
    import numpy as np

    return (rng.randint(0, 256, (b, size, size, 3)).astype(np.uint8),
            rng.uniform(0, 1, (b, REG_OUT)).astype(np.float32))


def _reg_state(model, opt):
    import copy

    return copy.deepcopy(model.state_dict()), copy.deepcopy(opt.state_dict())


def regressor_train_phase(dev):
    """Phase 39: ResNet-50 (40 outputs) trained as cli/train_regressor.py
    trains it, at REG_SIZE px, B=REG_BATCH, full width, seeded weights:
    REG_WARMUP steps, then REG_STEPS timed (CUDA events and the host clock),
    samples/s, peak GB, one step under torch.profiler (its trace in a
    temporary directory); then REG_CMP_STEPS
    steps at B=REG_CMP_BATCH held to the CPU, each card step from the CPU's
    state before it: the loss, the parameters (2 lr per element, and their
    relative L2) and the running statistics (relative L2)."""
    import tempfile

    import numpy as np
    import torch

    from latent2im_tpu_torch.cli import train_regressor as tr
    from latent2im_tpu_torch.models.resnet import ResNet50

    gen = torch.Generator().manual_seed(0)
    model = ResNet50(REG_OUT, generator=gen).to(dev, memory_format=torch.channels_last)
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    opt, train_step, eval_step = tr.make_steps(model, REG_LR)
    rng = np.random.RandomState(39)
    u8, lab = _reg_batch(rng, REG_BATCH, REG_SIZE)
    x, y = tr.normalize(u8, dev), torch.as_tensor(lab, device=dev)
    for _ in range(REG_WARMUP):
        loss = train_step(x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    losses = []
    t0 = time.perf_counter()
    ev[0].record()
    for _ in range(REG_STEPS):
        losses.append(train_step(x, y))
    ev[1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses = [float(v) for v in losses]
    assert all(math.isfinite(v) for v in losses), losses
    out = {"size": REG_SIZE, "batch": REG_BATCH, "steps": REG_STEPS,
           "step_ms_cuda_events": ev[0].elapsed_time(ev[1]) / REG_STEPS,
           "step_ms_host": wall * 1e3 / REG_STEPS,
           "samples_per_s": REG_STEPS * REG_BATCH / wall,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "loss_first_last": (losses[0], losses[-1]),
           "eval_loss": float(eval_step(x, y))}
    out["steps_per_s"] = 1e3 / out["step_ms_cuda_events"]
    with tempfile.TemporaryDirectory() as d:  # the output directory is near its 64 MiB
        out["profile"] = profile_call(lambda: train_step(x, y),
                                      os.path.join(d, "regressor_step_trace.json"))
    del opt, x, y
    torch.cuda.empty_cache()

    # card against CPU, one step at a time from the CPU's state
    cpu = ResNet50(REG_OUT)
    cpu.load_state_dict(init)
    card = ResNet50(REG_OUT).to(dev, memory_format=torch.channels_last)
    cpu_opt, cpu_step, _ = tr.make_steps(cpu, REG_LR)
    card_opt, card_step, _ = tr.make_steps(card, REG_LR)
    cmp_ = []
    t0 = time.perf_counter()
    for t in range(REG_CMP_STEPS):
        u8, lab = _reg_batch(rng, REG_CMP_BATCH, REG_SIZE)
        sd, osd = _reg_state(cpu, cpu_opt)
        card.load_state_dict(sd)
        card_opt.load_state_dict(osd)
        want = float(cpu_step(tr.normalize(u8, "cpu"), torch.from_numpy(lab)))
        got = float(card_step(tr.normalize(u8, dev), torch.as_tensor(lab, device=dev)))
        after_cpu, after_card = cpu.state_dict(), card.state_dict()
        row = {"step": t, "loss_cpu": want, "loss_card": got,
               "loss_rel": abs(got - want) / abs(want), "params_max_abs_over_lr": 0.0,
               "stats_rel_l2": 0.0}
        diff2 = norm2 = 0.0  # the parameters' relative L2, all of them as one vector
        for k, w in after_cpu.items():
            if k.endswith("num_batches_tracked"):
                continue
            g = after_card[k].detach().cpu().double()
            w = w.double()
            rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
            if k.endswith(("running_mean", "running_var")):
                row["stats_rel_l2"] = max(row["stats_rel_l2"], rel)
            else:
                slack = 2 * REG_LR + 2 * torch.maximum(g.abs(), w.abs()).float() * 2.0 ** -23
                assert bool(((g - w).abs() <= slack.double()).all()), (t, k)
                diff2 += float((g - w).pow(2).sum())
                norm2 += float(w.pow(2).sum())
                row["params_max_abs_over_lr"] = max(row["params_max_abs_over_lr"],
                                                    float((g - w).abs().max()) / REG_LR)
        row["params_rel_l2"] = math.sqrt(diff2 / norm2)
        assert row["loss_rel"] <= REG_LOSS_TOL and row["stats_rel_l2"] <= REG_STATS_TOL, row
        cmp_.append(row)
    out["cpu_vs_card"] = {"batch": REG_CMP_BATCH, "gates": {
        "loss_rel": REG_LOSS_TOL, "stats_rel_l2": REG_STATS_TOL,
        "params_abs": "2 lr per element"}, "steps": cmp_,
        "seconds": time.perf_counter() - t0}
    del card, card_opt, model
    torch.cuda.empty_cache()
    return out


def regressor_cli_phase():
    """Phase 40: ``python -m latent2im_tpu_torch.cli.train_regressor``
    (``run_module``) on tests/fixtures/torch_regressor/ (JPEGs and PNGs, a
    tab-separated label file, training.txt / test.txt) at REG_SIZE px, B=4,
    2 epochs with
    --export_torch: the print lines, the checkpoint names and meta, the
    msgpack restored into a ResNet50 and its Adam, the export loaded with
    strict=True. Its files (~0.75 GB) go to a temporary directory."""
    import tempfile

    import torch

    from latent2im_tpu_torch.cli import train_regressor as tr
    from latent2im_tpu_torch.models.resnet import ResNet50

    with tempfile.TemporaryDirectory() as root:
        ck = os.path.join(root, "ckpt")
        t0 = time.perf_counter()
        printed = run_module(
            "latent2im_tpu_torch.cli.train_regressor",
            "--data_dir", os.path.join(REG_FIXTURES, "imgs"),
            "--label_path", os.path.join(REG_FIXTURES, "annotations.tsv"),
            "--split_dir", os.path.join(REG_FIXTURES, "split"), "--ckpt_dir", ck,
            "--image_size", str(REG_SIZE), "--batch_size", "4", "--n_epochs", "2",
            "--export_torch")
        seconds = time.perf_counter() - t0
        lines = printed.strip().splitlines()
        assert lines[:2] == ["train 7 / test 3 images", "native loader: True"], lines
        assert lines[2].startswith("epoch 0 iter 0 Loss: ") and \
            lines[3].startswith("epoch 1 iter 0 Loss: "), lines
        assert lines[4].startswith("Test epoch 1; Loss: ") and len(lines) == 5, lines
        test_mse = float(lines[4].rsplit(" ", 1)[1])
        assert math.isfinite(test_mse), lines
        names = sorted(os.listdir(ck))
        assert names == ["001_dict.model", "001_dict.model.msgpack",
                         "001_dict.model.msgpack.meta.json", "002_dict.model",
                         "002_dict.model.msgpack", "002_dict.model.msgpack.meta.json"], names
        model = ResNet50(REG_OUT)
        opt = torch.optim.Adam(model.parameters(), lr=REG_LR)
        metas = [tr.load_regressor(os.path.join(ck, f"{e + 1:03d}_dict.model.msgpack"),
                                   model, opt) for e in (0, 1)]
        assert metas == [{"epoch": 0}, {"epoch": 1}], metas
        adam_steps = int(opt.state_dict()["state"][0]["step"])
        assert adam_steps == 4, adam_steps
        exported = torch.load(os.path.join(ck, "002_dict.model"), weights_only=True)
        assert exported["optm"] == {}
        ResNet50(REG_OUT).load_state_dict(exported["model"], strict=True)
        for k, v in exported["model"].items():
            if k.endswith("num_batches_tracked"):
                assert int(v) == 0, k
            else:
                assert torch.equal(v, model.state_dict()[k]), k
        sizes = {n: os.path.getsize(os.path.join(ck, n)) for n in names}
    return {"seconds": seconds, "lines": lines, "test_mse": test_mse, "metas": metas,
            "adam_steps": adam_steps, "bytes": sizes}


def _median_ms(fn, reps=3):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def loader_phase(dev, reg, gan_png, gan_jpeg):
    """Phase 41: the host decode per photo with the C entry
    (ops/csrc/jpeg_huffman.cpp) and with the Python version, at phase 38's
    three sizes, bit-equal; the centre-crop resize of the trainer's path
    (resample.cpp against numpy); the threaded loader's batches/s at
    B=REG_BATCH, REG_SIZE px (utils/loader.py, one thread and its pool, each
    a first and a second pass) against the trainer's steps/s of phase 39,
    and LOADER_BATCHES - 1 trainer steps fed by it; the --updateGAN iteration on JPEGs (phase 38)
    against PNGs (phase 21)."""
    import numpy as np
    import torch

    from latent2im_tpu_torch.cli import train_regressor as tr
    from latent2im_tpu_torch.models.resnet import ResNet50
    from latent2im_tpu_torch.utils import image as imgmod
    from latent2im_tpu_torch.utils import jpeg
    from latent2im_tpu_torch.utils.loader import Loader, default_threads

    out = {"decode_ms": {}, "load_resize_ms": {}}
    for label, name in JPEG_TIMED.items():
        with open(os.path.join(JPEG_FIXTURES, f"{name}.jpg"), "rb") as f:
            data = f.read()
        c = jpeg.jpeg_decode_rgb(data, host_cpp=True)
        py = jpeg.jpeg_decode_rgb(data)
        assert c.shape == py.shape and np.array_equal(c, py), name
        out["decode_ms"][label] = {
            "c": _median_ms(lambda: jpeg.jpeg_decode_rgb(data, host_cpp=True)),
            "python": _median_ms(lambda: jpeg.jpeg_decode_rgb(data))}
        path = os.path.join(JPEG_FIXTURES, f"{name}.jpg")
        assert np.array_equal(imgmod.pillow_load_and_resize(path, REG_SIZE, host_cpp=True),
                              imgmod.pillow_load_and_resize(path, REG_SIZE))
        out["load_resize_ms"][label] = {
            "c": _median_ms(lambda: imgmod.pillow_load_and_resize(path, REG_SIZE, True)),
            "python": _median_ms(lambda: imgmod.pillow_load_and_resize(path, REG_SIZE))}
    log(f"    decode ms per photo (C, Python): {json.dumps(out['decode_ms'])}")
    log(f"    decode + centre crop + resize to {REG_SIZE} px (C, Python): "
        f"{json.dumps(out['load_resize_ms'])}")

    # the trainer's loader on CelebA-sized and 256 px photos
    photos = [os.path.join(JPEG_FIXTURES, f"{n}.jpg")
              for n in ("photo_218x178_420", "photo_256_422")]
    paths = [photos[i % 2] for i in range(LOADER_BATCHES * REG_BATCH)]
    idx = list(tr.index_batches(np.arange(len(paths)), REG_BATCH))
    rates = {}
    for threads in (1, default_threads()):
        for turn in ("cold", "warm"):  # the process's first pass, then another
            with Loader(lambda i: imgmod.load_and_resize_image(paths[i], REG_SIZE, True),
                        threads=threads) as loader:
                t0 = time.perf_counter()
                n = sum(1 for b, _ in loader.batches(idx)
                        if b.shape == (REG_BATCH, REG_SIZE, REG_SIZE, 3))
                rates[f"{threads}_{turn}"] = n / (time.perf_counter() - t0)
            assert n == LOADER_BATCHES, n
    out["loader_threads"] = default_threads()
    out["loader_batches_per_s"] = rates
    out["trainer_steps_per_s"] = reg["steps_per_s"]

    # the trainer fed by the loader: host decode overlapped with the steps
    model = ResNet50(REG_OUT, generator=torch.Generator().manual_seed(0)).to(
        dev, memory_format=torch.channels_last)
    _, train_step, _ = tr.make_steps(model, REG_LR)
    labels = torch.rand(len(paths), REG_OUT, generator=torch.Generator().manual_seed(1))
    with tr.make_loader(paths, REG_SIZE, host_cpp=True) as loader:
        stream = loader.batches(idx)
        u8, i = next(stream)
        train_step(tr.normalize(u8, dev), labels[i].to(dev))  # warmup
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = 0
        for u8, i in stream:
            train_step(tr.normalize(u8, dev), labels[i].to(dev))
            steps += 1
        torch.cuda.synchronize()
        out["fed_steps_per_s"] = steps / (time.perf_counter() - t0)
    assert steps == LOADER_BATCHES - 1, steps
    del model
    torch.cuda.empty_cache()
    out["update_gan_iteration_ms"] = {"png_phase21": gan_png["iteration_ms_cuda_events"],
                                      "jpeg_phase38": gan_jpeg["iteration_ms_cuda_events"]}
    return out


def stylegan1_phase(dev):
    """Phase 42a: the StyleGAN1 generator (models/stylegan1.py) at full
    width from seeded weights (noise weights set to 0.3), forward at step 5
    (128 px) and step 8 (1024 px) with the same z and noise maps on the
    card and on the CPU, f32, within S1_TOL relative L2; card ms (CUDA
    events), with style mixing and truncation at step 5."""
    import numpy as np
    import torch

    from latent2im_tpu_torch.models.stylegan1 import StyledGenerator

    g_cpu = StyledGenerator(generator=torch.Generator().manual_seed(42)).eval()
    with torch.no_grad():
        for n, p in g_cpu.named_parameters():
            if ".noise" in n:
                p.fill_(NOISE_WEIGHT)
    g = StyledGenerator().to(dev).eval()
    g.load_state_dict(g_cpu.state_dict())
    rng = np.random.RandomState(42)
    out = {}
    for step, b in S1_STEPS:
        zs = [torch.from_numpy(rng.randn(b, 512).astype(np.float32)) for _ in range(2)]
        noise = [torch.from_numpy(rng.randn(b, 4 * 2 ** i, 4 * 2 ** i, 1).astype(np.float32))
                 for i in range(step + 1)]
        mean = g_cpu.style_forward(zs[1]).mean(0, keepdim=True).detach()
        for tag, kw in (("plain", {}), ("mixing", {"inject_index": [2]}),
                        ("truncation", {"style_weight": 0.7})):
            if step == 8 and tag != "plain":
                continue
            z = zs if tag == "mixing" else zs[0]
            m = mean if tag == "truncation" else None
            with torch.no_grad():
                want = g_cpu(z, noise=noise, step=step, mean_style=m, **kw)

                def run():
                    return g([t.to(dev) for t in z] if tag == "mixing" else z.to(dev),
                             noise=[n.to(dev) for n in noise], step=step,
                             mean_style=None if m is None else m.to(dev), **kw)

                got = run().cpu()
                ms = time_ms(run, warmup=1, iters=3)
            assert got.shape == (b, 4 * 2 ** step, 4 * 2 ** step, 3) and torch.isfinite(got).all()
            err = rel_l2(got.double().numpy(), want.double().numpy())
            assert err <= S1_TOL, (step, tag, err)
            out[f"step{step}_{tag}"] = {"batch": b, "rel_l2_card_vs_cpu": err, "card_ms": ms}
    del g
    torch.cuda.empty_cache()
    return out


def compat_phase(dev):
    """Phase 42b: the reference-style call sequence through compat.py on the
    card (StyleGAN2 at SIZE px, full width, random towers): get_w,
    get_logits, get_reg_preds, get_train_alpha, get_alphas,
    get_w_new_tensor, get_logits again, apply_alpha, save_multi_models and
    load_multi_models, with the kernels' launches counted over the sequence.
    The sequence's edit equals apply_alpha's bit for bit, and the walk
    reloads bit for bit (cuDNN's deterministic algorithms, as phase 10)."""
    import tempfile

    import numpy as np
    import torch

    from latent2im_tpu_torch import graphs, ops

    graph = graphs.find_model_using_name("stylegan_v2_real", "face")(
        device=dev, no_gan_loss=True, no_content_loss=True)
    z = np.random.RandomState(43).randn(BATCH, graph.dim_z).astype(np.float32)
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with tempfile.TemporaryDirectory() as root:
            ops.reset_launches()
            t0 = time.perf_counter()
            w = graph.get_w(z)
            img = graph.get_logits({"w": w})
            org = graph.get_reg_preds(img)
            a_graph, a_target, _ = graph.get_train_alpha(z)
            target, delta = graph.get_alphas(org, a_graph)
            edited = graph.get_logits({"w": graph.get_w_new_tensor(w, delta)})
            via_apply, alpha_org, orig = graph.apply_alpha({"z": z}, a_graph)
            graph.save_multi_models(os.path.join(root, "w"))
            walk = {k: v.clone() for k, v in graph.walk.items()}
            graph.load_multi_models(os.path.join(root, "w_walk_module.ckpt"))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = ops.launch_counts()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    assert edited.shape == (BATCH, SIZE, SIZE, 3) and torch.isfinite(edited).all()
    assert torch.equal(edited, via_apply) and torch.equal(img, orig), "compat edit != apply_alpha"
    assert torch.equal(org, alpha_org) and torch.equal(target, graph.editor._tensor(a_graph))
    assert all(torch.equal(graph.walk[k], v) for k, v in walk.items())
    # an inference surface: the forward kernels run, the backward ones not
    assert all(launches[k] > 0 for k in FORWARD), launches
    return {"seconds": seconds, "launches": launches,
            "edit_moved": float((edited - img).abs().max())}


def regressor_phases(card, dev, gan, jp):
    """Phases 39-42 -> their reports and, under "launches", compat's launch
    counts (the trainer, the loader and StyleGAN1 reach no kernel)."""
    import torch

    phase(39, f"the regressor trainer: ResNet-50 at {REG_SIZE} px, B={REG_BATCH}, "
          f"{REG_WARMUP} warmup and {REG_STEPS} timed steps; {REG_CMP_STEPS} steps at "
          f"B={REG_CMP_BATCH} against the CPU")
    reg = regressor_train_phase(dev)
    log(f"    {reg['step_ms_cuda_events']:.2f} ms per step (CUDA events), "
        f"{reg['step_ms_host']:.2f} ms (host), {reg['samples_per_s']:.1f} samples/s, peak "
        f"{reg['peak_mem_gb']:.2f} GB, loss {reg['loss_first_last']}, on {card}")
    log(f"    one step under torch.profiler: {json.dumps(reg['profile'])}")
    log(f"    card against CPU: {json.dumps(reg['cpu_vs_card'])}")

    phase(40, "python -m latent2im_tpu_torch.cli.train_regressor on "
          "tests/fixtures/torch_regressor/, 2 epochs, --export_torch")
    cli = regressor_cli_phase()
    log(f"    {cli['seconds']:.1f} s, test MSE {cli['test_mse']:.5f}, metas {cli['metas']}, "
        f"Adam step {cli['adam_steps']} restored; lines {json.dumps(cli['lines'])}")
    torch.cuda.empty_cache()

    phase(41, "the loader: the C decode against Python, the threaded loader against the "
          "trainer, --updateGAN on JPEGs against PNGs")
    loader = loader_phase(dev, reg, gan["train"], jp["gan"])
    log(f"    loader ({loader['loader_threads']} threads) batches/s at B={REG_BATCH}: "
        f"{json.dumps(loader['loader_batches_per_s'])} against the trainer's "
        f"{loader['trainer_steps_per_s']:.2f} steps/s; fed by it "
        f"{loader['fed_steps_per_s']:.2f} steps/s; --updateGAN ms per iteration "
        f"{json.dumps(loader['update_gan_iteration_ms'])}, on {card}")

    phase(42, "StyleGAN1 at step 5 (128 px) and step 8 (1024 px), card against CPU; "
          "the compat call sequence")
    s1 = stylegan1_phase(dev)
    log(f"    {json.dumps(s1)}")
    cp = compat_phase(dev)
    log(f"    compat: {cp['seconds']:.1f} s, launches {json.dumps(cp['launches'])}")
    torch.cuda.empty_cache()
    return {"train": reg, "cli": cli, "loader": loader, "stylegan1": s1, "compat": cp,
            "launches": {"compat": cp["launches"]}}


# ---------------------------------------------------------------------------
# phases 43-46: data and spatial parallelism (latent2im_tpu_torch/parallel/)
# ---------------------------------------------------------------------------

SP_SIZE, SP_BATCH, SP_PANELS = 1024, 1, 3  # sp: one sample at 1024 px over two ranks
DP_SIZE, DP_BATCH = 256, 2  # dp: two per rank over two ranks, against one process at 4
PAR_RANKS, PAR_TIMED = 2, 3
EDIT_REL_L2 = 1e-5  # a rank-0 edit against the one-process edit on the card
STEP_TERMS = ("loss", "reg_loss", "content_loss", "gan_loss")


def shard_cases(size, b, n=PAR_RANKS, min_rows=8):
    """The kernels' cases on one of n spatial ranks at ``size`` px, batch b:
    each row-sharded block's (models/stylegan2.py:Generator._block_rows,
    the halo widths of parallel/spatial.py; the default min_rows_per_device)
    blur after the transposed conv on its halo-extended rows, the skip
    upsample on the extended skip (y pads cropping), fused_act, the styled
    conv on x with its halo rows, and the backwards of a training step."""
    from latent2im_tpu_torch.models.stylegan2 import channel_table

    ch, cases = channel_table(2), []
    for i in range(3, int(math.log2(size)) + 1):
        r = 2 ** i
        h_in = r // 2
        if not (r % n == 0 and r >= n * min_rows and h_in % n == 0):
            continue
        h, c = h_in // n, ch[r]
        blur = (b, 2 * h + 5, r + 1, c, 1, (1, 1, -1, -1), 4.0)
        skip = (b, h + 2, h_in, 3, 2, (2, 1, 0, -1), 4.0)
        cases += [("upfirdn2d", blur), ("upfirdn2d", skip), ("fused_act", (b, 2 * h, r, c)),
                  ("styled_conv3x3", (b, 2 * h + 2, r, c, c)), ("upfirdn2d_bwd", blur),
                  ("upfirdn2d_bwd", skip), ("fused_act_bwd", (b, 2 * h, r, c))]
    return cases


def shard_kernel_phase(dev):
    """Phase 43: the five kernels at the row-shard shapes of two ranks at
    256 and 1024 px (B=1), in f32 and bf16, each held to its plain version
    at the main path's gates (TOL, TOL_BF16); the f32 calls timed beside
    their bounds; the form each took."""
    import torch

    from latent2im_tpu_torch import ops

    gen = torch.Generator(device=dev).manual_seed(43)
    details, worst = [], {}
    for size in (SIZE, SIZE_HI):
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            tol, flops_of = (TOL_BF16, FLOPS_BF16) if bf16 else (TOL, FLOPS)
            for name, case in shard_cases(size, SP_BATCH):
                kern, plain, _, nbytes, flops, _, inp = kernel_cases(name, case, gen, dev, dtype)
                got = kern()
                torch.cuda.synchronize()
                want = plain()
                err, scale = _max_err(got, want)
                if got.dtype != want.dtype or not (math.isfinite(err) and err <= tol[name] * scale):
                    raise AssertionError(
                        f"{name} {case} {dtype}: max abs err {err:.3e} > {tol[name]} * "
                        f"max|ref| {scale:.3e}")
                key = f"{name}[bf16]" if bf16 else name
                worst[key] = max(worst.get(key, 0.0), err / scale)
                if name == "styled_conv3x3":
                    form = ops.styled_conv3x3_plan(*case, dtype)
                elif name.startswith("upfirdn2d"):
                    up = case[4]
                    form = ops.upfirdn2d_form(inp, got, (4, 4),
                                              *((up, 1) if name == "upfirdn2d" else (1, up)))
                else:
                    form = None
                row = {"kernel": name, "size": size, "dtype": str(dtype), "case": repr(case),
                       "form": form, "max_abs_err": err, "max_abs_ref": scale}
                if not bf16:
                    b_ms, by = bound_ms(nbytes, flops, flops_of.get(name, F32_FLOPS))
                    row.update(ms=time_ms(kern, warmup=2, iters=5), bound_ms=b_ms, bound_by=by)
                details.append(row)
                del kern, plain, inp, got, want
    torch.cuda.empty_cache()
    f32 = [r for r in details if "ms" in r]
    log(f"    {len(details)} shard cases held; worst error / max|ref| by kernel "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})}; f32 kernel "
        f"{sum(r['ms'] for r in f32):.3f} ms over the cases against bound "
        f"{sum(r['bound_ms'] for r in f32):.3f} ms")
    return {"worst_err_over_ref": worst, "cases": len(details), "details": details}


def _par_editor(size, batch, dev, *flags):
    """train_conf's seeded full-width editor at ``size`` px (the stored
    noise maps, so that an f64 step can repeat its noise; ``flags`` more
    options), G's noise weights NOISE_WEIGHT -> (editor, walk)."""
    import torch

    from latent2im_tpu_torch.engine.build import build_editor_from_options

    ed, walk, _ = build_editor_from_options(
        train_conf("--fixed_noise", *flags, size=size, batch=batch), device=dev)
    with torch.no_grad():
        for name, p in ed.g.named_parameters():
            if name.endswith("noise.weight"):
                p.fill_(NOISE_WEIGHT)
    return ed, walk


def _par_inputs(ed, batch):
    """(z, host alphas, apply_alpha's targets, the sweep's panels)."""
    import numpy as np

    rng = np.random.RandomState(44)
    z = rng.randn(batch, ed.cfg.dim_z).astype(np.float32)
    sampled = rng.uniform(0, 1, (batch, 1)).astype(np.float32)
    panels = np.stack([np.full((batch, 1), a, np.float32)
                       for a in np.linspace(0.0, 1.0, SP_PANELS)])
    return z, sampled, np.full((batch,), 0.7, np.float32), panels


def par_run(ed, walk, size, batch, mesh=None, sp=None):
    """One apply_alpha, one sweep (SP_PANELS panels) and one training step
    (host alphas, the stored noise) of the global batch ``batch``, on
    ``mesh`` (None: one process) inside ``sp``, counted; then PAR_TIMED
    timed edits and steps (host clock to a synchronise), and one edit and
    one step more with the collectives timed (``mesh.stats``)."""
    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.engine.train import make_optimizer, make_train_step
    from latent2im_tpu_torch.parallel import mesh as M
    from latent2im_tpu_torch.tasks.transforms import get_task
    from latent2im_tpu_torch.walks import walk_leaves

    z, sampled, alphas, panels = _par_inputs(ed, batch)
    med = ed if mesh is None else M.MeshEditor(ed, mesh)
    for t in walk_leaves(walk):
        t.requires_grad_(True)
    step = make_train_step(ed, get_task("face"), make_optimizer(walk, 1e-4),
                           host_alpha=True, mesh=mesh)
    gen = torch.Generator(device=ed.device)

    def edit():
        return med.apply_alpha(walk, z, alphas)

    def train():
        gen.manual_seed(45)
        return step(walk, z, generator=gen, sampled=sampled)

    def host_ms(fn):
        times = []
        for _ in range(PAR_TIMED):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)

    out = {}
    with sp or contextlib.nullcontext():
        edit()  # warm
        torch.cuda.synchronize()
        ops.reset_launches()
        edited, alpha_org, _ = edit()
        imgs = med.sweep(walk, z, panels)[0]
        m = train()
        torch.cuda.synchronize()
        out["launches"] = ops.launch_counts()
        out.update(edited=edited.cpu().numpy(), sweep=imgs.cpu().numpy(),
                   alpha_org=alpha_org.cpu().numpy(),
                   terms={k: float(m[k]) for k in STEP_TERMS},
                   grad=np.concatenate([p.grad.detach().cpu().numpy().astype(np.float64).ravel()
                                        for p in walk_leaves(walk)]))
        out["edit_ms"], out["step_ms"] = host_ms(edit), host_ms(train)
        if mesh is not None:
            plan = sp.plan if sp is not None else None
            for name, fn in (("edit", edit), ("step", train)):
                mesh.stats = {"seconds": 0.0, "bytes": 0, "calls": 0}
                if plan is not None:
                    plan.halo_bytes = plan.gather_bytes = 0
                fn()
                out[f"{name}_collectives"] = {
                    "ms": mesh.stats["seconds"] * 1e3, "calls": mesh.stats["calls"],
                    "bytes_sent": mesh.stats["bytes"],
                    "halo_bytes": plan.halo_bytes if plan else 0,
                    "gather_bytes": plan.gather_bytes if plan else 0}
                mesh.stats = None
    return out


def _gloo_cuda_probe(world):
    """Which gloo collectives take CUDA tensors in this PyTorch build
    (parallel/mesh.py passes them to all_reduce, broadcast and all_gather,
    and copies through the host for the halo swaps' send and recv).
    Each is refused, if it is, on every rank alike before it communicates."""
    import torch
    import torch.distributed as dist

    t = torch.ones(4, device="cuda")
    calls = (("all_reduce", lambda: dist.all_reduce(t)),
             ("broadcast", lambda: dist.broadcast(t, 0)),
             ("all_gather", lambda: dist.all_gather([torch.empty_like(t)] * world, t)))
    out = {}
    for name, fn in calls:
        try:
            fn()
            torch.cuda.synchronize()
            out[name] = True
        except RuntimeError as e:  # the capability asked about: recorded, not masked
            out[name] = str(e).splitlines()[0][:120]
        dist.barrier()
    return out


def _parallel_rank():
    """One of PAR_RANKS ranks sharing the card over gloo: the sp path (1 x 2
    mesh, 1024 px, B=1, the towers and walk replicated from rank 0), then
    the dp path (2 x 1 mesh, 256 px, global batch 2 x DP_BATCH) -> every
    rank's numbers, gathered (the images from rank 0 only)."""
    import torch
    import torch.distributed as dist

    from latent2im_tpu_torch.device import resolve_device
    from latent2im_tpu_torch.parallel import mesh as M
    from latent2im_tpu_torch.parallel import spatial as S

    faulthandler.dump_traceback_later(RANK_WATCHDOG_S)
    dev = resolve_device("cuda")
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"rank": rank, "backend": dist.get_backend(), "gloo_cuda": _gloo_cuda_probe(world)}
    mesh = S.make_mesh_spatial(PAR_RANKS, 1)
    ed, walk = _par_editor(SP_SIZE, SP_BATCH, dev)
    _, walk = M.replicate_editor(ed, walk, mesh)
    out["sp"] = par_run(ed, walk, SP_SIZE, SP_BATCH, mesh, S.spatial_partitioning(mesh))
    out["sp"]["transport"] = mesh.transport
    del ed, walk
    torch.cuda.empty_cache()
    mesh = M.make_mesh(PAR_RANKS)
    ed, walk = _par_editor(DP_SIZE, DP_BATCH * PAR_RANKS, dev)
    _, walk = M.replicate_editor(ed, walk, mesh)
    out["dp"] = par_run(ed, walk, DP_SIZE, DP_BATCH * PAR_RANKS, mesh)
    out["dp"]["transport"] = mesh.transport
    if rank:
        for path in ("sp", "dp"):
            for k in ("edited", "sweep", "alpha_org", "grad"):
                out[path].pop(k)
    objs = [None] * world
    dist.all_gather_object(objs, out)
    return objs


def _loop_resumed(ed, walk, mesh, batch):
    """train_loop on ``mesh`` as cli.train drives it: an epoch of two steps
    with its stop flag polled over the ranks (mesh.any_rank, a host flag)
    and its Adam state kept as a checkpoint keeps it, then --resume's path:
    that state replicated from rank 0 (Adam's step count is a host tensor)
    and the next epoch stopped by the flag after one step -> (the losses,
    Adam's step count after each epoch, the device of that count)."""
    import copy

    from latent2im_tpu_torch.engine.train import train_loop
    from latent2im_tpu_torch.tasks.transforms import get_task

    polls, saved = [0], {}

    def stop():  # false through the first epoch and one step of the second
        polls[0] += 1
        return polls[0] > 3

    kw = dict(num_samples=2 * batch, batch_size=batch, lr=1e-4, log_every=1,
              stop_flag=stop, mesh=mesh)
    _, first = train_loop(ed, get_task("face"), walk, n_epochs=1,
                          on_epoch_end=lambda e, wp, st: saved.update(epoch=copy.deepcopy(st)),
                          **kw)
    _, second = train_loop(ed, get_task("face"), walk, n_epochs=2, start_epoch=1,
                           opt_state=copy.deepcopy(saved["epoch"]),
                           on_preempt=lambda e, wp, st: saved.update(stop=copy.deepcopy(st)),
                           **kw)
    steps = [int(saved[k]["state"][0]["step"]) for k in ("epoch", "stop")]
    losses = first + second
    assert steps == [2, 3] and len(losses) == 3 and all(map(math.isfinite, losses)), \
        (steps, losses)
    return {"losses": losses, "adam_steps": steps,
            "adam_step_device": str(saved["stop"]["state"][0]["step"].device)}


def _nccl_rank():
    """A one-rank NCCL group running the dp path (1-rank mesh, 256 px, B=4):
    its collectives run through NCCL on the card; then train_loop with a
    stop flag and a resume on the same mesh (``_loop_resumed``)."""
    import torch.distributed as dist

    from latent2im_tpu_torch.device import resolve_device
    from latent2im_tpu_torch.parallel import mesh as M

    dev = resolve_device("cuda")
    mesh = M.make_mesh(1)
    ed, walk = _par_editor(DP_SIZE, DP_BATCH * PAR_RANKS, dev)
    _, walk = M.replicate_editor(ed, walk, mesh)
    out = par_run(ed, walk, DP_SIZE, DP_BATCH * PAR_RANKS, mesh)
    out.update(backend=dist.get_backend(), transport=mesh.transport,
               loop=_loop_resumed(ed, walk, mesh, DP_BATCH * PAR_RANKS))
    return out


def one_rank_here(fn, *args):
    """``fn(*args)`` as the one rank of a group that this process joins,
    with the backend ``parallel.launch`` picks for one rank on one card
    (NCCL), through a FileStore in a temporary directory, and leaves after
    -> fn's result. This saves phase 46 the ~20 s a spawned rank takes to
    start; phases 44-45 and 48-50 spawn theirs through ``launch``."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from latent2im_tpu_torch.parallel.mesh import COLLECTIVE_TIMEOUT, choose_backend

    backend = choose_backend("cuda", 1, torch.cuda.device_count())
    tmp = tempfile.mkdtemp(prefix="l2i_rdzv_")
    try:
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1, timeout=COLLECTIVE_TIMEOUT)
        try:
            return fn(*args)
        finally:
            dist.destroy_process_group()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _held(name, got, want):
    """A launched path's rank-0 numbers against the one-process run's on the
    card: edits within EDIT_REL_L2, the step's loss terms rtol 2e-4; the
    walk gradient by phase 9's rule, against the f64 step on the card:
    within max(1e-3, 1.5 x the one-process f32 gradient's own distance)."""
    import numpy as np

    out = {"edit_rel_l2": rel_l2(got["edited"], want["edited"]),
           "sweep_rel_l2": rel_l2(got["sweep"], want["sweep"]),
           "alpha_org_max_abs": float(np.abs(got["alpha_org"] - want["alpha_org"]).max()),
           "terms": got["terms"], "terms_one_process": want["terms"],
           "grad_rel_l2_one_process": rel_l2(got["grad"], want["grad"]),
           "grad_rel_l2_f64": rel_l2(got["grad"], want["grad_f64"]),
           "one_process_grad_rel_l2_f64": rel_l2(want["grad"], want["grad_f64"])}
    out["grad_limit"] = max(1e-3, 1.5 * out["one_process_grad_rel_l2_f64"])
    assert got["edited"].shape == want["edited"].shape, (name, got["edited"].shape)
    assert out["edit_rel_l2"] <= EDIT_REL_L2 and out["sweep_rel_l2"] <= EDIT_REL_L2, (name, out)
    for k in STEP_TERMS:
        assert abs(got["terms"][k] - want["terms"][k]) <= 2e-4 * abs(want["terms"][k]), (name, k, out)
    assert out["grad_rel_l2_f64"] <= out["grad_limit"], (name, out)
    return out


def parallel_phases(card, dev, tp_too: bool = False):
    """Phases 43-46 -> their reports and, under "launches", the sp, dp and
    dp_nccl paths' launch counts (summed over their ranks). tp_too: the
    ranks also run phases 48-50's part (``_mesh_rank``), which saves a
    second start of the ranks (~20 s); what it gathered is under
    "tp_ranks", for ``tp_phases``."""
    import torch

    from latent2im_tpu_torch.parallel.launch import launch

    phase(43, f"the kernels at the row-shard shapes of {PAR_RANKS} ranks ({SIZE} and {SIZE_HI} px, "
          f"B={SP_BATCH}, f32 and bf16) against their plain versions")
    out = {"shards": shard_kernel_phase(dev)}
    phase("44-45", f"one process on the card: the sp path's numbers ({SP_SIZE} px, B={SP_BATCH}) "
          f"and the dp path's ({DP_SIZE} px, B={DP_BATCH * PAR_RANKS})")
    from latent2im_tpu_torch.walks import walk_map

    refs = {}
    for path, size, batch in (("sp", SP_SIZE, SP_BATCH), ("dp", DP_SIZE, DP_BATCH * PAR_RANKS)):
        ed, walk = _par_editor(size, batch, dev)
        w0 = walk_map(lambda t: t.detach().cpu().numpy().copy(), walk)
        refs[path] = par_run(ed, walk, size, batch)
        t = time.perf_counter()
        for m in (ed.g, ed.reg, ed.vgg, ed.d):  # the same step in f64 on the card
            m.double()
        z, sampled, _, _ = _par_inputs(ed, batch)
        with plain_kernels():
            refs[path]["grad_f64"] = reference_step(ed, w0, z, sampled, torch.float64)[1]
        refs[path]["f64_step_s"] = time.perf_counter() - t
        del ed, walk
        torch.cuda.empty_cache()
    log(f"    one process: sp-size edit {refs['sp']['edit_ms']:.2f} ms, step "
        f"{refs['sp']['step_ms']:.2f} ms; dp-size edit {refs['dp']['edit_ms']:.2f} ms, step "
        f"{refs['dp']['step_ms']:.2f} ms (host clock), on {card}")
    t = time.perf_counter()
    if tp_too:
        assert TP_RANKS == PAR_RANKS
        ranks, out["tp_ranks"] = launch(_mesh_rank, (gan_mesh_pngs(),), world_size=PAR_RANKS,
                                        device="cuda", timeout=720.0)
    else:
        ranks = launch(_parallel_rank, (), world_size=PAR_RANKS, device="cuda", timeout=360.0)
    out["ranks_wall_s"] = time.perf_counter() - t
    out["gloo_takes_cuda_tensors"] = ranks[0]["gloo_cuda"]
    log(f"    {PAR_RANKS} ranks sharing the card: backend {ranks[0]['backend']}; gloo with CUDA "
        f"tensors: {json.dumps(ranks[0]['gloo_cuda'])}; wall {out['ranks_wall_s']:.1f} s"
        + (" (with phases 48-50's part)" if tp_too else ""))
    launches = {}
    for path, n in (("sp", 44), ("dp", 45)):
        r = _held(path, ranks[0][path], refs[path])
        r.update({k: [rk[path][k] for rk in ranks]
                  for k in ("edit_ms", "step_ms", "edit_collectives", "step_collectives")})
        r["transport"] = ranks[0][path]["transport"]
        r["one_process"] = {k: refs[path][k] for k in ("edit_ms", "step_ms")}
        launches[path] = {k: sum(rk[path]["launches"][k] for rk in ranks)
                          for k in ranks[0][path]["launches"]}
        assert all(v > 0 for v in launches[path].values()), (path, launches[path])
        out[path] = r
        c = r["step_collectives"][0]
        log(f"[{n}] {path} over {PAR_RANKS} ranks (backend {ranks[0]['backend']}, transport "
            f"{r['transport']}): edit rel L2 {r['edit_rel_l2']:.2e}, sweep {r['sweep_rel_l2']:.2e}, "
            f"step loss {r['terms']['loss']:.5f} ({r['terms_one_process']['loss']:.5f} one process), "
            f"walk gradient rel L2 to f64 {r['grad_rel_l2_f64']:.2e} (one process "
            f"{r['one_process_grad_rel_l2_f64']:.2e}, limit {r['grad_limit']:.2e}; to one "
            f"process {r['grad_rel_l2_one_process']:.2e})")
        log(f"    ms per edit {r['edit_ms']} and per step {r['step_ms']} by rank (one process "
            f"{r['one_process']['edit_ms']:.2f} / {r['one_process']['step_ms']:.2f}); rank 0's "
            f"collectives per step: {c['ms']:.2f} ms over {c['calls']} calls, {c['bytes_sent']} "
            f"bytes sent, halo {c['halo_bytes']} B, gather {c['gather_bytes']} B; launches "
            f"{launches[path]}; on {card}. Two ranks on one card measure overhead, not speedup.")
    phase(46, "a one-rank NCCL group (this process) running the dp path, then train_loop "
          "with a stop flag and a resume")
    nccl = one_rank_here(_nccl_rank)
    assert nccl["backend"] == "nccl", nccl["backend"]
    r = _held("dp_nccl", nccl, refs["dp"])
    r.update({k: nccl[k] for k in ("edit_ms", "step_ms", "edit_collectives",
                                   "step_collectives", "transport", "loop")})
    launches["dp_nccl"] = nccl["launches"]
    assert all(v > 0 for v in launches["dp_nccl"].values()), launches["dp_nccl"]
    out["dp_nccl"] = r
    log(f"    backend nccl, transport {r['transport']}: edit rel L2 {r['edit_rel_l2']:.2e}, "
        f"walk gradient rel L2 to f64 {r['grad_rel_l2_f64']:.2e}; step {r['step_ms']:.2f} ms, collectives "
        f"{r['step_collectives']['ms']:.2f} ms over {r['step_collectives']['calls']} calls; "
        f"on {card}. The NCCL path across two or more cards is not run (one card).")
    log(f"    train_loop under NCCL: losses {r['loop']['losses']}, Adam steps "
        f"{r['loop']['adam_steps']} (its count on {r['loop']['adam_step_device']}) through "
        "the stop flag and the resume")
    out["launches"] = launches
    return out

# ---------------------------------------------------------------------------
# phases 47-49: tensor parallelism, --updateGAN under a mesh
# ---------------------------------------------------------------------------

TP_RANKS = 2  # the model axis: two ranks sharing the card over gloo
# (name, size, batch, extra flags): the tp step's configurations
TP_RUNS = (("f32_256", SIZE, BATCH, ()), ("bf16_256", SIZE, BATCH, ("--bf16",)),
           ("bf16_1024", SIZE_HI, 2, ("--bf16",)))
TP_TIMED = 1
# a tp step's loss terms against one process's on the card: f32 1e-6
# (relative); bf16 one bf16 rounding, 2^-8, at these inputs: the partial
# sums' other order flips some of the bf16 roundings of the activations
# (tests/test_torch_tp.py reads 1.3e-4 on the CPU). Two correct bf16 forms
# of the step (the kernels, the plain versions) lie up to 1.4e-2 apart at
# other inputs (scripts/torch_tp_bf16_witness.py), so phase 48 also holds
# every term to the f64 step by phase 9's rule, with this as its floor
TP_LOSS_RTOL = {"f32": 1e-6, "bf16": 2.0 ** -8}
SPLIT_SOURCE = ("latent2im_tpu_torch/ops/csrc/styled_conv3x3.cu",
                "latent2im_tpu/ops/pair_conv.py:142")
SPLIT = ("styled_conv3x3_partial", "styled_conv3x3_epilogue")


def tp_cases(size, b, n=TP_RANKS):
    """Each partner (non-up 3x3) conv of the ``size`` px model at batch b on
    one of n model ranks: (B, H, W, Cin / n, Cout)."""
    from latent2im_tpu_torch.models.stylegan2 import channel_table

    ch = channel_table(2)
    return [(b, 2 ** i, 2 ** i, ch[2 ** i] // n, ch[2 ** i])
            for i in range(3, int(math.log2(size)) + 1)]


def split_kernel_cases(name, case, gen, dev, dtype):
    """The styled conv's split at a tp shard case -> (kernel call, plain
    call, library call, bytes, flops, the input). The partial's library call
    is the rosinality grouped conv on the shard (per-sample weights w * s,
    cuDNN, in x's dtype); the epilogue's F.leaky_relu(acc * d + noise_w *
    noise + b) * sqrt(2) on the same f32 sums, in the result's dtype."""
    import torch
    import torch.nn.functional as F

    from latent2im_tpu_torch import ops

    bsz, h, wd, cin, cout = case
    esz = torch.finfo(dtype).bits // 8

    def randn(*s):
        return torch.randn(s, generator=gen, device=dev)

    if name == "styled_conv3x3_partial":
        x = randn(bsz, h, wd, cin).to(dtype)
        w = (randn(3, 3, cin, cout) / math.sqrt(18 * cin)).to(dtype)
        s = (1.0 + 0.2 * randn(bsz, cin)).to(dtype)
        x_nchw, w_oihw = x.permute(0, 3, 1, 2).contiguous(), w.permute(3, 2, 0, 1).contiguous()

        def library():
            wt = (w_oihw[None].float() * s.float()[:, None, :, None, None]).to(dtype)
            return F.conv2d(x_nchw.reshape(1, bsz * cin, h, wd), wt.reshape(bsz * cout, cin, 3, 3),
                            padding=1, groups=bsz)

        nbytes = esz * (x.numel() + w.numel() + s.numel()) + 4 * bsz * h * wd * cout
        return (lambda: ops.styled_conv3x3_partial(x, w, s),
                lambda: ops.styled_conv3x3_partial_plain(x, w, s), library, nbytes,
                2 * bsz * h * wd * 9 * cin * cout, x)
    acc = randn(bsz, h, wd, cout)
    d = (0.1 * randn(bsz, cout) + 1.0).to(dtype)
    noise, nw, bias = randn(1, h, wd).to(dtype), torch.full((1,), 0.3, device=dev), 0.1 * randn(cout)
    sqrt2 = math.sqrt(2.0)

    def library():
        return (F.leaky_relu(acc * d.float()[:, None, None, :] + nw * noise.float()[..., None]
                             + bias, 0.2) * sqrt2).to(dtype)

    n = acc.numel()
    nbytes = 4 * n + esz * (d.numel() + noise.numel() + n) + 4 * (1 + cout)
    return (lambda: ops.styled_conv3x3_epilogue(acc, d, noise, nw, bias),
            lambda: ops.styled_conv3x3_epilogue_plain(acc, d, noise, nw, bias), library,
            nbytes, 6 * n, acc)


def tp_kernel_phase(dev):
    """Phase 47: the split's partial and epilogue at the tp shard shape of
    every partner conv of the 256 px (B=4) and 1024 px (B=2) models, f32 and
    bf16, each held to its plain version (TOL and TOL_BF16 of the styled
    conv, of max|ref|); timed (CUDA events, and on the device clock) beside
    its bound and library call. -> {(size, dtype, kernel): sums over the
    partner convs of one synthesis}, the details, worst error / max|ref|."""
    import torch

    from latent2im_tpu_torch import ops

    gen = torch.Generator(device=dev).manual_seed(47)
    sums, details, worst = {}, [], {}
    for size, batch in ((SIZE, BATCH), (SIZE_HI, 2)):
        for dtype in (torch.float32, torch.bfloat16):
            bf16 = dtype == torch.bfloat16
            tol = TOL_BF16["styled_conv3x3"] if bf16 else TOL["styled_conv3x3"]
            rate = BF16_FLOPS if bf16 else TF32_FLOPS / 3
            for case in tp_cases(size, batch):
                for name in SPLIT:
                    kern, plain, lib, nbytes, flops, inp = split_kernel_cases(
                        name, case, gen, dev, dtype)
                    got = kern()
                    torch.cuda.synchronize()
                    want = plain()
                    err, scale = _max_err(got, want)
                    if got.dtype != want.dtype or not (math.isfinite(err) and err <= tol * scale):
                        raise AssertionError(f"{name} {case} {dtype}: max abs err {err:.3e} > "
                                             f"{tol} * max|ref| {scale:.3e}")
                    key = f"{name}[bf16]" if bf16 else name
                    worst[key] = max(worst.get(key, 0.0), err / scale)
                    b_ms, by = bound_ms(nbytes, flops, rate if name == SPLIT[0] else F32_FLOPS)
                    row = {"kernel": name, "size": size, "dtype": str(dtype), "case": repr(case),
                           "form": (ops.styled_conv3x3_plan(*case, dtype)
                                    if name == SPLIT[0] else None),
                           "max_abs_err": err, "max_abs_ref": scale,
                           "ms": time_ms(kern, iters=10), "device_ms": device_ms(kern),
                           "plain_ms": time_ms(plain, iters=5), "library_ms": time_ms(lib, iters=5),
                           "bound_ms": b_ms, "bound_by": by}
                    details.append(row)
                    agg = sums.setdefault((size, "bf16" if bf16 else "f32", name), {
                        "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                        "bound_ms": 0.0, "bound_by": by, "max_abs_err": 0.0, "calls": 0})
                    for k in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms"):
                        agg[k] += row[k]
                    agg["max_abs_err"] = max(agg["max_abs_err"], err)
                    agg["calls"] += 1
                    del kern, plain, lib, inp, got, want
    torch.cuda.empty_cache()
    for (size, dt, name), a in sorted(sums.items()):
        log(f"    {name} {dt} at the {size} px tp shards ({a['calls']} partner convs, one "
            f"synthesis): {a['ms']:.4f} ms (device {a['device_ms']:.4f}), bound "
            f"{a['bound_ms']:.4f} by {a['bound_by']}, plain {a['plain_ms']:.4f}, library "
            f"{a['library_ms']:.4f}; max abs err {a['max_abs_err']:.3e}")
    log(f"    {len(details)} split cases held; worst error / max|ref| "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in worst.items()})}")
    return sums, details, worst


def tp_run(ed, walk, batch, mesh=None):
    """The first training step (host alphas, the stored noise) of the global
    batch ``batch`` through the plain versions (its loss terms phase 48's
    second witness); the same step through the kernels, counted, its
    gradient the one phase 48 holds (in f32 under
    cuDNN's deterministic algorithms: under its default ones the same f32
    step lies 2.26e-3-3.12e-3 from the f64 step from run to run at 256 px
    B=4, scripts/torch_tp_grad_check.py); then TP_TIMED timed steps (host
    clock to a synchronise, cuDNN's default algorithms), and one more with
    the collectives timed (``mesh.stats``). On ``mesh`` (data x model) G
    runs tensor-parallel (frozen_tp_shardings)."""
    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.engine.train import make_optimizer, make_train_step
    from latent2im_tpu_torch.parallel import mesh as M
    from latent2im_tpu_torch.tasks.transforms import get_task
    from latent2im_tpu_torch.walks import walk_leaves, walk_map

    z, sampled, _, _ = _par_inputs(ed, batch)
    # the same first step through the plain versions, on a copy of the walk
    # with its own Adam: phase 48's second witness
    w_plain = walk_map(lambda t: t.detach().clone().requires_grad_(True), walk)
    for t in walk_leaves(walk):
        t.requires_grad_(True)
    sh = None if mesh is None else M.frozen_tp_shardings(mesh, ed.frozen_params())
    step, plain_step = (make_train_step(ed, get_task("face"), make_optimizer(w, 1e-4),
                                        host_alpha=True, mesh=mesh, frozen_shardings=sh)
                        for w in (walk, w_plain))
    gen = torch.Generator(device=ed.device)

    def train(fn=step, w=walk):
        gen.manual_seed(45)
        return fn(w, z, generator=gen, sampled=sampled)

    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = ed.cfg.compute_dtype == torch.float32
    try:
        with plain_kernels():
            m_plain = train(plain_step, w_plain)
        torch.cuda.synchronize()
        ops.reset_launches()
        m = train()
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = False
    out = {"launches": {**ops.launch_counts(), **ops.split_launch_counts()},
           "launches_bf16": {**ops.launch_counts(bf16=True),
                             **ops.split_launch_counts(bf16=True)},
           "terms": {k: float(m[k]) for k in STEP_TERMS},
           "terms_plain": {k: float(m_plain[k]) for k in STEP_TERMS},
           "g_param_bytes": sum(p.numel() * p.element_size() for p in ed.g.parameters()),
           "grad": np.concatenate([p.grad.detach().cpu().numpy().astype(np.float64).ravel()
                                   for p in walk_leaves(walk)])}
    times = []
    for _ in range(TP_TIMED):
        torch.cuda.synchronize()
        t = time.perf_counter()
        train()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    out["step_ms"], out["step_ms_all"] = statistics.median(times), times
    if mesh is not None:
        mesh.stats = {"seconds": 0.0, "bytes": 0, "calls": 0}
        train()
        out["step_collectives"] = {"ms": mesh.stats["seconds"] * 1e3,
                                   "calls": mesh.stats["calls"],
                                   "bytes_sent": mesh.stats["bytes"]}
        mesh.stats = None
    return out


def _gan_mesh_rank(dev, real_dir):
    """Phase 49 on this rank: cli/train.py's --updateGAN provider on a 2-rank
    data mesh at 256 px (full width, --batch_size BATCH): a warmup
    iteration, then one counted iteration (rank 0's D and G steps on the
    whole batch, G and D broadcast to every rank) before the walk's
    train_loop step of global batch 2 x BATCH -> the broadcasts, a digest
    of G and D on this rank, the walk step's loss, the launches."""
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.cli import train as tcli
    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.engine.train import train_loop
    from latent2im_tpu_torch.parallel import mesh as M
    from latent2im_tpu_torch.tasks.transforms import get_task

    mesh = M.make_mesh(TP_RANKS)
    conf = train_conf("--updateGAN", "--real_data_dir", real_dir,
                      root=os.path.join(REPO, "chiprun_out", "gan_mesh"))
    ed, walk, _ = build_editor_from_options(conf, device=dev)
    task = get_task("face")
    provider = tcli._make_gan_provider(ed, conf, task, walk, mesh)
    run = dict(batch_size=BATCH * TP_RANKS, n_epochs=1, lr=conf.learning_rate, log_every=1,
               frozen_provider=provider, mesh=mesh)
    losses = []
    try:
        walk, _ = train_loop(ed, task, walk, num_samples=BATCH * TP_RANKS, **run)  # warmup
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        walk, _ = train_loop(ed, task, walk, num_samples=BATCH * TP_RANKS, seed=1,
                             on_step=lambda e, i, m, dt, wp: losses.append(m["loss"]), **run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        provider.close()
    digest = [float(p.double().sum()) for m in (ed.g, ed.d) for p in m.parameters()]
    assert len(losses) == 1 and math.isfinite(losses[0]), losses
    return {"broadcasts": provider.broadcasts, "digest": digest, "loss": losses[0],
            "iteration_s": wall, "launches": ops.launch_counts(),
            "gan_steps": provider.steps["n"], "has_module": provider.module is not None}


SP_FAMILY_S1_STEP = 8  # StyleGAN1 at 1024 px, B=1, on rows


def sp_family_run(dev, mesh=None):
    """Phase 50's edits: model_256 PGGAN's apply_alpha (the pggan editor,
    G at SIZE px, B=BATCH) and StyleGAN1's forward at step
    SP_FAMILY_S1_STEP (B=1), each from seeded weights, on ``mesh`` (1 x
    spatial) inside a spatial_partitioning context, or in one process ->
    the images (rank 0's or the one process's), ms per edit (host clock to
    a synchronise, median of PAR_TIMED) and the collectives of one edit."""
    import numpy as np
    import torch

    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.models.stylegan1 import StyledGenerator
    from latent2im_tpu_torch.parallel import spatial as S

    ed, walk, _ = build_editor_from_options(pggan_conf(), device=dev)
    g1 = StyledGenerator(generator=torch.Generator().manual_seed(42)).eval()
    with torch.no_grad():
        for n, p in g1.named_parameters():
            if ".noise" in n:
                p.fill_(NOISE_WEIGHT)
    g1 = g1.to(dev)
    rng = np.random.RandomState(50)
    z, a = rng.randn(BATCH, 512).astype(np.float32), np.full((BATCH,), 0.3, np.float32)
    z1 = torch.from_numpy(rng.randn(1, 512).astype(np.float32)).to(dev)
    noise1 = [torch.from_numpy(rng.randn(1, 4 * 2 ** i, 4 * 2 ** i, 1).astype(np.float32)).to(dev)
              for i in range(SP_FAMILY_S1_STEP + 1)]
    med, ctx = ed, contextlib.nullcontext()
    if mesh is not None:
        med, walk, ctx = S.spatial_editor(ed, walk, mesh)

    calls = {"pggan": lambda: med.apply_alpha(walk, z, a)[0],
             "stylegan1": lambda: g1(z1, noise=noise1, step=SP_FAMILY_S1_STEP)}
    out = {}
    with ctx, torch.no_grad():
        for name, fn in calls.items():
            img = fn().float().cpu().numpy()
            times = []
            for _ in range(PAR_TIMED):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            r = {"img": img, "edit_ms": statistics.median(times)}
            if mesh is not None:
                mesh.stats = {"seconds": 0.0, "bytes": 0, "calls": 0}
                ctx.plan.halo_bytes = ctx.plan.gather_bytes = 0
                fn()
                r["collectives"] = {"ms": mesh.stats["seconds"] * 1e3, "calls": mesh.stats["calls"],
                                    "halo_bytes": ctx.plan.halo_bytes,
                                    "gather_bytes": ctx.plan.gather_bytes}
                mesh.stats = None
            out[name] = r
    del ed, walk, med, g1
    torch.cuda.empty_cache()
    return out


def _tp_rank(real_dir):
    """One of TP_RANKS ranks sharing the card over gloo: the tp step on a
    (1 x TP_RANKS) data x model mesh in each TP_RUNS configuration (the
    towers and walk replicated from rank 0), then phase 49's --updateGAN on
    a (TP_RANKS,) data mesh, then phase 50's edits of PGGAN and StyleGAN1
    on rows over a (1 x TP_RANKS) data x spatial mesh -> every rank's
    numbers, gathered (the gradients and images from rank 0 only)."""
    import torch
    import torch.distributed as dist

    from latent2im_tpu_torch.device import resolve_device
    from latent2im_tpu_torch.parallel import mesh as M
    from latent2im_tpu_torch.parallel import spatial as S

    faulthandler.dump_traceback_later(RANK_WATCHDOG_S)
    dev = resolve_device("cuda")
    rank, world = dist.get_rank(), dist.get_world_size()
    out = {"rank": rank, "backend": dist.get_backend(), "tp": {}}
    mesh = M.make_mesh_2d(1, TP_RANKS)
    for name, size, batch, flags in TP_RUNS:
        ed, walk = _par_editor(size, batch, dev, *flags)
        _, walk = M.replicate_editor(ed, walk, mesh)
        out["tp"][name] = r = tp_run(ed, walk, batch, mesh)
        r["transport"] = mesh.transport
        if rank:
            r.pop("grad")
        del ed, walk
        torch.cuda.empty_cache()
    out["gan"] = _gan_mesh_rank(dev, real_dir)
    torch.cuda.empty_cache()
    out["sp_families"] = sp_family_run(dev, S.make_mesh_spatial(TP_RANKS, 1))
    if rank:
        for r in out["sp_families"].values():
            r.pop("img")
    objs = [None] * world
    dist.all_gather_object(objs, out)
    return objs


def gan_mesh_pngs():
    """Phase 49's --real_data_dir (``_gan_pngs``)."""
    return _gan_pngs(os.path.join(REPO, "chiprun_out", "gan_mesh", "real"))


def _mesh_rank(real_dir):
    """Phases 44-45's rank (``_parallel_rank``), then 48-50's
    (``_tp_rank``), in one launch of the ranks -> (the first's gathered
    numbers, the second's)."""
    return _parallel_rank(), _tp_rank(real_dir)


def tp_phases(card, dev, ranks=None):
    """Phases 47-50 -> their reports and, under "launches", the tp path's
    launch counts (summed over its ranks and configurations; the split's
    kernels too) and the mesh --updateGAN path's. ranks: what ``_tp_rank``
    gathered, when phase 44's launch ran it on its ranks (``_mesh_rank``;
    launched here when None)."""
    import numpy as np
    import torch

    from latent2im_tpu_torch.parallel.launch import launch

    phase(47, f"the styled conv's tensor-parallel split (partial, epilogue) at the Cin/"
          f"{TP_RANKS} shard of every partner conv ({SIZE} px B={BATCH}, {SIZE_HI} px B=2; "
          "f32 and bf16) against their plain versions")
    sums, details, worst = tp_kernel_phase(dev)
    out = {"kernels": {f"{k[0]}_{k[1]}_{k[2]}": v for k, v in sums.items()},
           "kernel_details": details, "worst_err_over_ref": worst}
    phase("48-50", f"one process on the card: the tp step's numbers "
          f"({', '.join(r[0] for r in TP_RUNS)}) and the same steps in f64 (the plain "
          f"versions), then the {TP_RANKS} ranks of phases 48-50"
          + (" (run in phase 44's launch)" if ranks is not None else ""))
    from latent2im_tpu_torch.walks import walk_map

    refs, f64 = {}, {}
    for name, size, batch, flags in TP_RUNS:
        ed, walk = _par_editor(size, batch, dev, *flags)
        w0 = walk_map(lambda t: t.detach().cpu().numpy().copy(), walk)
        refs[name] = tp_run(ed, walk, batch)
        if size not in f64:  # the f32 and bf16 steps share weights and inputs
            t = time.perf_counter()
            for m in (ed.g, ed.reg, ed.vgg, ed.d):
                m.double()
            z, sampled, _, _ = _par_inputs(ed, batch)
            with plain_kernels():
                f64[size] = reference_step(ed, w0, z, sampled, torch.float64)[:2]
            refs[name]["f64_step_s"] = time.perf_counter() - t
        refs[name]["terms_f64"], refs[name]["grad_f64"] = f64[size]
        del ed, walk
        torch.cuda.empty_cache()
    sp_refs = sp_family_run(dev)
    if ranks is None:
        t = time.perf_counter()
        ranks = launch(_tp_rank, (gan_mesh_pngs(),), world_size=TP_RANKS, device="cuda",
                       timeout=480.0)
        out["ranks_wall_s"] = time.perf_counter() - t
    every, bf16_only = {}, {}  # launches of the tp path, and of its bf16 instances
    for name, size, batch, flags in TP_RUNS:
        got, want = ranks[0]["tp"][name], refs[name]
        dt = "bf16" if "--bf16" in flags else "f32"
        r = {"terms": got["terms"], "terms_one_process": want["terms"],
             "terms_rel": {k: abs(got["terms"][k] - want["terms"][k]) / abs(want["terms"][k])
                           for k in STEP_TERMS},
             "grad_rel_l2_one_process": rel_l2(got["grad"], want["grad"]),
             "grad_rel_l2_f64": rel_l2(got["grad"], want["grad_f64"]),
             "one_process_grad_rel_l2_f64": rel_l2(want["grad"], want["grad_f64"]),
             "step_ms": [rk["tp"][name]["step_ms"] for rk in ranks],
             "step_collectives": [rk["tp"][name]["step_collectives"] for rk in ranks],
             "terms_rel_plain": {k: abs(got["terms_plain"][k] - want["terms_plain"][k])
                                 / abs(want["terms_plain"][k]) for k in STEP_TERMS},
             "terms_rel_f64": {k: abs(got["terms"][k] - want["terms_f64"][k])
                               / abs(want["terms_f64"][k]) for k in STEP_TERMS},
             "one_process_terms_rel_f64": {k: abs(want["terms"][k] - want["terms_f64"][k])
                                           / abs(want["terms_f64"][k]) for k in STEP_TERMS},
             "one_process_step_ms": want["step_ms"], "transport": got["transport"],
             "g_param_bytes": [rk["tp"][name]["g_param_bytes"] for rk in ranks],
             "one_process_g_param_bytes": want["g_param_bytes"],
             "f64_step_s": want.get("f64_step_s")}
        # syntheses per step: each synthesis launches the split once per
        # partner conv on every rank
        per_rank = {rk["tp"][name]["launches"][k] / len(tp_cases(size, batch))
                    for rk in ranks for k in SPLIT}
        assert len(per_rank) == 1 and float(next(iter(per_rank))).is_integer(), (name, per_rank)
        r["syntheses_per_step"] = int(next(iter(per_rank)))
        r["grad_limit"] = max(1e-3, 1.5 * r["one_process_grad_rel_l2_f64"])
        assert all(v <= TP_LOSS_RTOL[dt] for v in r["terms_rel"].values()), (name, r)
        # the loss terms held to the f64 step as the gradient is (phase 9's
        # rule): the bound that tells a tp fault from bf16's own spread
        r["terms_limit_f64"] = {k: max(TP_LOSS_RTOL[dt], 1.5 * v)
                                for k, v in r["one_process_terms_rel_f64"].items()}
        assert all(r["terms_rel_f64"][k] <= r["terms_limit_f64"][k] for k in STEP_TERMS), (name, r)
        assert r["grad_rel_l2_f64"] <= r["grad_limit"], (name, r)
        for rk in ranks:
            for total, key in ((every, "launches"), (bf16_only, "launches_bf16")):
                for k, v in rk["tp"][name][key].items():
                    total[k] = total.get(k, 0) + v
        split = {k: sum(rk["tp"][name]["launches"][k] for rk in ranks) for k in SPLIT}
        assert all(v > 0 for v in split.values()), (name, split)
        if dt == "bf16":  # every split launch a bf16 instance's
            assert all(rk["tp"][name]["launches_bf16"][k] == rk["tp"][name]["launches"][k]
                       for rk in ranks for k in SPLIT), name
        out[name] = r
        c = r["step_collectives"][0]
        log(f"[48] tp step {name} ({size} px, B={batch}) over 1x{TP_RANKS} ranks: loss "
            f"{r['terms']['loss']:.6f} ({r['terms_one_process']['loss']:.6f} one process, "
            f"largest term difference {max(r['terms_rel'].values()):.2e} relative), walk "
            f"gradient rel L2 to f64 {r['grad_rel_l2_f64']:.2e} (one process "
            f"{r['one_process_grad_rel_l2_f64']:.2e}, limit {r['grad_limit']:.2e}; to one "
            f"process {r['grad_rel_l2_one_process']:.2e}); through the plain versions, the "
            f"largest term difference {max(r['terms_rel_plain'].values()):.2e}; terms to the f64 "
            f"step up to {max(r['terms_rel_f64'].values()):.2e} (one process "
            f"{max(r['one_process_terms_rel_f64'].values()):.2e}); {r['syntheses_per_step']} "
            "syntheses a step")
        assert all(b < want["g_param_bytes"] for b in r["g_param_bytes"]), (name, r)
        log(f"    G's parameters by rank {r['g_param_bytes']} bytes (one process "
            f"{r['one_process_g_param_bytes']})")
        log(f"    ms per step by rank {r['step_ms']}, median of {TP_TIMED} timed (one process "
            f"{r['one_process_step_ms']:.2f}); "
            f"rank 0's all-reduces per step: {c['ms']:.2f} ms over {c['calls']} calls, "
            f"{c['bytes_sent']} bytes; launches by rank "
            f"{[rk['tp'][name]['launches'] for rk in ranks]}; on {card}")
    syntheses = {out[name]["syntheses_per_step"] for name, *_ in TP_RUNS}
    assert len(syntheses) == 1, syntheses
    out["syntheses_per_step"] = syntheses.pop()
    # the f32 rows of the kernels line count the f32 instances, the bf16 rows
    # the bf16 ones
    launches = {"tp": {k: every[k] - bf16_only[k] for k in every}}
    out["launches_bf16"] = {"tp": bf16_only}
    assert all(v > 0 for v in launches["tp"].values()), launches["tp"]
    assert all(v > 0 for k, v in bf16_only.items()), bf16_only
    gan = [rk["gan"] for rk in ranks]
    assert gan[0]["has_module"] and not any(g["has_module"] for g in gan[1:]), gan
    assert all(g["digest"] == gan[0]["digest"] for g in gan), "G and D differ across ranks"
    assert gan[0]["gan_steps"] == 2 and all(len(g["broadcasts"]) == 3 for g in gan), gan
    launches["gan_mesh"] = {k: sum(g["launches"][k] for g in gan) for k in gan[0]["launches"]}
    assert all(v > 0 for v in launches["gan_mesh"].values()), launches["gan_mesh"]
    out["gan_mesh"] = {"broadcasts_by_rank": [g["broadcasts"] for g in gan],
                       "iteration_s_by_rank": [g["iteration_s"] for g in gan],
                       "loss": gan[0]["loss"]}
    b = gan[0]["broadcasts"][-1]
    log(f"[49] --updateGAN on a {TP_RANKS}-rank data mesh ({SIZE} px, GAN batch {BATCH}, walk "
        f"batch {BATCH * TP_RANKS}): G and D equal on every rank after each broadcast; rank 0's "
        f"broadcast per iteration {b['bytes']} bytes in {b['ms']:.2f} ms (rank 1 "
        f"{gan[1]['broadcasts'][-1]['ms']:.2f} ms); iteration {gan[0]['iteration_s']:.2f} s on "
        f"rank 0; walk loss {gan[0]['loss']:.4f}; launches {launches['gan_mesh']}; on {card}")
    out["sp_families"] = {}
    for name, want in sp_refs.items():
        got = ranks[0]["sp_families"][name]
        r = {"rel_l2_one_process": rel_l2(got["img"], want["img"]),
             "edit_ms": [rk["sp_families"][name]["edit_ms"] for rk in ranks],
             "one_process_ms": want["edit_ms"],
             "collectives": [rk["sp_families"][name]["collectives"] for rk in ranks]}
        assert got["img"].shape == want["img"].shape and np.isfinite(got["img"]).all(), name
        assert r["rel_l2_one_process"] <= EDIT_REL_L2, (name, r)
        out["sp_families"][name] = r
        c = r["collectives"][0]
        what = (f"model_256 apply_alpha, B={BATCH}" if name == "pggan"
                else f"step {SP_FAMILY_S1_STEP}, B=1")
        log(f"[50] sp of {name} over 1x{TP_RANKS} ranks ({what}): rel L2 to one process "
            f"{r['rel_l2_one_process']:.2e}; ms per edit by rank {r['edit_ms']} (one process "
            f"{r['one_process_ms']:.2f}); rank 0's collectives {c['ms']:.2f} ms over "
            f"{c['calls']} calls, halo {c['halo_bytes']} B, gather {c['gather_bytes']} B; "
            f"on {card}")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# phase 51: the geometric tasks' host targets (--host_targets)
# ---------------------------------------------------------------------------

GEO_HOST_STEPS = 3
GEO_HOST_FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_host_targets")
# colorlab's recorded targets go through libm's powers in the Lab round
# trip, so another machine's libm may move them by ulps of float64
GEO_HOST_LAB_TOL = 1e-6


def geometric_host_step_launches(size=SIZE):
    """{kernel: launches per --host_targets step}: the original synthesized
    outside the step (a style MLP and a synthesis forward), then the step's
    own style MLP, edited synthesis and its backward: one style MLP more
    than geometric_step_launches(), which counts both syntheses."""
    n = geometric_step_launches(size)
    n["fused_act"] += 8
    return n


def _host_target_fixtures():
    """tests/fixtures/torch_host_targets/make_fixtures.py, loaded by path
    (its cv2 and JAX imports sit inside main, which runs only where it
    records)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "host_target_fixtures", os.path.join(GEO_HOST_FIXTURES, "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_target_fixture_check():
    """The port's get_target_np (tasks/cv2_np.py's warps) on the fixture
    images against the cv2 targets and masks recorded where cv2 is: the
    SHA-256 of each, colorlab within GEO_HOST_LAB_TOL of its grid. Where a
    rotation's matrix here differs from the recorded one in the last bits
    (numpy's sine on this machine), the warp is held on the recorded matrix
    instead, and the case is named."""
    import hashlib

    import numpy as np

    from latent2im_tpu_torch.tasks import cv2_np
    from latent2im_tpu_torch.tasks import geometric as geo

    fx = _host_target_fixtures()
    with open(os.path.join(GEO_HOST_FIXTURES, "targets.json")) as f:
        meta = json.load(f)
    grids = np.load(os.path.join(GEO_HOST_FIXTURES, "targets.npz"))
    sha = lambda a: hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()  # noqa: E731
    out = {"cases": 0, "bit_equal": 0, "matrix_differs": [], "lab_max_abs": 0.0, "ms": {}}
    for name, task, size, batch, alpha in fx.cases():
        rec = meta[name]
        imgs = fx.images(size, batch, fx.seed_of(size))
        a = np.asarray(alpha, np.float32) if task.startswith("color") else alpha
        t0 = time.perf_counter()
        target, mask = geo.GEOMETRIC_TASKS[task]().get_target_np(imgs.copy(), a)
        out["ms"][name] = (time.perf_counter() - t0) * 1e3
        assert sha(mask) == rec["mask"][2] and list(mask.shape) == rec["mask"][0], name
        out["cases"] += 1
        if sha(target) == rec["target"][2]:
            out["bit_equal"] += 1
        elif task == "colorlab":
            pass
        elif task in ("rotate2d", "rotate3d"):  # held on the recorded matrix
            m = np.asarray(rec["matrix"])
            warp = cv2_np.warp_affine if task == "rotate2d" else cv2_np.warp_perspective
            again = np.stack([warp(im, m, (size, size)) for im in imgs]).astype(np.float64)
            assert sha(again) == rec["target"][2], name
            out["matrix_differs"].append(name)
        else:
            raise AssertionError(f"{name}: the host target differs from cv2's")
        if task == "colorlab":
            step = size // 16
            err = float(np.abs(target[:, ::step, ::step] - grids[name]).max())
            out["lab_max_abs"] = max(out["lab_max_abs"], err)
            assert err <= GEO_HOST_LAB_TOL, (name, err)
    assert out["cases"] == 28, out
    return out


def _host_reference(ed, w0, z, alpha_graph, target, mask, dtype):
    """The --host_targets step's loss and walk gradient (linear_w) at walk
    w0 on the given target and mask, composed here from G in ``dtype``."""
    import torch

    from latent2im_tpu_torch.engine import losses as L

    dev = ed.device
    z, a, t, m = (torch.as_tensor(x, dtype=dtype, device=dev)
                  for x in (z, alpha_graph, target, mask))
    w = torch.as_tensor(w0, dtype=dtype, device=dev).requires_grad_(True)
    with torch.no_grad():
        latent = ed.g.style_forward(z)[:, None].expand(-1, ed.cfg.n_latent, -1)
    img = ed.g.synthesize(latent + torch.einsum("ba,ald->bld", a, w)).to(dtype)
    loss = L.masked_l2(img, t, m)
    loss.backward()
    return loss.item(), w.grad.double().cpu().numpy().ravel()


def _host_step_inputs(ed):
    import numpy as np

    z = np.random.RandomState(67).randn(CMP_BATCH, ed.cfg.dim_z).astype(np.float32)
    return z, np.full((CMP_BATCH, 1), 20 / 45, np.float32), 20


def geo_host_cpu_side():
    """The CPU half of phase 51's step parity (the CpuReferences worker):
    rotate2d at SIZE px, B=CMP_BATCH, alpha 20: the original and its host
    target and mask, one make_geometric_train_step step (loss, walk
    gradient), and the same step in f64 on the same target and mask."""
    import numpy as np
    import torch

    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.engine.train import make_geometric_train_step, make_optimizer
    from latent2im_tpu_torch.tasks.transforms import get_task

    conf = geo_conf("rotate2d")
    ed, walk, _ = build_editor_from_options(conf, device="cpu")
    z, alpha_graph, alpha = _host_step_inputs(ed)
    t = time.perf_counter()
    with torch.no_grad():
        img = ed.synth(ed.edit_latent(z)).numpy()
    target, mask = get_task("rotate2d").get_target_np(img, alpha)
    target, mask = np.float32(target), np.float32(mask)
    w0 = walk["w"].detach().numpy().copy()
    walk["w"].requires_grad_(True)
    m = make_geometric_train_step(ed, make_optimizer(walk, conf.learning_rate))(
        walk, z, alpha_graph, target, mask)
    out = {"img": img, "target": target, "mask": mask, "w0": w0, "loss": float(m["loss"]),
           "grad": walk["w"].grad.numpy().astype(np.float64).ravel(),
           "cpu_step_s": time.perf_counter() - t}
    t = time.perf_counter()
    ed.g.double()
    out["ref_loss"], out["ref_grad"] = _host_reference(ed, w0, z, alpha_graph, target, mask,
                                                       torch.float64)
    out["cpu_f64_reference_s"] = time.perf_counter() - t
    return out


def geo_host_step_phase(cpu):
    """Phase 51's step parity: the same rotate2d step on the card, its
    original within phase 6's image bounds of the CPU's (1e-3 relative L2
    and max-abs), its host target within 1e-3 relative L2 and its mask
    equal; then the card's step on the CPU's target and mask: the loss
    within 1e-3 of the CPU's and of f64, the walk gradient within max(1e-3,
    1.5 x the CPU f32 gradient's distance to f64) of f64 (phase 9's rule)."""
    import numpy as np
    import torch

    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.engine.train import make_geometric_train_step, make_optimizer
    from latent2im_tpu_torch.tasks.transforms import get_task

    conf = geo_conf("rotate2d")
    ed, walk, _ = build_editor_from_options(conf)  # cuda: the default
    z, alpha_graph, alpha = _host_step_inputs(ed)
    with torch.no_grad():
        img = ed.synth(ed.edit_latent(z)).float().cpu().numpy()
    target, mask = get_task("rotate2d").get_target_np(img, alpha)
    with torch.no_grad():  # the CPU's walk: the same inputs
        walk["w"].copy_(torch.from_numpy(cpu["w0"]))
    walk["w"].requires_grad_(True)
    m = make_geometric_train_step(ed, make_optimizer(walk, conf.learning_rate))(
        walk, z, alpha_graph, cpu["target"], cpu["mask"])
    grad = walk["w"].grad.detach().cpu().numpy().astype(np.float64).ravel()
    out = {"img_rel_l2": rel_l2(img, cpu["img"]),
           "img_max_abs": float(np.abs(img - cpu["img"]).max()),
           "target_rel_l2": rel_l2(np.float32(target), cpu["target"]),
           "mask_equal": bool(np.array_equal(np.float32(mask), cpu["mask"])),
           "mask_share": float(cpu["mask"].mean()),
           "loss": float(m["loss"]), "loss_cpu": cpu["loss"], "loss_f64": cpu["ref_loss"],
           "walk_grad_rel_l2_card_f64": rel_l2(grad, cpu["ref_grad"]),
           "walk_grad_rel_l2_cpu_f64": rel_l2(cpu["grad"], cpu["ref_grad"]),
           "walk_grad_rel_l2_card_cpu": rel_l2(grad, cpu["grad"]),
           "cpu_step_s": cpu["cpu_step_s"], "cpu_f64_reference_s": cpu["cpu_f64_reference_s"]}
    out["walk_grad_limit"] = max(1e-3, 1.5 * out["walk_grad_rel_l2_cpu_f64"])
    assert out["img_rel_l2"] <= 1e-3 and out["img_max_abs"] <= 1e-3, out
    assert out["target_rel_l2"] <= 1e-3 and out["mask_equal"] and 0 < out["mask_share"] < 1, out
    for k in ("loss_cpu", "loss_f64"):
        assert abs(out["loss"] - out[k]) <= 1e-3 * abs(out[k]), out
    assert np.isfinite(grad).all()
    assert out["walk_grad_rel_l2_card_f64"] <= out["walk_grad_limit"], out
    del ed, walk
    torch.cuda.empty_cache()
    return out


def geo_host_train_phase():
    """Phase 51's training: the seven tasks at SIZE px, full width,
    linear_w, B=BATCH, through geometric_train_loop(device_targets=False):
    per task a warmup step and GEO_HOST_STEPS counted ones (ms per step by
    CUDA events, the host warp's ms per step on the host clock, peak GB,
    launches equal to GEO_HOST_STEPS x geometric_host_step_launches())."""
    import dataclasses
    import functools

    import torch

    from latent2im_tpu_torch.engine.build import build_editor_from_options
    from latent2im_tpu_torch.engine.train import geometric_train_loop
    from latent2im_tpu_torch.tasks.transforms import get_task
    from latent2im_tpu_torch.walks import init_walk

    per_step = geometric_host_step_launches()
    conf = geo_conf("zoom")
    ed, _, _ = build_editor_from_options(conf)  # cuda: the default
    loop = functools.partial(geometric_train_loop, device_targets=False)
    out, gen = {"per_step_launches": per_step, "tasks": {}}, torch.Generator().manual_seed(68)
    for name in GEO_TASKS:
        ed.cfg = dataclasses.replace(ed.cfg, attr_list=(name,), walk_kind="linear_w")
        task = get_task(name)
        warp_s = []
        real = task.get_target_np

        def timed_target(imgs, alpha, real=real, warp_s=warp_s):
            t0 = time.perf_counter()
            got = real(imgs, alpha)
            warp_s.append(time.perf_counter() - t0)
            return got

        task.get_target_np = timed_target
        walk = init_walk("linear_w", ed.cfg.dim_z, ed.cfg.n_latent, [name], generator=gen,
                         device=ed.device)
        walk, r = _timed_train(ed, task, walk, GEO_HOST_STEPS, conf.learning_rate, loop=loop)
        expect = {k: GEO_HOST_STEPS * v for k, v in per_step.items()}
        assert r["launches"] == expect, (name, r["launches"], expect)
        assert len(warp_s) == 1 + GEO_HOST_STEPS, warp_s
        r["host_warp_ms"] = 1e3 * sum(warp_s[1:]) / GEO_HOST_STEPS
        r["rest_ms"] = r["step_ms_cuda_events"] - r["host_warp_ms"]
        out["tasks"][name] = r
    del ed, walk
    torch.cuda.empty_cache()
    return out


def geo_host_cli_phase():
    """Phase 51's CLI: ``cli.train --transform rotate3d --host_targets`` for
    two steps at SIZE px in chiprun_out/geo_host_cli/ (counted)."""
    import shutil

    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.cli import train as tcli

    root = os.path.join(REPO, "chiprun_out", "geo_host_cli")
    shutil.rmtree(root, ignore_errors=True)
    opt = geo_conf("rotate3d", "--host_targets", "--num_samples", str(2 * BATCH),
                   "--n_epochs", "1", "--model_save_freq", "0", root=root)
    t0 = time.perf_counter()
    ops.reset_launches()
    _, history = tcli.run(opt)  # cuda: the entry point's default
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert len(history) == 2 and all(math.isfinite(h) for h in history), history
    assert os.path.isfile(os.path.join(opt.output_dir, "model_w_1_final_walk_module.ckpt"))
    expect = {k: 2 * v for k, v in geometric_host_step_launches().items()}
    assert counts == expect, (counts, expect)
    return {"seconds": time.perf_counter() - t0, "losses": history, "launches": counts}


def host_target_phase(card, cpu):
    """Phase 51 -> its report and, under "launches", the counted steps'
    launch counts (path host_targets: the seven tasks and the CLI)."""
    import torch

    phase(51, f"--host_targets: the cv2 warps in numpy against cv2's recordings, the seven "
          f"tasks at {SIZE} px B={BATCH}, rotate2d's step card against CPU, the CLI")
    fixtures = host_target_fixture_check()
    log(f"    {fixtures['cases']} recorded cases, {fixtures['bit_equal']} bit-equal, "
        f"colorlab max-abs {fixtures['lab_max_abs']:.3g}, held on the recorded matrix: "
        f"{fixtures['matrix_differs']}")
    train = geo_host_train_phase()
    for name, r in train["tasks"].items():
        log(f"    {name}: {r['step_ms_cuda_events']:.2f} ms per step (CUDA events over "
            f"{r['steps']}), of which host warp {r['host_warp_ms']:.2f} ms, the rest "
            f"{r['rest_ms']:.2f} ms; peak {r['peak_mem_gb']:.2f} GB, loss "
            f"{r['first']['loss']:.4f} -> {r['last']['loss']:.4f}, on {card}")
    step = geo_host_step_phase(cpu)
    log(f"    rotate2d step, card against CPU: {json.dumps(step)}")
    cli = geo_host_cli_phase()
    log(f"    train --transform rotate3d --host_targets: {cli['seconds']:.1f} s, losses "
        f"{cli['losses']}")
    torch.cuda.empty_cache()
    counts = dict.fromkeys(SOURCE, 0)
    for r in list(train["tasks"].values()) + [cli]:
        for k, v in r["launches"].items():
            counts[k] += v
    return {"fixtures": fixtures, "train": train, "step": step,
            "cli": {k: v for k, v in cli.items() if k != "launches"},
            "launches": {"host_targets": counts}}


# ---------------------------------------------------------------------------
# phase 52: progressive, CMYK and YCCK JPEG
# ---------------------------------------------------------------------------

PROG_FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_jpeg_progressive")
PROG_BP_PHOTO = "prog_256_420"


def jpeg_progressive_phase(dev):
    """Phase 52: every fixture of tests/fixtures/torch_jpeg_progressive/
    (progressive gray and 4:4:4 / 4:2:2 / 4:2:0, an odd size, restart
    intervals, CMYK sequential and progressive, YCCK) decoded by the Python
    decoder and by the host C++ (``host_cpp=True``), each equal to its
    recorded Pillow decode; decode ms per photo of each (median of 3); the
    regressor trainer's loader on a folder of them (C and Python batches
    equal, batches/s); ``python -m latent2im_tpu_torch.cli.bp`` on the
    256 px progressive photo (counted)."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        return _jpeg_progressive_phase(dev, root)


def _jpeg_progressive_phase(dev, root):
    import hashlib
    import runpy
    import shutil

    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.cli import train_regressor as tr
    from latent2im_tpu_torch.utils import jpeg

    with open(os.path.join(PROG_FIXTURES, "decodes.json")) as f:
        meta = json.load(f)
    npz = np.load(os.path.join(PROG_FIXTURES, "decodes.npz"))
    names = sorted(k for k in meta if k != "pillow")
    assert len(names) == 11, names
    out = {"decode_ms": {}}
    paths = []
    for name in names:
        path = os.path.join(PROG_FIXTURES, f"{name}.jpg")
        paths.append(path)
        with open(path, "rb") as f:
            data = f.read()
        for route in (False, True):
            got = jpeg.jpeg_decode_rgb(data, host_cpp=route)
            ok = (list(got.shape) == meta[name]["shape"] and np.array_equal(got, npz[name])
                  and hashlib.sha256(got.tobytes()).hexdigest() == meta[name]["sha256"])
            if not ok:
                raise AssertionError(f"{name}.jpg (host_cpp={route}) does not decode to its "
                                     "Pillow decode")
        out["decode_ms"][name] = {
            "c": _median_ms(lambda: jpeg.jpeg_decode_rgb(data, host_cpp=True)),
            "python": _median_ms(lambda: jpeg.jpeg_decode_rgb(data))}
    log(f"    {len(names)} fixtures equal to their Pillow decodes in Python and C++; decode "
        f"ms per photo (C, Python): {json.dumps(out['decode_ms'])}")

    idx = list(tr.index_batches(np.arange(len(paths)), 4))
    batches = {}
    for route in (True, False):
        t0 = time.perf_counter()
        with tr.make_loader(paths, REG_SIZE, host_cpp=route) as loader:
            batches[route] = list(loader.batches(idx))
        out[f"loader_batches_per_s_{'c' if route else 'python'}"] = (
            len(idx) / (time.perf_counter() - t0))
    assert len(batches[True]) == len(idx) == 3
    for (a, ia), (b, ib) in zip(batches[True], batches[False]):
        assert ia == ib and a.shape == (len(ia), REG_SIZE, REG_SIZE, 3) and np.array_equal(a, b)

    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir)
    shutil.copy(os.path.join(PROG_FIXTURES, f"{PROG_BP_PHOTO}.jpg"), img_dir)
    save_dir = os.path.join(root, "bp")
    saved_argv = sys.argv
    sys.argv = ["bp", "--img_dir", img_dir, "--save_dir", save_dir, "--resolution", str(SIZE),
                "--n_loops", str(JPEG_BP_LOOPS), "--show_freq", "5", "--batch_size", "1"]
    t0 = time.perf_counter()
    try:
        ops.reset_launches()
        runpy.run_module("latent2im_tpu_torch.cli.bp", run_name="__main__")
        torch.cuda.synchronize()
        out["launches"] = {"bp_progressive": ops.launch_counts()}
    finally:
        sys.argv = saved_argv
    out["bp_seconds"] = time.perf_counter() - t0
    assert all(out["launches"]["bp_progressive"][k] > 0 for k in SOURCE), out["launches"]
    w = np.load(os.path.join(save_dir, "latent", "0_w.npy"))
    curve = np.load(os.path.join(save_dir, "0_loss.npy"))
    assert w.shape == (1, 2 * int(math.log2(SIZE)) - 2, 512) and np.isfinite(w).all()
    assert curve.shape == (JPEG_BP_LOOPS,) and np.isfinite(curve).all(), curve
    out["bp_loss"] = (float(curve[0]), float(curve[-1]))
    log(f"    loader on them (B=4, {REG_SIZE} px): C {out['loader_batches_per_s_c']:.2f}, "
        f"Python {out['loader_batches_per_s_python']:.2f} batches/s, equal; bp on "
        f"{PROG_BP_PHOTO}.jpg: {out['bp_seconds']:.1f} s, loss (first, last) {out['bp_loss']}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 53: WEBP, arithmetic-coded JPEG, 16-bit and Adam7 PNG
# ---------------------------------------------------------------------------

KINDS_FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_image_kinds")
KINDS_BP_PHOTOS = ("webp_lossy_256.webp", "webp_anim_40x56.webp", "png16_256.png")


def image_kinds_phase(dev):
    """Phase 53: every fixture of tests/fixtures/torch_image_kinds/ decoded
    by ``read_image_rgb`` in Python, and the WEBPs and the JPEGs (arithmetic-
    coded, lossless, block-smoothed progressive) also by the host C++
    (``host_cpp=True``), each equal to its recorded Pillow decode
    (the 256 px photos by their SHA-256); decode ms per photo on each route
    (median of 3); ``python -m latent2im_tpu_torch.cli.bp`` on a folder of
    the 256 px lossy WEBP, the animated WEBP and the 256 px 16-bit PNG
    (counted)."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        return _image_kinds_phase(dev, root)


def _image_kinds_phase(dev, root):
    import hashlib
    import runpy
    import shutil

    import numpy as np
    import torch

    from latent2im_tpu_torch import ops
    from latent2im_tpu_torch.utils import image as imgmod

    with open(os.path.join(KINDS_FIXTURES, "decodes.json")) as f:
        meta = json.load(f)
    npz = np.load(os.path.join(KINDS_FIXTURES, "decodes.npz"))
    files = sorted(f for f in os.listdir(KINDS_FIXTURES) if f.endswith((".webp", ".jpg", ".png")))
    assert sorted(os.path.splitext(f)[0] for f in files) == sorted(  # GIF, BMP, TIFF: phase 54
        k for k in meta if k != "pillow" and not k.startswith(("gif_", "bmp_", "tiff_"))) \
        and len(files) == 29, files
    out = {"decode_ms": {}}
    for name in files:
        key = os.path.splitext(name)[0]
        path = os.path.join(KINDS_FIXTURES, name)
        routes = (False, True) if name.endswith((".jpg", ".webp")) else (False,)
        for route in routes:
            got = imgmod.read_image_rgb(path, host_cpp=route)
            ok = (list(got.shape) == meta[key]["shape"]
                  and hashlib.sha256(got.tobytes()).hexdigest() == meta[key]["sha256"]
                  and (key not in npz.files or np.array_equal(got, npz[key])))
            if not ok:
                raise AssertionError(f"{name} (host_cpp={route}) does not decode to its "
                                     "Pillow decode")
        out["decode_ms"][key] = {
            ("c" if route else "python"): _median_ms(
                lambda route=route: imgmod.read_image_rgb(path, host_cpp=route))
            for route in routes}
    log(f"    {len(files)} fixtures equal to their Pillow decodes (WEBP and JPEG in Python "
        f"and C++); decode ms per photo: {json.dumps(out['decode_ms'])}")

    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir)
    for name in KINDS_BP_PHOTOS:
        shutil.copy(os.path.join(KINDS_FIXTURES, name), img_dir)
    save_dir = os.path.join(root, "bp")
    saved_argv = sys.argv
    sys.argv = ["bp", "--img_dir", img_dir, "--save_dir", save_dir, "--resolution", str(SIZE),
                "--n_loops", str(JPEG_BP_LOOPS), "--show_freq", "5",
                "--batch_size", str(len(KINDS_BP_PHOTOS))]
    t0 = time.perf_counter()
    try:
        ops.reset_launches()
        runpy.run_module("latent2im_tpu_torch.cli.bp", run_name="__main__")
        torch.cuda.synchronize()
        out["launches"] = {"bp_image_kinds": ops.launch_counts()}
    finally:
        sys.argv = saved_argv
    out["bp_seconds"] = time.perf_counter() - t0
    assert all(out["launches"]["bp_image_kinds"][k] > 0 for k in SOURCE), out["launches"]
    w = np.load(os.path.join(save_dir, "latent", "0_w.npy"))
    curve = np.load(os.path.join(save_dir, "0_loss.npy"))
    assert w.shape == (len(KINDS_BP_PHOTOS), 2 * int(math.log2(SIZE)) - 2, 512), w.shape
    assert np.isfinite(w).all()
    assert curve.shape == (JPEG_BP_LOOPS,) and np.isfinite(curve).all(), curve
    out["bp_loss"] = (float(curve[0]), float(curve[-1]))
    log(f"    bp on {', '.join(KINDS_BP_PHOTOS)}: {out['bp_seconds']:.1f} s, loss (first, "
        f"last) {out['bp_loss']}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 54: the native path (latent2im_tpu_torch/native/), item 28's formats
# ---------------------------------------------------------------------------

NATIVE_FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_native")
NATIVE_TIMED = {"256x256": ("torch_jpeg/photo_256_422.jpg", 256),
                "1024x1024": ("torch_jpeg/photo_1024_420.jpg", 1024)}
NATIVE_GAN_ITERS = 2


def native_phase(dev):
    """Phase 54 in a temporary directory."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:  # the regressor's ~0.6 GB of checkpoints
        return _native_phase(dev, root)


def _sha256(a) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(a, np.uint8).tobytes()).hexdigest()


def _regressor_cli(dev, root, reg, fix):
    """The regressor CLI (2 epochs) on a recorded split (``reg``: its files
    under tests/fixtures (``fix``), its training and test lists, size and
    batch, and the JAX trainer's batches): every training batch (the native
    Loader) and test batch (Pillow's path) equal to the recorded ones ->
    its lines, seconds and batch counts."""
    import contextlib
    import io
    import shutil

    from latent2im_tpu_torch.cli import train_regressor as tr

    data_dir, split_dir = os.path.join(root, "reg"), os.path.join(root, "split")
    os.makedirs(split_dir)
    for key, rel in reg["files"].items():
        os.makedirs(os.path.join(data_dir, os.path.dirname(key)), exist_ok=True)
        shutil.copy(os.path.join(fix, rel), os.path.join(data_dir, key))
    for part, keys in reg["split"].items():
        with open(os.path.join(split_dir, f"{part}.txt"), "w") as f:
            f.write("\n".join(keys) + "\n")
    with open(os.path.join(root, "labels.tsv"), "w") as f:
        for i, key in enumerate(reg["files"]):
            f.write(key + "".join(f"\t{(i * 7 + k) % 10 / 10:.1f},1" for k in range(REG_OUT))
                    + "\n")
    got_train, got_test = [], []
    real_batches, real_loader = tr.native_batches, tr.make_loader

    def native_batches(loader):
        for u8, idx in real_batches(loader):
            got_train.append({"idx": list(idx), "sha256": _sha256(u8)})
            yield u8, idx

    class TestLoader:
        def __init__(self, paths, size, host_cpp):
            self.pool = real_loader(paths, size, host_cpp)

        def batches(self, idx):
            for u8, i in self.pool.batches(idx):
                got_test.append({"idx": [int(v) for v in i], "sha256": _sha256(u8)})
                yield u8, i

        def close(self):
            self.pool.close()

    tr.native_batches, tr.make_loader = native_batches, TestLoader
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            tr.main(["--data_dir", data_dir, "--label_path", os.path.join(root, "labels.tsv"),
                     "--split_dir", split_dir, "--ckpt_dir", os.path.join(root, "ckpt"),
                     "--image_size", str(reg["size"]), "--batch_size", str(reg["batch"]),
                     "--n_epochs", "2"], device=dev)
    finally:
        tr.native_batches, tr.make_loader = real_batches, real_loader
    lines = buf.getvalue().splitlines()
    n_train, n_test = len(reg["split"]["training"]), len(reg["split"]["test"])
    assert lines[:2] == [f"train {n_train} / test {n_test} images", "native loader: True"], lines
    test_line = [ln for ln in lines if ln.startswith("Test epoch 1; Loss: ")]
    assert len(test_line) == 1 and math.isfinite(float(test_line[0].rsplit(" ", 1)[1])), lines
    want_train = [{"idx": b["idx"], "sha256": b["sha256"]} for b in reg["training"]]
    assert got_train == want_train, ("training batches", got_train, want_train)
    assert got_test == reg["test"], ("test batches", got_test, reg["test"])
    return {"lines": lines, "seconds": time.perf_counter() - t0, "test_line": test_line[0],
            "train_batches": len(got_train), "test_batches": len(got_test)}


def _native_phase(dev, root):
    """Phase 54: (1) every recording of tests/fixtures/torch_native/native.json
    (what the JAX package's extension makes of each photo at sizes below, at
    and above its crop, and its epoch orders) equal in Python and through
    the host C++, and ms per photo of each route at 256 and 1024 px; (2)
    --updateGAN (phase 21's run, 256 px B=4, a warmup and NATIVE_GAN_ITERS
    counted iterations) on the native stream of the recorded directory, each
    batch's SHA-256 the JAX stream's, launches as path ``gan_native``; (3)
    the regressor CLI on a split whose training list holds a GIF and a CMYK
    JPEG (black there) and whose test list a GIF, a BMP and a TIFF (read as
    Pillow reads them): its batches the JAX trainer's recorded ones, its
    lines; (4) the GIF, BMP and TIFF fixtures equal to their Pillow decodes."""
    import shutil

    import numpy as np
    import torch

    from latent2im_tpu_torch.cli import train as tcli
    from latent2im_tpu_torch.native import _l2i_native as nat
    from latent2im_tpu_torch.native import order
    from latent2im_tpu_torch.utils import image as imgmod

    fix = os.path.dirname(NATIVE_FIXTURES)
    with open(os.path.join(NATIVE_FIXTURES, "native.json")) as f:
        rec = json.load(f)
    out = {"launches": {}}
    # (1) the recordings, both routes
    n_checked = 0
    for rel, sizes in rec["load_resize"].items():
        path = os.path.join(fix, rel)
        for size, want in sizes.items():
            for route in (False, True):
                try:
                    got = _sha256(nat.load_resize(path, int(size), host_cpp=route))
                except OSError:
                    got = "fail"
                if got != want:
                    raise AssertionError(f"{rel} at {size} px (host_cpp={route}): {got}, "
                                         f"recorded {want}")
                n_checked += 1
    for key, epochs in rec["orders"].items():
        n, b = map(int, key.split("_"))
        o = list(range(n))
        for e, want in enumerate(epochs):
            order.std_shuffle(o, e)
            assert [o[i:i + b] for i in range(0, n, b)] == want, (key, e)
    out["ms_per_photo"] = {
        label: {route: _median_ms(lambda rel=rel, size=size, c=(route == "c"): nat.load_resize(
            os.path.join(fix, rel), size, host_cpp=c)) for route in ("c", "python")}
        for label, (rel, size) in NATIVE_TIMED.items()}
    log(f"    {n_checked} decodes (Python and C++) and {len(rec['orders'])} epoch orders equal "
        f"to the JAX extension's; decode + resize ms per photo: {json.dumps(out['ms_per_photo'])}")

    # (2) --updateGAN on the native stream
    real_dir = os.path.join(root, "real")
    os.makedirs(real_dir)
    for name, rel in rec["gan_stream"]["files"].items():
        shutil.copy(os.path.join(fix, rel), os.path.join(real_dir, name))
    assert (rec["gan_stream"]["size"], rec["gan_stream"]["batch"]) == (SIZE, BATCH)
    seen = []
    real_make = tcli._make_real_batcher

    def recording(*a, **kw):
        nxt = real_make(*a, **kw)

        def next_batch(load=True):
            b = nxt(load)
            if load:
                seen.append(_sha256(b))
            return b

        next_batch.loader = nxt.loader
        return next_batch

    tcli._make_real_batcher = recording
    try:
        gan = gan_train_phase(dev, iters=NATIVE_GAN_ITERS, real_dir=real_dir)
    finally:
        tcli._make_real_batcher = real_make
    want = rec["gan_stream"]["sha256"][:NATIVE_GAN_ITERS + 1]
    assert seen == want, ("the --updateGAN batches are not the JAX native stream", seen, want)
    out["launches"]["gan_native"] = gan.pop("launches")
    out["gan"] = {k: gan[k] for k in ("iteration_ms_cuda_events", "d_step_ms_cuda_events",
                                      "g_step_ms_cuda_events", "peak_mem_gb")}
    log(f"    --updateGAN on the native stream: {len(seen)} batches equal to the JAX stream; "
        f"{gan['iteration_ms_cuda_events']:.1f} ms an iteration (CUDA events); launches "
        f"{json.dumps(out['launches']['gan_native'])}")
    torch.cuda.empty_cache()

    # (3) the regressor CLI on GIF, BMP, TIFF and a CMYK JPEG
    out["regressor"] = _regressor_cli(dev, root, rec["regressor"], fix)
    log(f"    regressor CLI: {out['regressor']['train_batches']} training batches (native) and "
        f"{out['regressor']['test_batches']} test batches (Pillow) equal to the JAX trainer's; "
        f"{out['regressor']['test_line']}")
    torch.cuda.empty_cache()

    # (4) item 28's fixtures
    with open(os.path.join(KINDS_FIXTURES, "decodes.json")) as f:
        meta = json.load(f)
    npz = np.load(os.path.join(KINDS_FIXTURES, "decodes.npz"))
    names = sorted(f for f in os.listdir(KINDS_FIXTURES) if f.endswith((".gif", ".bmp", ".tif")))
    assert len(names) == 11, names
    out["item28_decode_ms"] = {}
    for name in names:
        key = os.path.splitext(name)[0]
        path = os.path.join(KINDS_FIXTURES, name)
        got = imgmod.read_image_rgb(path)
        if list(got.shape) != meta[key]["shape"] or _sha256(got) != meta[key]["sha256"] or \
                not np.array_equal(got, npz[key]):
            raise AssertionError(f"{name} does not decode to its Pillow decode")
        out["item28_decode_ms"][key] = _median_ms(lambda path=path: imgmod.read_image_rgb(path))
    log(f"    {len(names)} GIF, BMP and TIFF fixtures equal to their Pillow decodes; ms per "
        f"photo {json.dumps(out['item28_decode_ms'])}")
    return out


CORRUPT_FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_jpeg_corrupt")
FORMATS_FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_image_formats")
# the corrupt JPEGs timed in phase 55: a small one and one past 64 KiB
CORRUPT_TIMED = ("bad_code_baseline_64x48.jpg", "large_inserted_dht_at_64k_340x250.jpg")
# phase 55's photo-sized decodes: (size, decodes timed, of which the median is kept)
PHOTO_SIZES = ((256, 3), (1024, 1))
PHOTO_JPEGS = {256: "photo_256_422.jpg", 1024: "photo_1024_420.jpg"}


def corrupt_formats_phase(dev):
    """Phase 55 in a temporary directory."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:  # the regressor's checkpoints
        return _corrupt_formats_phase(dev, root)


def _corrupt_formats_phase(dev, root):
    """Phase 55: (1) the corrupt JPEGs of tests/fixtures/torch_jpeg_corrupt
    (libjpeg's recovery, ROADMAP C.11) in both modes, in Python and
    through the host C++: the Pillow mode equal to Pillow's recorded
    decodes (or failing where it fails), the libjpeg mode's load_resize
    equal to the JAX extension's recorded ones; ms a photo of each route;
    (2) one epoch of the port's native Loader (host C++) over those files,
    its batches the extension's; (3) the files of
    tests/fixtures/torch_image_formats (Netpbm, QOI, TGA, PCX, SGI, ICO,
    CUR, DIB and the rest of TIFF) equal to their Pillow decodes; (4) the
    regressor CLI on a split of corrupt JPEGs (native) and those formats
    (Pillow), every batch the JAX trainer's; (5) ms a photo at 256 and
    1024 px (``_photo_decodes``)."""
    import numpy as np
    import torch

    from latent2im_tpu_torch.native import _l2i_native as nat
    from latent2im_tpu_torch.utils import image as imgmod
    from latent2im_tpu_torch.utils import jpeg

    with open(os.path.join(CORRUPT_FIXTURES, "record.json")) as f:
        rec = json.load(f)
    npz = np.load(os.path.join(CORRUPT_FIXTURES, "decodes.npz"))
    out = {"launches": {}}
    # (1) both modes, both routes
    n_checked = 0
    for name, want in rec["pillow"].items():
        with open(os.path.join(CORRUPT_FIXTURES, name), "rb") as f:
            data = f.read()
        for route in (False, True):
            try:
                got = jpeg.jpeg_decode_rgb(data, host_cpp=route)
            except ValueError:
                got = None
            if want == "fail":
                assert got is None, f"{name} decodes (host_cpp={route}); Pillow fails it"
            elif got is None or _sha256(got) != want["sha256"] or not np.array_equal(
                    got, npz[os.path.splitext(name)[0]]):
                raise AssertionError(f"{name} (host_cpp={route}) is not Pillow's decode")
            n_checked += 1
        for size, sha in rec["extension"][name].items():
            for route in (False, True):
                try:
                    got = _sha256(nat.load_resize(os.path.join(CORRUPT_FIXTURES, name),
                                                  int(size), host_cpp=route))
                except OSError:
                    got = "fail"
                assert got == sha, f"{name} at {size} px (host_cpp={route}): {got}, " \
                                   f"the extension {sha}"
                n_checked += 1
    def decode(data, c, lj):  # a file one mode fails is timed to its failure
        try:
            jpeg.jpeg_decode_rgb(data, host_cpp=c, libjpeg=lj)
        except ValueError:
            pass

    out["ms_per_photo"] = {}
    for name in CORRUPT_TIMED:
        with open(os.path.join(CORRUPT_FIXTURES, name), "rb") as f:
            data = f.read()
        out["ms_per_photo"][name] = {
            f"{mode}_{route}": _median_ms(lambda lj=(mode == "libjpeg"), c=(route == "c"):
                                          decode(data, c, lj))
            for mode in ("pillow", "libjpeg") for route in ("c", "python")}
    log(f"    {n_checked} decodes of {len(rec['pillow'])} corrupt JPEGs (both modes, Python and "
        f"C++) equal to Pillow's and the JAX extension's; decode ms a photo "
        f"{json.dumps(out['ms_per_photo'])}")
    # (2) the native Loader over them
    lr = rec["loader"]
    loader = nat.Loader([os.path.join(CORRUPT_FIXTURES, n) for n in lr["files"]], lr["size"],
                        lr["batch"], threads=2, host_cpp=True)
    with loader:
        loader.start_epoch(seed=0, shuffle=True)
        got = []
        while True:
            try:
                u8, idx = loader.next_batch()
            except StopIteration:
                break
            got.append({"idx": idx, "sha256": _sha256(u8)})
    assert got == lr["batches"], ("the Loader's batches are not the extension's", got)
    log(f"    the native Loader: {len(got)} batches of the corrupt JPEGs equal to the "
        "extension's")
    # (3) the new formats
    with open(os.path.join(FORMATS_FIXTURES, "decodes.json")) as f:
        meta = json.load(f)
    fnpz = np.load(os.path.join(FORMATS_FIXTURES, "decodes.npz"))
    names = sorted(f for f in os.listdir(FORMATS_FIXTURES)
                   if not f.startswith(("decodes", "make_")))
    assert len(names) == len([k for k in meta if k != "pillow"]), names
    out["formats_decode_ms"] = {}
    for name in names:
        key, path = os.path.splitext(name)[0], os.path.join(FORMATS_FIXTURES, name)
        got = imgmod.read_image_rgb(path)
        if list(got.shape) != meta[key]["shape"] or _sha256(got) != meta[key]["sha256"] or \
                not np.array_equal(got, fnpz[key]):
            raise AssertionError(f"{name} does not decode to its Pillow decode")
        out["formats_decode_ms"][key] = _median_ms(lambda path=path: imgmod.read_image_rgb(path))
    log(f"    {len(names)} Netpbm, QOI, TGA, PCX, SGI, ICO, CUR, DIB and TIFF fixtures equal to "
        f"their Pillow decodes; ms a photo {json.dumps(out['formats_decode_ms'])}")
    # (4) the regressor CLI
    out["regressor"] = _regressor_cli(dev, root, rec["regressor"], os.path.dirname(
        CORRUPT_FIXTURES))
    log(f"    regressor CLI: {out['regressor']['train_batches']} training batches of corrupt "
        f"JPEGs (native) and {out['regressor']['test_batches']} test batches of the new "
        f"formats (Pillow) equal to the JAX trainer's; {out['regressor']['test_line']}")
    torch.cuda.empty_cache()
    # (5) photo-sized files
    out["photo_ms"] = _photo_decodes(root)
    log(f"    ms a photo, read_image_rgb (Python; JPEG also C++) at 256 px (median of "
        f"{PHOTO_SIZES[0][1]}) and 1024 px (one decode): {json.dumps(out['photo_ms'])}")
    return out


def _photo_decodes(root):
    """Phase 55 (5): read_image_rgb over size x size files of the forms its
    Python readers take longest over (tests/image_format_encoders.py:
    photo_forms, written from seed 0 into ``root``: LZW and deflate TIFF,
    16-bit and CMYK, group 4 and group 3, Netpbm P6 at maxval 1000 and
    plain P2, run-length TGA), each equal to its source where the form keeps
    it; and tests/fixtures/torch_jpeg's photos with three bytes of their
    scans overwritten (tests/jpeg_corrupt_corpus.py:overwritten, seed =
    size) in both JPEG modes, the C++ equal to the Python decode -> {size:
    {form: ms}} (host clock, files warm; a form's median of reps takes its
    checked decode as the first timing; Pillow's decodes of these files
    are held to in tests/test_torch_image_formats.py and
    tests/test_torch_jpeg_corrupt.py)."""
    import numpy as np

    from latent2im_tpu_torch.utils import image as imgmod
    from latent2im_tpu_torch.utils import jpeg

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from image_format_encoders import photo_forms
    from jpeg_corrupt_corpus import overwritten

    out = {}
    for size, reps in PHOTO_SIZES:
        ms = out[f"{size}x{size}"] = {}
        for name, (data, want) in photo_forms(size, 0).items():
            path = os.path.join(root, f"{name}_{size}")
            with open(path, "wb") as f:
                f.write(data)
            t0 = time.perf_counter()
            got = imgmod.read_image_rgb(path)
            first = (time.perf_counter() - t0) * 1e3  # the checked decode is the first timing
            assert got.shape == (size, size, 3), (name, got.shape)
            assert want is None or np.array_equal(got, want), f"{name} at {size} px"
            ms[name] = statistics.median(
                [first] + [_median_ms(lambda path=path: imgmod.read_image_rgb(path), 1)
                           for _ in range(reps - 1)])
        with open(os.path.join(REPO, "tests", "fixtures", "torch_jpeg", PHOTO_JPEGS[size]),
                  "rb") as f:
            data = overwritten(f.read(), size)
        for mode in ("pillow", "libjpeg"):
            lj = mode == "libjpeg"
            py = jpeg.jpeg_decode_rgb(data, libjpeg=lj)
            c = jpeg.jpeg_decode_rgb(data, host_cpp=True, libjpeg=lj)
            assert py.shape == (size, size, 3) and np.array_equal(py, c), \
                f"the corrupt {size} px JPEG ({mode} mode): C++ and Python differ"
            for route in ("c", "python"):
                ms[f"jpeg_overwritten_{mode}_{route}"] = _median_ms(
                    lambda c=route == "c", lj=lj: jpeg.jpeg_decode_rgb(data, host_cpp=c,
                                                                       libjpeg=lj), reps)
    return out


TEXTURES_FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_image_textures")


def textures_phase(dev):
    """Phase 56 in a temporary directory."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        return _textures_phase(dev, root)


def _textures_phase(dev, root):
    """Phase 56: (1) every file of tests/fixtures/torch_image_textures
    through read_image_rgb, Python and host C++ (the JPEG 2000 tier-1;
    the other readers are the same on both routes; the 1024 px photo C++
    only), each equal to its recorded Pillow decode (decodes.npz, or its
    SHA-256 in decodes.json), the JPEG 2000 photos' decodes timed (one
    each); (2) ms a photo of read_image_rgb over a 256 px BC7 DDS and a
    256 px PSD (PackBits RGB) written from seed 56 by
    tests/image_format_encoders.py (median of 3). Host clock, files warm."""
    import numpy as np

    from latent2im_tpu_torch.utils import image as imgmod

    del dev  # host decode: nothing runs on the card
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from image_format_encoders import dds_file, psd_file

    with open(os.path.join(TEXTURES_FIXTURES, "decodes.json")) as f:
        meta = json.load(f)
    npz = np.load(os.path.join(TEXTURES_FIXTURES, "decodes.npz"))
    names = sorted(f for f in os.listdir(TEXTURES_FIXTURES)
                   if os.path.splitext(f)[0] in meta)
    assert len(names) == len([k for k in meta if k not in ("pillow", "openjpeg")]), names
    out, n_checked = {"ms_per_photo": {}}, 0
    for name in names:
        key, path = os.path.splitext(name)[0], os.path.join(TEXTURES_FIXTURES, name)
        for route in ((True,) if key.startswith("photo_1024") else (False, True)):
            t0 = time.perf_counter()
            got = imgmod.read_image_rgb(path, host_cpp=route)
            if key.startswith("photo_"):
                out["ms_per_photo"][f"{name}_{'c' if route else 'python'}"] = (
                    time.perf_counter() - t0) * 1e3
            if list(got.shape) != meta[key]["shape"] or _sha256(got) != meta[key]["sha256"] or (
                    key in npz and not np.array_equal(got, npz[key])):
                raise AssertionError(f"{name} (host_cpp={route}) is not Pillow's decode")
            n_checked += 1
    log(f"    {n_checked} decodes of {len(names)} DDS, BLP, FTEX, PSD, JPEG 2000 and ICNS "
        f"fixtures (Python and C++ tier-1) equal to Pillow's (Pillow {meta['pillow']}, "
        f"OpenJPEG {meta['openjpeg']})")
    rng = np.random.RandomState(56)
    blocks = rng.randint(0, 256, (64 * 64, 16)).astype(np.uint8)
    planes = rng.randint(0, 256, (3, 256, 256)).astype(np.uint8)
    planes[:, 64:192, 32:224] = planes[:, 64:65, 32:33]
    for name, data in (("dds_bc7_256", dds_file(256, 256, blocks.tobytes(), b"DX10", 98)),
                       ("psd_packbits_256", psd_file(planes, 3, 8, 1))):
        path = os.path.join(root, name)
        with open(path, "wb") as f:
            f.write(data)
        got = imgmod.read_image_rgb(path)
        assert got.shape == (256, 256, 3), (name, got.shape)
        if name.startswith("psd"):
            assert np.array_equal(got, planes.transpose(1, 2, 0)), name
        out["ms_per_photo"][name] = _median_ms(lambda path=path: imgmod.read_image_rgb(path), 3)
    log(f"    ms a photo, read_image_rgb: {json.dumps(out['ms_per_photo'])}")
    return out


LEGACY_FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_image_legacy")


def legacy_phase(dev):
    """Phase 57 in a temporary directory."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        return _legacy_phase(dev, root)


def _legacy_forms(rng):
    """The three timed files, written without Pillow from ``rng``
    (tests/image_format_encoders.py) -> {name: (bytes, the decode they must
    give)}: a 256 px 24-bit Sun raster run-length coded (flat bands so
    that runs occur), a 256 px FLC whose first frame is a palette, a BRUN
    and an LC chunk, a 256 px FITS image of BITPIX -32 (whose big-endian
    float32s Pillow's raw mode F reads little-endian)."""
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from image_format_encoders import (fits_file, fli_brun, fli_color, fli_file, fli_lc,
                                       sun_file, sun_rle, sun_rows)

    from latent2im_tpu_torch.utils.modes import f_rgb

    img = rng.randint(0, 256, (256, 256, 3)).astype(np.uint8)
    img[32:224, 16:240] = img[32:33, 16:17]
    sun = sun_file(256, 256, 24, sun_rle(sun_rows(img[..., ::-1], 24, pad=False)), 2)
    pal = rng.randint(0, 256, (256, 3)).astype(np.uint8)
    a = rng.randint(0, 256, (256, 256)).astype(np.uint8)
    a[64:192] = np.arange(256) // 16
    b = a.copy()
    b[100:140, 30:90] = 7
    flc = fli_file(256, 256, [[fli_color(pal), fli_brun(a), fli_lc(a, b)], [fli_lc(b, a)]])
    f = (rng.randn(256, 256) * 100).astype(">f4")
    fits = fits_file([("SIMPLE", "T"), ("BITPIX", -32), ("NAXIS", 2), ("NAXIS1", 256),
                      ("NAXIS2", 256)], f.tobytes())
    return {"sun_rle_24_256": (sun, img), "flc_brun_lc_256": (flc, pal[b]),
            "fits_f32_256": (fits, f_rgb(np.frombuffer(f.tobytes(), "<f4").reshape(256, 256)
                                         [::-1]))}


def _legacy_phase(dev, root):
    """Phase 57: (1) every file of tests/fixtures/torch_image_legacy through
    read_image_rgb, each equal to its recorded Pillow decode (decodes.npz,
    or its SHA-256 in decodes.json); (2) ms a photo of read_image_rgb over
    ``_legacy_forms``' three files, written from seed 57, each equal to the
    decode it must give (median of 3). Host clock, files warm."""
    import numpy as np

    from latent2im_tpu_torch.utils import image as imgmod

    del dev  # host decode: nothing runs on the card
    with open(os.path.join(LEGACY_FIXTURES, "decodes.json")) as f:
        meta = json.load(f)
    npz = np.load(os.path.join(LEGACY_FIXTURES, "decodes.npz"))
    names = sorted(f for f in os.listdir(LEGACY_FIXTURES) if os.path.splitext(f)[0] in meta)
    assert len(names) == len(meta) - 1, names  # every recorded decode has its file
    formats = set()
    for name in names:
        key = os.path.splitext(name)[0]
        got = imgmod.read_image_rgb(os.path.join(LEGACY_FIXTURES, name))
        if list(got.shape) != meta[key]["shape"] or _sha256(got) != meta[key]["sha256"] or (
                key in npz and not np.array_equal(got, npz[key])):
            raise AssertionError(f"{name} is not Pillow's decode")
        formats.add(key.split("_")[0])
    assert len(formats) == 16, formats
    log(f"    {len(names)} decodes of the 16 legacy formats' fixtures equal to Pillow's "
        f"(Pillow {meta['pillow']})")
    out = {"fixtures": len(names), "ms_per_photo": {}}
    for name, (data, want) in _legacy_forms(np.random.RandomState(57)).items():
        path = os.path.join(root, name)
        with open(path, "wb") as f:
            f.write(data)
        got = imgmod.read_image_rgb(path)
        assert got.shape == want.shape and np.array_equal(got, want), name
        out["ms_per_photo"][name] = _median_ms(lambda path=path: imgmod.read_image_rgb(path), 3)
    log(f"    ms a photo, read_image_rgb (Python): {json.dumps(out['ms_per_photo'])}")
    return out


TIFF_CODECS_FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_image_tiff_codecs")


def tiff_codecs_phase(dev):
    """Phase 58 in a temporary directory."""
    import tempfile

    with tempfile.TemporaryDirectory() as root:
        return _tiff_codecs_phase(dev, root)


def _tiff_codec_forms(rng):
    """The two timed files written here without Pillow (stdlib lzma and
    tests/image_format_encoders.py) -> {name: (bytes, the decode they must
    give)}: a 256 px RGB LZMA TIFF with the horizontal predictor, strips of
    32 rows, and a 256 px 4-bit gray ThunderScan TIFF."""
    import lzma

    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from image_format_encoders import thunderscan, tiff

    yy, xx = np.mgrid[:256, :256]
    photo = np.stack([128 + 90 * np.sin(xx / 23.0 + c) * np.cos(yy / 29.0) for c in range(3)], -1)
    photo = np.clip(photo + rng.randn(256, 256, 3) * 5, 0, 255).astype(np.uint8)
    xz = tiff(photo, 8, 2, "<", 34925, rps=32, predictor=2,
              encode_chunk=lambda b: lzma.compress(b, format=lzma.FORMAT_XZ))
    v = np.clip(np.cumsum(rng.randint(-1, 2, (256, 256)), 1) // 4 + 8, 0, 15)
    v[:, 100:140] = v[:, 100:101]

    def thunder(b):
        rows = np.unpackbits(np.frombuffer(b, np.uint8)).reshape(-1, 1024)
        return thunderscan((rows.reshape(-1, 256, 4) * np.array([8, 4, 2, 1])).sum(-1))

    ts = tiff(v[..., None], 4, 1, "<", 32809, rps=64, encode_chunk=thunder)
    gray = (v * 17).astype(np.uint8)
    return {"lzma_rgb_256": (xz, photo),
            "thunderscan_gray_256": (ts, np.repeat(gray[..., None], 3, -1))}


def _tiff_codecs_phase(dev, root):
    """Phase 58: (1) whether stdlib ``lzma`` imports here and which liblzma
    the LZMA codec loads for libtiff's loop (a failure fails the LZMA
    decodes below, not the phase's start); (2) every file of
    tests/fixtures/torch_image_tiff_codecs through read_image_rgb, each
    equal to its recorded Pillow decode (decodes.npz, or its SHA-256 in
    decodes.json); (3) ms a photo of read_image_rgb over
    the 256 px ZSTD fixture and ``_tiff_codec_forms``' LZMA and ThunderScan
    files written from seed 58, each equal to the decode it must give
    (median of 3). Host clock, files warm."""
    import numpy as np

    from latent2im_tpu_torch.utils import image as imgmod

    del dev  # host decode: nothing runs on the card
    try:
        import lzma

        status = f"ok ({lzma.__file__}; xz round trip " + (
            "ok" if lzma.decompress(lzma.compress(b"58" * 64)) == b"58" * 64 else "wrong") + ")"
    except ImportError as e:
        status = f"failed ({e})"
    try:
        from latent2im_tpu_torch.utils import tiff as tiffmod

        status += f"; liblzma {tiffmod._liblzma()._name}"
    except (ImportError, RuntimeError) as e:
        status += f"; liblzma failed ({e})"
    log(f"    import lzma: {status}")
    with open(os.path.join(TIFF_CODECS_FIXTURES, "decodes.json")) as f:
        meta = json.load(f)
    npz = np.load(os.path.join(TIFF_CODECS_FIXTURES, "decodes.npz"))
    names = sorted(f for f in os.listdir(TIFF_CODECS_FIXTURES)
                   if os.path.splitext(f)[0] in meta)
    assert len(names) == len(meta) - 2, names  # every recorded decode has its file
    out = {"import_lzma": status, "fixtures": len(names), "ms_per_photo": {}}
    for name in names:
        key, path = os.path.splitext(name)[0], os.path.join(TIFF_CODECS_FIXTURES, name)
        t0 = time.perf_counter()
        got = imgmod.read_image_rgb(path)
        if key.startswith("zstd_photo"):
            out["ms_per_photo"][key] = (time.perf_counter() - t0) * 1e3
        if list(got.shape) != meta[key]["shape"] or _sha256(got) != meta[key]["sha256"] or (
                key in npz and not np.array_equal(got, npz[key])):
            raise AssertionError(f"{name} is not Pillow's decode")
    log(f"    {len(names)} decodes of the CCITT, RLEW, ThunderScan, LZMA, ZSTD and OJPEG "
        f"fixtures equal to Pillow's (Pillow {meta['pillow']}, libtiff {meta['libtiff']})")
    for name, (data, want) in _tiff_codec_forms(np.random.RandomState(58)).items():
        path = os.path.join(root, name + ".tif")
        with open(path, "wb") as f:
            f.write(data)
        got = imgmod.read_image_rgb(path)
        assert got.shape == want.shape and np.array_equal(got, want), name
        out["ms_per_photo"][name] = _median_ms(lambda path=path: imgmod.read_image_rgb(path), 3)
    photo = os.path.join(TIFF_CODECS_FIXTURES, "zstd_photo_256.tif")
    out["ms_per_photo"]["zstd_photo_256"] = _median_ms(
        lambda: imgmod.read_image_rgb(photo), 3)
    log(f"    ms a photo, read_image_rgb (Python): {json.dumps(out['ms_per_photo'])}")
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
    faulthandler.dump_traceback_later(WATCHDOG_S - (time.perf_counter() - T0))
    refs = CpuReferences()  # the CPU references, computed meanwhile
    try:
        return _run(refs)
    finally:
        refs.close()
        faulthandler.cancel_dump_traceback_later()


def _run(refs) -> int:
    """Every phase, on the card, with ``refs`` computing the CPU halves of
    phases 9, 16 and 20 alongside; 0 when all passed."""
    import torch

    from latent2im_tpu_torch.device import resolve_device
    from latent2im_tpu_torch.ops import _build

    t_start = time.perf_counter()
    card = card_line()
    phase(1, f"card: {card}")
    log(f"    torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    dev = resolve_device("cuda")  # TF32 off for cuDNN and cuBLAS

    phase(2, "building the kernels (one nvcc for each source, all started together)")
    path, secs = _build.build()
    _build.library()
    log(f"[2] kernels built in {secs:.1f} s: {os.path.relpath(path, REPO)}")
    refs.start_second()

    phase(3, f"kernels against their plain versions at the {SIZE} px B={BATCH} "
          "shapes of apply_alpha and of a training step")
    results, max_err, details = kernel_phase(dev)

    phase(4, f"main path 1: the {SIZE} px edit server over HTTP")
    service, conf, serve_counts, serve = serve_phase(results, dev)
    log(f"    p50 request latency {serve['p50_request_ms']:.1f} ms, "
        f"{serve['img_per_s']:.2f} img/s ({serve['requests']} /edit requests "
        f"of {BATCH}), apply_alpha B={BATCH} device time "
        f"{serve['apply_alpha_b4_device_ms']:.2f} ms, on {card}")
    log(f"    apply_alpha B={BATCH} under cuDNN's default and deterministic algorithms: "
        f"{json.dumps(serve['deterministic_cudnn'])}")

    phase(5, "one apply_alpha (B=4) under torch.profiler")
    prof = profile_phase(service)
    log(f"    {json.dumps(prof)}")

    phase(6, "card against CPU (B=1, same weights)")
    cmp_ = cpu_phase(service, conf)
    log(f"    {cmp_}")
    del service
    torch.cuda.empty_cache()

    phase(7, f"main path 2: {SIZE} px walk training, train_loop B={BATCH}")
    ed, walk, task, train_counts, train = train_phase(results, dev)
    log(f"    {train['step_ms_cuda_events']:.2f} ms per step (CUDA events over "
        f"{TRAIN_STEPS} steps), {train['samples_per_s']:.2f} samples/s, peak "
        f"{train['peak_mem_gb']:.2f} GB, loss {train['first']['loss']:.4f} -> "
        f"{train['last']['loss']:.4f}, on {card}")

    phase(8, f"one training step (B={BATCH}) under torch.profiler")
    train_prof = train_profile_phase(ed, walk, task)
    log(f"    {json.dumps(train_prof)}")
    del ed, walk
    torch.cuda.empty_cache()

    phase(9, f"training step, card against CPU ({F64_SIZE} px, B={CMP_BATCH}, same weights)")
    train_cmp = train_cpu_phase(cpu=refs.get("train"))
    log(f"    {train_cmp}")
    torch.cuda.empty_cache()

    phase(10, f"the CLIs at {SIZE} px: train + SIGTERM + --resume, train_multi_attr, "
          "vis_w (python -m), serve --save_path_w")
    t = time.perf_counter()
    cli = cli_phase()
    cli["seconds"]["phase"] = time.perf_counter() - t
    log(f"    wall seconds {json.dumps(cli['seconds'])} on {card}")
    log(f"    launches {json.dumps(cli['launches'])}; preempted at "
        f"{cli['preempted_at']} {cli['preempt_meta']}, {cli['resumed_steps']} steps "
        f"after --resume, Adam step {cli['adam_step']:.0f}; vis_w wrote {cli['vis_pngs']}; "
        f"uint8 values where /edit differs from apply_alpha "
        f"{json.dumps(cli['edit_vs_apply_alpha'])}")
    torch.cuda.empty_cache()

    hi = hi_phases(card, dev, grad_limit=train_cmp["walk_grad_limit"])
    torch.cuda.empty_cache()

    late = late_phases(card, dev, results, cli, refs)
    gan = gan_phases(card, dev, refs)
    zp = z_phases(card, dev, results, refs)
    geo = geo_phases(card, dev, refs)
    bf = bf16_phases(card, dev, results, hi)
    phase(38, "JPEG input: the fixtures against their Pillow decodes, bp and --updateGAN "
          "on JPEGs")
    jp = jpeg_phase(dev)
    rg = regressor_phases(card, dev, gan, jp)
    par = parallel_phases(card, dev, tp_too=True)
    tp = tp_phases(card, dev, ranks=par.pop("tp_ranks"))
    hp = host_target_phase(card, refs.get("geo_host"))
    phase(52, "progressive, CMYK and YCCK JPEG: the fixtures in Python and C++ against their "
          "Pillow decodes, the regressor loader on them, bp on a progressive photo")
    jprog = jpeg_progressive_phase(dev)
    phase(53, "WEBP, arithmetic JPEG, 16-bit and Adam7 PNG: the fixtures against their "
          "Pillow decodes, bp on a WEBP, an animated WEBP and a 16-bit PNG")
    kinds = image_kinds_phase(dev)
    phase(54, "the native path: its fixtures in Python and C++ against the JAX extension's "
          "recordings, --updateGAN on its stream, the regressor CLI on GIF, BMP and TIFF")
    nat = native_phase(dev)
    phase(55, "corrupt JPEGs (libjpeg's recovery) in both modes, Python and C++, against "
          "Pillow's and the JAX extension's recordings; the native Loader over them; Netpbm, "
          "QOI, TGA, PCX, SGI, ICO/CUR, DIB and TIFF fixtures; the regressor CLI on them; "
          "decode ms at 256 and 1024 px")
    cf = corrupt_formats_phase(dev)
    phase(56, "DDS (BC1-BC7), BLP, FTEX, PSD, JPEG 2000 and ICNS: the fixtures in Python and "
          "C++ against their Pillow decodes; decode ms of JPEG 2000 photos, a BC7 DDS and a PSD")
    tx = textures_phase(dev)
    phase(57, "DCX, XBM, XPM, MSP, Sun raster, FLI/FLC, FITS, SPIDER, IM, McIdas, GBR, PhotoCD, "
          "PIXAR, XV thumbnail, IMT and IPTC: the fixtures against their Pillow decodes; decode "
          "ms of a run-length Sun raster, an FLC and a FITS float image")
    lg = legacy_phase(dev)
    phase(58, "CCITT with the uncompressed-mode bit and RLEW, ThunderScan, LZMA, ZSTD and "
          "old-style JPEG in TIFF: the fixtures against their Pillow decodes; decode ms of a "
          "256 px ZSTD, LZMA and ThunderScan photo")
    tc = tiff_codecs_phase(dev)
    kernels = []
    for n, paths in results.items():
        r, rh = paths["train_step"], hi["results"][n]["train_step"]
        by_path = {"serve": serve_counts[n], "train": train_counts[n],
                   **{k: v[n] for k, v in hi["launches"].items()},
                   **{k: v[n] for k, v in late["launches"].items()},
                   **{k: v[n] for k, v in gan["launches"].items()},
                   **{k: v[n] for k, v in zp["launches"].items()},
                   **{k: v[n] for k, v in geo["launches"].items()},
                   **{k: v[n] for k, v in jp["launches"].items()},
                   **{k: v[n] for k, v in rg["launches"].items()},
                   **{k: v[n] for k, v in par["launches"].items()},
                   **{k: v[n] for k, v in tp["launches"].items()},
                   **{k: v[n] for k, v in hp["launches"].items()},
                   **{k: v[n] for k, v in jprog["launches"].items()},
                   **{k: v[n] for k, v in kinds["launches"].items()},
                   **{k: v[n] for k, v in nat["launches"].items()},
                   **{k: v[n] for k, v in cf["launches"].items()}}
        kernels.append({
            "name": n, "route": "cuda", "source": SOURCE[n][0], "replaces": SOURCE[n][1],
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(max_err[n], hi["max_err"][n]), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "per": f"training step, {SIZE} px, B={BATCH}",
            "device_ms": r["device_ms"],
            "bound_share_device": r["bound_ms"] / r["device_ms"],
            "per_apply_alpha": paths["apply_alpha"] if n in FORWARD else None,
            f"per_train_step_{SIZE_HI}": {
                "per": f"training step, {SIZE_HI} px, B={BATCH_HI}", **rh,
                "bound_share_device": rh["bound_ms"] / rh["device_ms"]},
            f"per_apply_alpha_{SIZE_HI}": (hi["results"][n]["apply_alpha"]
                                           if n in FORWARD else None)})
    for n, paths in bf["results"].items():  # the bf16 instances (phase 33)
        r, rh = paths["train_step"], bf["results_hi"][n]["train_step"]
        by_path = {**{k: v[n] for k, v in bf["launches"].items()},
                   **{k: v[n] for k, v in tp["launches_bf16"].items()}}
        assert sum(by_path.values()) > 0, (n, by_path)
        kernels.append({
            "name": f"{n}[bf16]", "route": "cuda", "source": SOURCE[n][0],
            "replaces": SOURCE[n][1], "launches": sum(by_path.values()),
            "launches_by_path": by_path, "max_abs_err": bf["max_err"][n], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "per": f"training step, {SIZE} px, B={BATCH}, bf16",
            "device_ms": r["device_ms"],
            "bound_share_device": r["bound_ms"] / r["device_ms"],
            "per_apply_alpha": paths["apply_alpha"] if n in FORWARD else None,
            f"per_train_step_{SIZE_HI}": {
                "per": f"training step, {SIZE_HI} px, B={BATCH_HI}, bf16", **rh,
                "bound_share_device": rh["bound_ms"] / rh["device_ms"]},
            f"per_apply_alpha_{SIZE_HI}": (bf["results_hi"][n]["apply_alpha"]
                                           if n in FORWARD else None)})
    for n in SPLIT:  # the styled conv's tensor-parallel split (phases 47-48)
        for dt in ("f32", "bf16"):
            per = {size: tp["kernels"][f"{size}_{dt}_{n}"] for size in (SIZE, SIZE_HI)}
            launches = (tp["launches"] if dt == "f32" else tp["launches_bf16"])["tp"][n]
            # one tp step launches the split once per partner conv and
            # synthesis, on each rank: phase 48's count of syntheses per step
            # times one synthesis's sums
            step = {size: {k: tp["syntheses_per_step"] * per[size][k]
                           for k in ("ms", "device_ms", "plain_ms", "library_ms", "bound_ms")}
                    for size in per}
            kernels.append({
                "name": n if dt == "f32" else f"{n}[bf16]", "route": "cuda",
                "source": SPLIT_SOURCE[0], "replaces": SPLIT_SOURCE[1],
                "launches": launches, "launches_by_path": {"tp": launches},
                "max_abs_err": max(p["max_abs_err"] for p in per.values()),
                **step[SIZE], "bound_by": per[SIZE]["bound_by"],
                "per": f"tp training step on one of {TP_RANKS} ranks, {SIZE} px, B={BATCH}, {dt}",
                f"per_train_step_{SIZE_HI}": {
                    "per": f"tp training step on one of {TP_RANKS} ranks, {SIZE_HI} px, B=2, {dt}",
                    **step[SIZE_HI], "bound_by": per[SIZE_HI]["bound_by"]}})
    report = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
              "kernels": kernels, "shapes": details + hi["details"] + bf["details"],
              "serve": serve,
              "profile": prof, "cpu_vs_card": cmp_, "train": train,
              "train_profile": train_prof, "train_cpu_vs_card": train_cmp, "cli": cli,
              "hi": {k: v for k, v in hi.items() if k not in ("results", "details")},
              "late": {k: v for k, v in late.items() if k != "launches"},
              "gan": {k: v for k, v in gan.items() if k != "launches"},
              "z": {k: v for k, v in zp.items() if k != "launches"},
              "geometric": {k: v for k, v in geo.items() if k != "launches"},
              "bf16": {k: v for k, v in bf.items()
                       if k not in ("launches", "results", "results_hi", "details")},
              "jpeg": {k: v for k, v in jp.items() if k != "launches"},
              "regressor": {k: v for k, v in rg.items() if k != "launches"},
              "parallel": par,
              "tp": {k: v for k, v in tp.items() if k not in ("launches", "launches_bf16")},
              "host_targets": {k: v for k, v in hp.items() if k != "launches"},
              "jpeg_progressive": {k: v for k, v in jprog.items() if k != "launches"},
              "image_kinds": {k: v for k, v in kinds.items() if k != "launches"},
              "native": {k: v for k, v in nat.items() if k != "launches"},
              "corrupt_formats": {k: v for k, v in cf.items() if k != "launches"},
              "textures": tx,
              "legacy": lg,
              "tiff_codecs": tc,
              "cpu_reference_waits_s": refs.waited,
              "seconds": time.perf_counter() - t_start}
    report["seconds_by_phase"] = dict(phase_seconds(time.perf_counter() - T0))
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log("seconds by phase, one line each:")
    for n, secs in report["seconds_by_phase"].items():
        print(f"    phase {n}: {secs:.1f} s", flush=True)
    log(f"done in {report['seconds']:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
