"""Attribute-regressor trainer (the reference's scene_regressor_256.py) —
PyTorch port of latent2im_tpu/cli/train_regressor.py, with its flags, print
lines and files.

Trains ResNet-50 (fc -> 40 outputs) on Transient-Attributes-style scene
images: folder/*/* images, a tab-separated label file ('dir/file\\tv,conf
...'), train/test split lists, MSE loss, Adam 1e-4, 500 epochs, the test MSE
after each epoch from epoch 1. Each epoch writes
``{epoch+1:03d}_dict.model.msgpack`` ({"model": the JAX package's resnet
tree, "opt_state": optax.adam's state}, meta {"epoch": epoch}), byte for byte
what the JAX trainer writes for the same values, and with --export_torch
``{epoch+1:03d}_dict.model`` ({"model": torchvision state_dict, "optm": {}}).
Images normalise to [-1, 1] like transforms.Normalize((.5,.5,.5),
(.5,.5,.5)).

The training split's batches are the JAX trainer's: its native
extension's Loader first, here the port's ``native`` counterpart (each
epoch ``start_epoch(seed=epoch)``: libstdc++'s shuffle of the order the
last epoch left; libjpeg and libpng decodes, a resize without antialias;
the labels taken by the loader's indices), and, where that module cannot
be imported, the pure-Python ones (``_pil_batches``: each epoch
``RandomState(epoch).permutation``, centre square crop, Pillow's BILINEAR
resize, ``utils/image.py:pillow_load_and_resize``). The test split always
takes the Pillow path, as the JAX trainer's does. Both decode ahead on
threads (utils/loader.py) and, on the card, through the host C++ of
ops/csrc/. BatchNorm trains in torch's train mode, which is the JAX
package's ``batch_norm(train=True)`` + ``apply_bn_stats``
(models/resnet.py). The weights start from the port's seeded init, of the
JAX package's distributions (its PRNGKey(0) stream needs JAX). Runs on the
card (``device`` cuda unless the caller asks for the CPU).

    python -m latent2im_tpu_torch.cli.train_regressor \\
        --data_dir <imageAlignedLD> --label_path <annotations.tsv> \\
        --split_dir <random_split> [--image_size 256 --batch_size 32]
"""

from __future__ import annotations

import argparse
import csv
import glob
import os

import numpy as np
import torch

from ..device import resolve_device
from ..io import checkpoint as ckpt
from ..io.convert import resnet50_from_jax, resnet50_to_jax
from ..io.torch_convert import export_resnet50_torch
from ..models.resnet import ResNet50
from ..utils import image as imgmod
from ..utils.loader import Loader


def load_labelfile(path: str) -> dict[str, np.ndarray]:
    """'dir/file\\tv1,c1\\tv2,c2...' -> {key: [v1, v2, ...]}
    (scene_regressor_256.py:70-76)."""
    labels = {}
    with open(path) as csvfile:
        for line in csv.reader(csvfile, delimiter="\t"):
            if not line:
                continue
            labels[line[0]] = np.array(
                [float(i.split(",")[0]) for i in line[1:]], np.float32
            )
    return labels


def list_split(folder_path: str, split_file: str) -> list[tuple[str, str]]:
    """-> [(abs_path, 'dir/file' key)] filtered by the split list."""
    with open(split_file) as f:
        split = {line.strip() for line in f if line.strip()}
    out = []
    for p in glob.glob(os.path.join(folder_path, "*", "*")):
        key = "/".join(p.split("/")[-2:])
        if key in split:
            out.append((p, key))
    return sorted(out)


def make_loader(paths: list[str], size: int, host_cpp: bool) -> Loader:
    """The threaded loader of ``paths`` on the Pillow path: load i -> uint8
    [size, size, 3] (``utils/image.py:pillow_load_and_resize``)."""
    return Loader(lambda i: imgmod.pillow_load_and_resize(paths[i], size, host_cpp))


def make_native_loader(paths: list[str], size: int, batch: int):
    """The JAX trainer's ``_make_loader``: (the native Loader, True), or
    (None, False) where the native module cannot be imported."""
    try:
        from ..native import _l2i_native as nat
    except ImportError:
        return None, False
    return nat.Loader(paths, size, batch, threads=2), True


def native_batches(loader):
    """One epoch of a started native Loader: (uint8 batch, indices)."""
    while True:
        try:
            yield loader.next_batch()
        except StopIteration:
            return


def index_batches(order, batch: int):
    """The JAX trainer's batches of an epoch's order (``_pil_batches``)."""
    return (order[s:s + batch] for s in range(0, len(order), batch))


def normalize(u8_batch: np.ndarray, device) -> torch.Tensor:
    """uint8 NHWC -> f32 in [-1, 1] on ``device`` (sent as uint8)."""
    return torch.as_tensor(u8_batch).to(device).float() / 255.0 * 2.0 - 1.0


def make_steps(model: ResNet50, lr: float):
    """-> (Adam, train_step(imgs, labels) -> loss, eval_step(imgs, labels) ->
    loss): the JAX trainer's make_steps. Adam's defaults are optax.adam's
    (b1 0.9, b2 0.999, eps 1e-8) and its update the same formula. The train
    step runs BN in train mode, which also moves its running statistics;
    the eval step in eval mode."""
    opt = torch.optim.Adam(model.parameters(), lr=lr)

    def train_step(imgs, labels):
        model.train()
        opt.zero_grad(set_to_none=True)
        loss = torch.mean((model(imgs) - labels) ** 2)
        loss.backward()
        opt.step()
        return loss.detach()

    @torch.no_grad()
    def eval_step(imgs, labels):
        model.eval()
        return torch.mean((model(imgs) - labels) ** 2)

    return opt, train_step, eval_step


def _param_names(model) -> list[str]:
    return [n for n, _ in model.named_parameters()]


def _moments_tree(model):
    """A list of tensors in Adam's order -> the JAX package's resnet tree.
    optax holds a moment for every leaf, the BN statistics too (zero: they
    get no gradient); torch's Adam holds none for buffers: zeros fill them."""
    names = _param_names(model)
    stats = {n: torch.zeros_like(b) for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))}

    def to_tree(tensors):
        return resnet50_to_jax({**stats, **dict(zip(names, tensors))})

    return to_tree


def regressor_tree(model, opt) -> dict:
    """{"model": params, "opt_state": optax.adam state}, the tree the JAX
    trainer checkpoints, from the port's model and Adam."""
    return {"model": resnet50_to_jax(model.state_dict()),
            "opt_state": ckpt.adam_state_to_optax(opt.state_dict(), list(model.parameters()),
                                                  _moments_tree(model))}


def load_regressor(path: str, model, opt=None) -> dict | None:
    """Restore a checkpoint of either package's trainer into ``model`` (and
    ``opt``'s moments) in place -> its meta."""
    like = ({"model": resnet50_to_jax(model.state_dict())} if opt is None
            else regressor_tree(model, opt))
    tree = ckpt.load_pytree(path)
    tree = ckpt._restore_like({k: tree.get(k) for k in like}, like, path)
    model.load_state_dict(resnet50_from_jax(tree["model"]), strict=True)
    if opt is not None:
        names = _param_names(model)

        def from_tree(moments):
            m = resnet50_from_jax(moments)
            return [m[n] for n in names]

        opt.load_state_dict(ckpt.adam_state_from_optax(tree["opt_state"], opt.state_dict(),
                                                       from_tree))
    return ckpt.load_meta(path)


def main(argv=None, device=None):
    ap = argparse.ArgumentParser("scene regressor trainer")
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--label_path", required=True)
    ap.add_argument("--split_dir", required=True)
    ap.add_argument("--ckpt_dir", default="./checkpoint_256")
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--batch_size", type=int, default=32)
    ap.add_argument("--n_epochs", type=int, default=500)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--num_outputs", type=int, default=40)
    ap.add_argument("--export_torch", action="store_true",
                    help="also save torch-layout {'model','optm'} checkpoints")
    args = ap.parse_args(argv)
    device = resolve_device(device)

    os.makedirs(args.ckpt_dir, exist_ok=True)
    labels = load_labelfile(args.label_path)
    train_items = list_split(args.data_dir,
                             os.path.join(args.split_dir, "training.txt"))
    test_items = list_split(args.data_dir, os.path.join(args.split_dir, "test.txt"))
    print(f"train {len(train_items)} / test {len(test_items)} images")

    train_paths = [p for p, _ in train_items]
    train_labels = np.stack([labels[k] for _, k in train_items])
    test_paths = [p for p, _ in test_items]
    test_labels = np.stack([labels[k] for _, k in test_items])

    model = ResNet50(num_outputs=args.num_outputs,
                     generator=torch.Generator().manual_seed(0))
    model = model.to(device, memory_format=torch.channels_last)
    opt, train_step, eval_step = make_steps(model, args.lr)

    host_cpp = device.type == "cuda"  # the decode and resize in host C++
    native_loader, native = make_native_loader(train_paths, args.image_size, args.batch_size)
    print("native loader:", native)
    train_loader = native_loader or make_loader(train_paths, args.image_size, host_cpp)
    test_loader = make_loader(test_paths, args.image_size, host_cpp)

    def to_dev(a):
        return torch.as_tensor(a).to(device)

    try:
        for epoch in range(args.n_epochs):
            if native:
                train_loader.start_epoch(seed=epoch, shuffle=True)
                it = native_batches(train_loader)
            else:
                order = np.random.RandomState(epoch).permutation(len(train_paths))
                it = train_loader.batches(index_batches(order, args.batch_size))
            for bi, (u8, idx) in enumerate(it):
                loss = train_step(normalize(u8, device), to_dev(train_labels[np.asarray(idx)]))
                if bi % 50 == 0:
                    print(f"epoch {epoch} iter {bi} Loss: {float(loss):.5f}")

            if epoch % 1 == 0 and epoch != 0 and test_paths:
                test_losses = []
                for u8, idx in test_loader.batches(
                        index_batches(np.arange(len(test_paths)), args.batch_size)):
                    tl = eval_step(normalize(u8, device),
                                   to_dev(test_labels[np.asarray(idx)]))
                    test_losses.append(float(tl))
                print(f"Test epoch {epoch}; Loss: {np.mean(test_losses):.5f}")

            tag = str(epoch + 1).zfill(3)
            ckpt.save_pytree(
                os.path.join(args.ckpt_dir, f"{tag}_dict.model.msgpack"),
                regressor_tree(model, opt),
                meta={"epoch": epoch},
            )
            if args.export_torch:
                torch.save(
                    {"model": export_resnet50_torch(model), "optm": {}},
                    os.path.join(args.ckpt_dir, f"{tag}_dict.model"),
                )
    finally:
        train_loader.close()
        test_loader.close()
    return model, opt


if __name__ == "__main__":
    main()
