"""Simultaneous multi-attribute walk training — PyTorch port of
latent2im_tpu/cli/train_multi_attr.py.

The reference's train_multi_attr.py is the same loop as train.py with 3
epochs (train_multi_attr.py:54) and loss artifacts (loss_values.npy + curve
PNG, :226-231), so this is a thin wrapper. Train the full attribute bank by
omitting --attrList (all 40 attributes).

    python -m latent2im_tpu_torch.cli.train_multi_attr --attrList Smiling,Young \
        --models_dir ./models_celeba --overwrite_config
"""

from __future__ import annotations

from ..config.options import TrainOptions
from .train import run

N_EPOCH_MULTI = 3  # train_multi_attr.py:54


def main():
    opt = TrainOptions().parse()
    run(opt, n_epoch_default=N_EPOCH_MULTI, save_loss_artifacts=True)


if __name__ == "__main__":
    main()
