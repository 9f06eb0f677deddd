"""Records the JAX package's host targets (latent2im_tpu/tasks/geometric.py:
``get_target_np``, through cv2) of seeded images, for the machines that have
no cv2 (chip_smoke.py phase 51, tests/test_torch_host_targets.py):

    PYTHONPATH=. python tests/fixtures/torch_host_targets/make_fixtures.py

The images are integers in [-127, 127] over 128 in float32 (``images``), the
same bits on every machine: B=2 at 64 px for each task at three alphas, its
range's ends among them, and B=1 at 256 px at one alpha. targets.json holds
per case the task, size, alpha, the shapes and dtypes, and the SHA-256 of
the target's and of the mask's bytes; for rotate2d and rotate3d also the
matrix cv2 warped with (getRotationMatrix2D's, ImageTransformer's), so that
a machine whose numpy sine differs in the last bit can tell that apart from
a warp that differs. targets.npz holds colorlab's targets on a grid of 16 x
16 pixels (``[:, ::size // 16, ::size // 16]``): their Lab round trip goes
through libm's powers, so they are compared within a tolerance."""

import hashlib
import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

COLOR = [[[0.31, -0.12, 0.05], [-0.27, 0.44, -0.38]],
         [[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]],
         [[-0.5, -0.5, -0.5], [-0.5, -0.5, -0.5]]]
ALPHAS_64 = {"color": COLOR, "colorlab": COLOR, "zoom": [0.5, 1.37, 2.0],
             "shiftx": [-8, 3, 7], "shifty": [-8, -2, 7], "rotate2d": [-45, 13, 44],
             "rotate3d": [-720, 233, 719]}
ALPHAS_256 = {"color": [[[0.21, -0.33, 0.4]]], "colorlab": [[[-0.18, 0.29, -0.41]]],
              "zoom": [0.73], "shiftx": [5], "shifty": [-6], "rotate2d": [30],
              "rotate3d": [-311]}


def images(size: int, batch: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return rng.randint(-127, 128, (batch, size, size, 3)).astype(np.float32) / np.float32(128)


def cases():
    """(name, task, size, batch, alpha) of every case."""
    out = []
    for size, batch, table in ((64, 2, ALPHAS_64), (256, 1, ALPHAS_256)):
        for task, alphas in table.items():
            for i, a in enumerate(alphas):
                out.append((f"{task}_{size}_{i}", task, size, batch, a))
    return out


def seed_of(size: int) -> int:
    return 70 + size


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def main() -> None:
    import cv2

    from latent2im_tpu.tasks import geometric as jgeo

    meta, arrays = {"cv2": cv2.__version__, "numpy": np.__version__}, {}
    for name, task, size, batch, alpha in cases():
        imgs = images(size, batch, seed_of(size))
        a = np.asarray(alpha, np.float32) if task.startswith("color") else alpha
        target, mask = jgeo.GEOMETRIC_TASKS[task]().get_target_np(imgs.copy(), a)
        rec = {"task": task, "size": size, "batch": batch, "alpha": alpha,
               "target": [list(target.shape), str(target.dtype), sha(target)],
               "mask": [list(mask.shape), str(mask.dtype), sha(mask)]}
        if task == "rotate2d":
            rec["matrix"] = cv2.getRotationMatrix2D((size // 2, size // 2), alpha, 1).tolist()
        if task == "rotate3d":
            it = jgeo.ImageTransformer(imgs[0])
            it.rotate_along_axis(phi=alpha, dx=5)
            rec["matrix"] = it._get_m(*np.deg2rad([0, alpha, 0]), 5, 0, it.focal).tolist()
        if task == "colorlab":
            arrays[name] = target[:, ::size // 16, ::size // 16]
        meta[name] = rec
    np.savez_compressed(os.path.join(HERE, "targets.npz"), **arrays)
    with open(os.path.join(HERE, "targets.json"), "w") as f:
        json.dump(meta, f, indent=1)


if __name__ == "__main__":
    main()
