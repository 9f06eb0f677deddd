"""Device resolution for the port's entry points.

The port runs on a CUDA card. An entry point given no device takes ``cuda``
and raises when there is none; the CPU runs only when a caller asks for it
(``device="cpu"``, as the tests do), and there every kernel wrapper takes its
plain PyTorch version. Nothing falls back to the CPU quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> cuda; raises when cuda is asked for and absent.

    On cuda this also turns TF32 off for cuDNN convolutions and cuBLAS
    matmuls (a process-wide PyTorch setting): the port's path is f32, and
    cuDNN would otherwise run f32 convs in TF32 by default."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU; pass device='cpu' "
                "to run the plain PyTorch versions on the CPU"
            )
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
