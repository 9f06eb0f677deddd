"""The port's kernels: each wrapper launches a hand-written CUDA kernel on a
CUDA tensor and runs its plain PyTorch version on a CPU tensor. The forward
wrappers record autograd nodes whose backwards go through the backward
wrappers (``fused_leaky_relu_bwd``, ``upfirdn2d_bwd``).

Each wrapper carries a plain-integer ``launches`` count, raised by one where
it launches its kernel and nowhere else, so a run can show that its path went
through the kernels."""

from .fused_act import (fused_leaky_relu, fused_leaky_relu_bwd,
                        fused_leaky_relu_bwd_plain, fused_leaky_relu_plain)
from .styled_conv import (styled_conv3x3, styled_conv3x3_plain,
                          styled_conv3x3_plan, styled_conv3x3_tf32)
from .upfirdn2d import (blur2d, downsample2d, make_kernel, transposed_params,
                        upfirdn2d, upfirdn2d_bwd, upfirdn2d_form,
                        upfirdn2d_plain, upsample2d)

KERNELS = {
    "fused_act": fused_leaky_relu,
    "fused_act_bwd": fused_leaky_relu_bwd,
    "upfirdn2d": upfirdn2d,
    "upfirdn2d_bwd": upfirdn2d_bwd,
    "styled_conv3x3": styled_conv3x3,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


__all__ = [
    "KERNELS", "blur2d", "downsample2d", "fused_leaky_relu",
    "fused_leaky_relu_bwd", "fused_leaky_relu_bwd_plain",
    "fused_leaky_relu_plain", "launch_counts", "make_kernel",
    "reset_launches", "styled_conv3x3", "styled_conv3x3_plain",
    "styled_conv3x3_plan", "styled_conv3x3_tf32", "transposed_params",
    "upfirdn2d", "upfirdn2d_bwd", "upfirdn2d_form", "upfirdn2d_plain",
    "upsample2d",
]
