"""The port's kernels: each wrapper launches a hand-written CUDA kernel on a
CUDA tensor and runs its plain PyTorch version on a CPU tensor. The forward
wrappers record autograd nodes whose backwards go through the backward
wrappers (``fused_leaky_relu_bwd``, ``upfirdn2d_bwd``).

Each wrapper carries a plain-integer ``launches`` count, raised by one where
it launches its kernel and nowhere else, so a run can show that its path went
through the kernels, and ``launches_bf16``, raised with it where the launch
is the kernel's bf16 instance (the --bf16 compute).

``SPLIT_KERNELS`` are the styled conv's tensor-parallel split (its partial
product and its epilogue, run on either side of an all-reduce): counted
apart (``split_launch_counts``), reset with the rest."""

from .fused_act import (fused_leaky_relu, fused_leaky_relu_bwd,
                        fused_leaky_relu_bwd_plain, fused_leaky_relu_plain)
from .styled_conv import (styled_conv3x3, styled_conv3x3_epilogue,
                          styled_conv3x3_epilogue_plain, styled_conv3x3_partial,
                          styled_conv3x3_partial_plain, styled_conv3x3_plain,
                          styled_conv3x3_plan, styled_conv3x3_tf32,
                          styled_conv3x3_xla)
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
SPLIT_KERNELS = {
    "styled_conv3x3_partial": styled_conv3x3_partial,
    "styled_conv3x3_epilogue": styled_conv3x3_epilogue,
}


def launch_counts(bf16: bool = False) -> dict[str, int]:
    """Launches per kernel since the last reset: all of them, or with
    bf16=True those of the bf16 instances."""
    return {name: fn.launches_bf16 if bf16 else fn.launches
            for name, fn in KERNELS.items()}


def split_launch_counts(bf16: bool = False) -> dict[str, int]:
    """``launch_counts`` of the styled conv's tensor-parallel split."""
    return {name: fn.launches_bf16 if bf16 else fn.launches
            for name, fn in SPLIT_KERNELS.items()}


def reset_launches() -> None:
    for fn in (*KERNELS.values(), *SPLIT_KERNELS.values()):
        fn.launches = fn.launches_bf16 = 0


__all__ = [
    "KERNELS", "SPLIT_KERNELS", "blur2d", "downsample2d", "fused_leaky_relu",
    "fused_leaky_relu_bwd", "fused_leaky_relu_bwd_plain",
    "fused_leaky_relu_plain", "launch_counts", "make_kernel",
    "reset_launches", "split_launch_counts", "styled_conv3x3",
    "styled_conv3x3_epilogue", "styled_conv3x3_epilogue_plain",
    "styled_conv3x3_partial", "styled_conv3x3_partial_plain", "styled_conv3x3_plain",
    "styled_conv3x3_plan", "styled_conv3x3_tf32", "styled_conv3x3_xla",
    "transposed_params",
    "upfirdn2d", "upfirdn2d_bwd", "upfirdn2d_form", "upfirdn2d_plain",
    "upsample2d",
]
