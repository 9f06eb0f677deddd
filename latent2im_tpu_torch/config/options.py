"""CLI flags + yaml config round-trip — own copy of
latent2im_tpu/config/options.py, with every flag kept so an ``opt.yml`` the
JAX package wrote parses unchanged. ``yaml`` is imported only where an
``opt.yml`` is read or written (the GPU machine may lack PyYAML).

Preserves (reference: options/train_options.py, options/vis_options.py):
  * grouped argparse flags (--model/--transform/--walk_type/--latent/
    --attrList/--loss/... with nn/color/biggan/stylegan/pggan groups)
  * merge precedence: CLI-explicit > yaml config > argparse defaults
    (train_options.py:150-174)
  * deterministic experiment dir naming
    {model}_{transform}_{walk_type}_lr{lr}_{loss}[_{latent}] + prefix/suffix
    (train_options.py:180-202)
  * opt.txt / opt.yml dumps with the overwrite guard (train_options.py:109-121)
  * VisOptions: positional opt.yml + overrides, returning (opt, conf)
    (vis_options.py:30-48)
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import OrderedDict

GROUPS = ("nn", "color", "biggan", "stylegan", "pggan")


def _build_train_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("Training Parser")
    parser.add_argument("--config_file", type=argparse.FileType(mode="r"),
                        help="configuration yml file")
    parser.add_argument("--overwrite_config", action="store_true",
                        help="overwrite config files if they exist")
    parser.add_argument("--model", default="stylegan_v2_real",
                        help="generator backend: stylegan_v2_real | pggan")
    parser.add_argument("--transform", default="face",
                        help="transform operation, e.g. face, scene, xray")
    parser.add_argument("--num_samples", type=int, default=20000,
                        help="number of latent z samples per epoch")
    parser.add_argument(
        "--loss", type=str, default="l2", choices=["l2", "lpips"],
        help="accepted for experiment-naming parity only; 'lpips' has NO "
        "effect on the training loss (matches the reference, whose lpips "
        "branch is dead code — pggan/transform_base.py:214 asserts then "
        "ignores it)",
    )
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--walk_type", type=str, default="linear",
                        choices=["NNz", "linear"])
    parser.add_argument("--models_dir", type=str, default="./models")
    parser.add_argument("--model_save_freq", type=int, default=400)
    parser.add_argument("--name", type=str)
    parser.add_argument("--suffix", type=str)
    parser.add_argument("--prefix", type=str)
    parser.add_argument("--gpu", default="", type=str,
                        help="kept for CLI parity; the port runs on cuda")
    parser.add_argument("--trainEmbed", action="store_true")
    parser.add_argument("--is_mlp", action="store_true",
                        help="select the MLP walk variants (the reference's "
                        "hardcoded self.is_mlp=False toggle, "
                        "transform_base.py:291, exposed)")
    parser.add_argument("--updateGAN", action="store_true")
    parser.add_argument("--attrList", type=str)
    parser.add_argument("--attrPath", type=str, default="")
    parser.add_argument("--layers", type=str)
    parser.add_argument("--no_content_loss", action="store_true")
    parser.add_argument("--no_gan_loss", action="store_true")
    # TPU-native additions
    parser.add_argument("--reg_input_size", type=int, default=None,
                        help="bilinear-resize images to this size before "
                             "regression (e.g. 256 = the regressor's trained "
                             "resolution); default: feed generator resolution")
    parser.add_argument("--content_input_size", type=int, default=None,
                        help="bilinear-resize both images to this size before "
                             "the VGG content loss (e.g. 256); default: "
                             "compare at generator resolution — the 1024px "
                             "profile's biggest cost block (BASELINE.md)")
    parser.add_argument("--fixed_noise", action="store_true",
                        help="use the stored noise buffers during training "
                             "instead of fresh per-step noise "
                             "(randomize_noise=False semantics)")
    parser.add_argument("--stable_bce", action="store_true",
                        help="numerically-stable sigmoid BCE instead of the "
                             "reference's raw-output BCE")
    parser.add_argument("--export_ref_walk", action="store_true",
                        help="also save the final walk as the reference's "
                             "pickled *_walk_module.ckpt module format")
    parser.add_argument("--host_targets", action="store_true",
                        help="geometric transforms: compute warp targets on "
                             "the host with cv2 (the reference's path) "
                             "instead of in-graph (tasks/warp.py)")
    parser.add_argument("--remat_g", nargs="?", const="all", default=False,
                        choices=["all", "block"],
                        help="rematerialize the edited-path G forward in the "
                             "train-step backward (jax.checkpoint): ~1 extra "
                             "G forward buys activation memory for larger "
                             "batches. 'all' (the bare-flag default) wraps "
                             "the whole forward; 'block' checkpoints each "
                             "synthesis block separately — same recompute, "
                             "lower peak backward memory")
    parser.add_argument("--remat_towers", action="store_true",
                        help="rematerialize the loss towers (R/VGG/D) in the "
                             "backward: one tower's full-res activations "
                             "live at a time instead of all three — the "
                             "memory floor at 1024px; composes with "
                             "--remat_g")
    parser.add_argument("--n_epochs", type=int, default=None,
                        help="override epoch count (default 10 single / 3 multi)")
    parser.add_argument("--batch_size", type=int, default=4)
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute for frozen towers")
    parser.add_argument("--n_devices", type=int, default=None,
                        help="restrict the data-parallel mesh size")
    parser.add_argument("--sp_devices", type=int, default=None,
                        help="spatially partition synthesis activation rows "
                             "over this many devices during training "
                             "(combines with --n_devices as a "
                             "(data x spatial) mesh; for memory-bound "
                             "high-res configs at small per-device batch)")
    parser.add_argument("--g_path", type=str, default="",
                        help="StyleGAN2 .pt checkpoint (g_ema [+ d]) to convert")
    parser.add_argument("--reg_path", type=str, default="",
                        help="regressor checkpoint ({'model','optm'}) to convert")
    parser.add_argument("--vgg_path", type=str, default="",
                        help="vgg19 features state_dict; random init if empty")
    parser.add_argument("--profile_dir", type=str, default="",
                        help="jax.profiler trace output dir (off when empty)")
    parser.add_argument("--resolution", type=int, default=256,
                        help="generator resolution (256 matches the reference)")
    parser.add_argument("--dev_tiny", action="store_true",
                        help="tiny channel/latent dims for CPU smoke runs")
    parser.add_argument("--kernel_impl", type=str, default=None,
                        choices=["conv", "stencil", "separable", "pallas"],
                        help="accepted so JAX-package opt.yml files parse; "
                             "does nothing in the port, whose kernel dispatch "
                             "follows the device (CUDA kernels on cuda, plain "
                             "PyTorch on cpu)")
    parser.add_argument("--real_data_dir", type=str, default="",
                        help="directory of real images for --updateGAN joint "
                             "fine-tuning (D sees real vs generated)")
    parser.add_argument("--gan_lr", type=float, default=1e-4)
    parser.add_argument("--resume", action="store_true",
                        help="resume from the latest epoch checkpoint in the "
                             "experiment dir (walk + optimizer state)")

    group = parser.add_argument_group("nn", "parameters used to specify NN walk")
    group.add_argument("--eps", type=float, help="step size of each NN block")
    group.add_argument("--num_steps", type=int, help="number of NN blocks")

    group = parser.add_argument_group("color", "parameters used for color walk")
    group.add_argument("--channel", type=int)

    group = parser.add_argument_group("biggan", "parameters used for biggan walk")
    group.add_argument("--category", type=int)

    group = parser.add_argument_group("stylegan", "parameters used for stylegan walk")
    group.add_argument("--dataset", default="scene")
    group.add_argument("--latent", default="w", help="z or w")
    group.add_argument("--truncation_psi", default=1.0)

    group = parser.add_argument_group("pggan", "parameters used for pggan walk")
    group.add_argument("--dset", default="celebahq")
    return parser


class TrainOptions:
    def __init__(self):
        self.parser = _build_train_parser()

    def parse(self, args=None, print_opt: bool = True) -> argparse.Namespace:
        opt = self.parser.parse_args(args)

        data = {}
        if opt.config_file:
            import yaml

            data = yaml.safe_load(opt.config_file) or {}
            data = _flatten(data)

        argv = sys.argv[1:] if args is None else list(args)
        option_strings = {}
        for ag in self.parser._action_groups:
            for action in ag._group_actions:
                for s in action.option_strings:
                    option_strings[s] = action.dest
        specified = {option_strings[a] for a in argv if a in option_strings}

        ns_args: dict = {}
        for group in self.parser._action_groups:
            group_dict = {
                a.dest: data[a.dest]
                if a.dest in data and a.dest not in specified
                else getattr(opt, a.dest, None)
                for a in group._group_actions
            }
            if group.title in ("positional arguments", "optional arguments", "options"):
                ns_args.update(group_dict)
            else:
                ns_args[group.title] = argparse.Namespace(**group_dict)
        opt = argparse.Namespace(**ns_args)
        if hasattr(opt, "config_file"):
            delattr(opt, "config_file")

        opt.output_dir = os.path.join(opt.models_dir, experiment_name(opt))
        if print_opt:
            self.print_options(opt)
        self.opt = opt
        return opt

    def print_options(self, opt) -> None:
        opt_dict: "OrderedDict[str, object]" = OrderedDict()
        lines = ["----------------- Options ---------------"]
        grouped = []
        for k, v in sorted(vars(opt).items()):
            if isinstance(v, argparse.Namespace):
                grouped.append((k, v))
                continue
            default = self.parser.get_default(k)
            comment = f"\t[default: {default}]" if v != default else ""
            lines.append(f"{str(k):>25}: {str(v):<30}{comment}")
            opt_dict[k] = v
        for k, v in grouped:
            lines.append(f"{k} ".ljust(20, "-"))
            opt_dict[k] = OrderedDict()
            for k1, v1 in sorted(vars(v).items()):
                default = self.parser.get_default(k1)
                comment = f"\t[default: {default}]" if v1 != default else ""
                lines.append(f"{str(k1):>25}: {str(v1):<30}{comment}")
                opt_dict[k][k1] = v1
        lines.append("----------------- End -------------------")
        message = "\n".join(lines)
        print(message)

        expr_dir = getattr(opt, "output_dir", "./")
        os.makedirs(expr_dir, exist_ok=True)
        if not opt.overwrite_config:
            for f in ("opt.txt", "opt.yml"):
                assert not os.path.isfile(
                    os.path.join(expr_dir, f)
                ), "config file exists, use --overwrite_config"
        with open(os.path.join(expr_dir, "opt.txt"), "wt") as f:
            f.write(message + "\n")
        import yaml

        with open(os.path.join(expr_dir, "opt.yml"), "wt") as f:
            opt_dict["overwrite_config"] = False
            yaml.safe_dump(_plain(opt_dict), f, default_flow_style=False,
                           sort_keys=False)


def experiment_name(opt) -> str:
    """{model}_{transform}_{walk_type}_lr{lr}_{loss}[...] (train_options.py:180-202)."""
    if getattr(opt, "name", None):
        out = opt.name
    else:
        out = "_".join(
            [opt.model, opt.transform, opt.walk_type,
             "lr" + str(opt.learning_rate), opt.loss]
        )
        if opt.model == "biggan" and getattr(opt.biggan, "category", None):
            out += f"_cat{opt.biggan.category}"
        elif "stylegan" in opt.model:
            out += f"_{opt.stylegan.latent}"
        if opt.transform.startswith("color") and opt.color.channel is not None:
            out += f"_chn{opt.color.channel}"
    if getattr(opt, "suffix", None):
        out += opt.suffix
    if getattr(opt, "prefix", None):
        out = opt.prefix + out
    return out


class VisOptions:
    """Positional opt.yml + overrides -> (opt, conf) pair (vis_options.py)."""

    def __init__(self):
        self.parser = argparse.ArgumentParser("Visualization Parser")
        p = self.parser
        p.add_argument("config_file", type=argparse.FileType(mode="r"))
        p.add_argument("--save_path_w", type=str)
        p.add_argument("--save_path_gan", type=str)
        p.add_argument("--gpu", default="", type=str)
        p.add_argument("--noise_seed", type=int, default=0)
        p.add_argument("--output_dir")
        p.add_argument("--attrList", type=str)
        p.add_argument("--attrPath", type=str, default="")
        p.add_argument("--num_samples", type=int, default=8)
        p.add_argument("--num_panels", type=int, default=7)
        p.add_argument("--latents_dir", type=str, default="",
                       help="directory of inverted W+ latents (*_w.npy from "
                            "cli.bp) to edit instead of sampled z")
        p.add_argument("--max_alpha", type=float, default=1.0)
        p.add_argument("--min_alpha", type=float, default=0.0)
        p.add_argument("--combine_indices", type=str, default="",
                       help="two regressor-table indices 'i,j' for a "
                            "2-attribute combined grid")
        p.add_argument("--n_devices", type=int, default=None,
                       help="shard inference batches data-parallel over this "
                            "many devices (default: single device)")
        p.add_argument("--sp_devices", type=int, default=None,
                       help="spatially partition synthesis activation rows "
                            "over this many devices (combines with "
                            "--n_devices as a (data x spatial) mesh; the "
                            "multi-chip route at batch sizes too small for "
                            "data parallelism)")

    def parse(self, args=None):
        import yaml

        opt = self.parser.parse_args(args)
        data = yaml.safe_load(opt.config_file) or {}
        for k, v in data.items():
            if isinstance(v, dict):
                data[k] = argparse.Namespace(**v)
        conf = argparse.Namespace(**data)
        return opt, conf


def _flatten(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flatten(v))
        else:
            out[k] = v
    return out


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj
