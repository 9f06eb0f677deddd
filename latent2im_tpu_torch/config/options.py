"""CLI flags + yaml config round-trip — own copy of
latent2im_tpu/config/options.py, with every flag kept so an ``opt.yml`` the
JAX package wrote parses unchanged. ``opt.yml`` is read and written by
``yaml_load`` / ``yaml_dump`` below, the subset of YAML that
``yaml.safe_dump(..., default_flow_style=False)`` writes for an options
dict, so no PyYAML is needed (the GPU machine has none).

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
import math
import os
import re
import sys
from collections import OrderedDict

GROUPS = ("nn", "color", "biggan", "stylegan", "pggan")

# ---------------------------------------------------------------------------
# opt.yml: top-level scalars and one level of nested mappings, scalars
# str / int / float / bool / null, '#' comments. Plain scalars resolve as
# PyYAML's YAML 1.1 resolvers do; what would need more of YAML raises.
# ---------------------------------------------------------------------------

_YAML_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                               "On", "ON"), True),
              **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off",
                               "Off", "OFF"), False)}
_YAML_NULL = ("", "~", "null", "Null", "NULL")
_YAML_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_YAML_INT_OTHER = re.compile(  # binary, octal, hex, sexagesimal: not written here
    r"[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$|[-+]?0x[0-9a-fA-F_]+$"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$")
_YAML_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                         r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_YAML_SPECIAL_FLOAT = {".inf": math.inf, ".Inf": math.inf, ".INF": math.inf,
                       "+.inf": math.inf, "+.Inf": math.inf, "+.INF": math.inf,
                       "-.inf": -math.inf, "-.Inf": -math.inf, "-.INF": -math.inf,
                       ".nan": math.nan, ".NaN": math.nan, ".NAN": math.nan}
_YAML_TIMESTAMP = re.compile(r"[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}")
_YAML_KEY_LINE = re.compile(r"( *)([A-Za-z_][A-Za-z0-9_]*):(?: +(.*))?$")
_YAML_PLAIN_SAFE = re.compile(r"[A-Za-z_/.][A-Za-z0-9_./,+-]*$")
_YAML_INDICATORS = "[]{}&*!|>%@`\"'"


def _yaml_plain(text: str, where: str):
    """A plain scalar -> its value, as PyYAML's safe_load resolves it."""
    if text in _YAML_NULL:
        return None
    if text in _YAML_BOOL:
        return _YAML_BOOL[text]
    if _YAML_INT.match(text):
        return int(text.replace("_", ""))
    if text in _YAML_SPECIAL_FLOAT:
        return _YAML_SPECIAL_FLOAT[text]
    if _YAML_FLOAT.match(text):
        return float(text.replace("_", ""))
    if _YAML_INT_OTHER.match(text) or _YAML_TIMESTAMP.match(text):
        raise ValueError(f"{where}: {text!r} is a YAML form this reader does not take")
    if text[0] in _YAML_INDICATORS or text.startswith(("- ", "? ", ": ")) or text == "-":
        raise ValueError(f"{where}: flow collections, anchors, tags, block scalars "
                         f"and sequences are not supported ({text!r})")
    if ": " in text or text.endswith(":"):
        raise ValueError(f"{where}: a mapping inside a value ({text!r})")
    return text


def _yaml_quoted(text: str, where: str):
    """A single- or double-quoted scalar, with an optional comment after it."""
    q = text[0]
    i, out = 1, []
    while True:
        j = text.find(q, i) if q == "'" else _next_double_quote(text, i)
        if j < 0:
            raise ValueError(f"{where}: a quoted scalar that does not end on its line "
                             "(multi-line scalars are not supported)")
        out.append(text[i:j])
        if q == "'" and text[j + 1:j + 2] == "'":  # '' is an escaped quote
            out.append("'")
            i = j + 2
            continue
        break
    rest = text[j + 1:].strip()
    if rest and not rest.startswith("#"):
        raise ValueError(f"{where}: unexpected {rest!r} after a quoted scalar")
    s = "".join(out)
    if q == '"':
        try:
            s = s.encode("latin-1", "backslashreplace").decode("unicode_escape")
        except UnicodeDecodeError as e:
            raise ValueError(f"{where}: bad escape in a double-quoted scalar") from e
    return s


def _next_double_quote(text: str, i: int) -> int:
    while i < len(text):
        if text[i] == "\\":
            i += 2
            continue
        if text[i] == '"':
            return i
        i += 1
    return -1


def _yaml_value(text: str, where: str):
    if text[:1] in ("'", '"'):
        return _yaml_quoted(text, where)
    for m in re.finditer(r"\s#", text):  # a comment after a plain scalar
        text = text[:m.start()]
        break
    return _yaml_plain(text.strip(), where)


def yaml_load(text: str, name: str = "opt.yml") -> dict:
    """Parse an opt.yml: a mapping of scalars and of one level of nested
    mappings of scalars. Raises ValueError naming the line for anything
    else (flow collections, anchors, sequences, multi-line scalars)."""
    out: dict = {}
    group, group_indent = None, None
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{n}"
        line = raw.rstrip()
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError(f"{where}: a tab in the indentation")
        m = _YAML_KEY_LINE.match(line)
        if m is None:
            raise ValueError(f"{where}: not a 'key: value' line (multi-line scalars, "
                             f"sequences and documents are not supported): {raw!r}")
        indent, key, value = len(m.group(1)), m.group(2), m.group(3)
        if indent == 0:
            target = out
            group = None
        elif group is not None and group_indent in (None, indent):
            group_indent = indent
            target = out[group]
        else:
            raise ValueError(f"{where}: unexpected indentation (one level of nested "
                             "mappings is supported)")
        if key in target:
            raise ValueError(f"{where}: duplicate key {key!r}")
        if value is None or value.startswith("#"):
            if indent:  # null; a line nested under it fails the indent check
                target[key] = None
                continue
            target[key] = {}
            group, group_indent = key, None
        else:
            target[key] = _yaml_value(value, where)
    # a key with nothing under it is null, as in YAML
    return {k: (None if v == {} else v) for k, v in out.items()}


def _yaml_scalar(v, where: str) -> str:
    if v is None:
        return "null"
    if v is True or v is False:
        return "true" if v else "false"
    if type(v) is int:
        return str(v)
    if type(v) is float:
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        s = repr(v).lower()
        if "." not in s and "e" in s:  # YAML 1.1 floats need a dot
            s = s.replace("e", ".0e", 1)
        return s
    if type(v) is str:
        if _YAML_PLAIN_SAFE.match(v) and _yaml_plain(v, where) == v:
            return v
        if any(not c.isprintable() for c in v):
            raise ValueError(f"{where}: a string with unprintable characters {v!r}")
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"{where}: cannot write a {type(v).__name__} to opt.yml")


def yaml_dump(data: dict) -> str:
    """The opt.yml text of a mapping of scalars and of mappings of scalars, as
    ``yaml.safe_dump(data, default_flow_style=False, sort_keys=False)``
    writes it; strings that would read back as another type are quoted."""
    lines = []
    for k, v in data.items():
        if isinstance(v, dict):
            if not v:
                raise ValueError(f"{k}: an empty mapping needs a flow form")
            lines.append(f"{k}:")
            for k1, v1 in v.items():
                if isinstance(v1, dict):
                    raise ValueError(f"{k}.{k1}: mappings nest one level in opt.yml")
                lines.append(f"  {k1}: {_yaml_scalar(v1, f'{k}.{k1}')}")
        else:
            lines.append(f"{k}: {_yaml_scalar(v, k)}")
    return "\n".join(lines) + "\n"


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
            with opt.config_file as f:
                data = _flatten(yaml_load(f.read(), f.name))

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
        opt_dict["overwrite_config"] = False
        text = yaml_dump(_plain(opt_dict))
        with open(os.path.join(expr_dir, "opt.yml"), "wt") as f:
            f.write(text)


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
        opt = self.parser.parse_args(args)
        with opt.config_file as f:
            data = yaml_load(f.read(), f.name)
        opt.config_file = f.name  # read and closed: the path, which a launched rank can take
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
