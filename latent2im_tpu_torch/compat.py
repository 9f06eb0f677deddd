"""Drop-in compatibility layer for reference-style call sites — PyTorch port
of latent2im_tpu/compat.py.

The reference dispatches via ``graphs.find_model_using_name(model,
transform)`` returning a graph class whose instance carries get_w /
get_logits / get_reg_preds / get_train_alpha / get_alphas /
get_w_new_tensor / apply_alpha / vis_image_batch / save+load_multi_models
(graphs/__init__.py:3-22, graphs/transform_graph_scene.py). This module lets
code written against that surface run on the port unchanged: the returned
factory builds an ``Editor`` + task + walk (engine/build.py) under the hood,
on the card unless the caller passes ``device="cpu"``.

New code should use engine.build.build_editor_from_options directly — this
shim exists so a reference user can switch with minimal edits.
"""

from __future__ import annotations

import numpy as np
import torch


class CompatGraph:
    """Reference-flavored facade over (Editor, Task, walk params)."""

    def __init__(self, editor, task, walk_params, info, seed: int = 0):
        self.editor = editor
        self.task = task
        self.walk = walk_params
        self.attrList = info["attr_list"]
        self.attrTable = info["attr_table"]
        self.attrIdx = list(editor.cfg.attr_idx)
        self.Nsliders = len(self.attrList)
        self.dim_z = editor.cfg.dim_z
        self.img_size = editor.cfg.size
        # Own the alpha-sampling stream: two identical compat runs produce
        # identical alphas (the reference samples from global np.random;
        # utils/transforms.py:647-663 statistics are preserved).
        self.rng = np.random.RandomState(seed)

    # --- reference method surface -----------------------------------------
    def get_w(self, z):
        return self.editor.get_w(np.asarray(z, np.float32))

    def get_logits(self, inputs_dict, reshape=True):
        if "w" in inputs_dict and inputs_dict["w"] is not None:
            return self.editor.synthesize(inputs_dict["w"])
        return self.editor.synthesize(np.asarray(inputs_dict["z"], np.float32))

    def get_reg_preds(self, logit):
        return self.editor.regress(logit)

    def get_train_alpha(self, zs_batch, N_attr=None, trainEmbed=False):
        if trainEmbed:
            # discrete-panel sampling (utils/transforms.py:647-656): the
            # 3rd element is the sampled bank index the step must train
            return self.task.train_alpha_embed_np(
                self.rng, len(zs_batch), N_attr or len(self.attrList)
            )
        a_graph, a_target = self.task.train_alpha_np(
            self.rng,
            len(zs_batch),
            N_attr or len(self.attrList),
        )
        return a_graph, a_target, None

    def get_alphas(self, alpha_org, alpha_sampled):
        """Unified contract: returns (alpha_target, alpha_delta) — both
        trainer variants unpack it consistently (SURVEY §3.2)."""
        return self.editor.unified_alphas(
            self.editor._tensor(alpha_org), self.editor._tensor(alpha_sampled)
        )

    def get_w_new_tensor(self, multi_ws, alpha, layers=None, **kw):
        return self.editor.edit(self.walk, self.editor._tensor(multi_ws),
                                self.editor._tensor(alpha))

    def get_z_new_tensor(self, z, alpha, name=None, trainEmbed=False,
                         index_=None, **kw):
        # embed walks route the (name, index_) pair into the bank lookup
        # (reference get_z_new_tensor -> WalkEmbed.forward(z, name, alpha,
        # index_), transform_base.py:367-369). A missing index_ is an error,
        # not bank 0, as in the JAX package.
        z, alpha = self.editor._tensor(z), self.editor._tensor(alpha)
        if self.editor.cfg.walk_kind == "embed":
            if index_ is None:
                raise ValueError(
                    "embed walks need an explicit bank index_ "
                    "(WalkEmbed.forward, transform_base.py:35-41)"
                )
            return self.editor.edit(self.walk, z, alpha, name=name, index=index_)
        return self.editor.edit(self.walk, z, alpha)

    def apply_alpha(self, graph_inputs, alpha_to_graph, layers=None, name=None,
                    trainEmbed=False, index_=None, given_w=None):
        return self.editor.apply_alpha(
            self.walk, np.asarray(graph_inputs["z"], np.float32),
            alpha_to_graph, given_w=given_w, index=index_,
        )

    def scale_test_alpha_for_graph(self, alpha, zs_batch, **kw):
        return self.task.scale_test_alpha(alpha, len(zs_batch))

    def vis_image_batch_alphas(self, num_panels, min_alpha=0.0, max_alpha=1.0):
        alphas = np.linspace(min_alpha, max_alpha, num_panels)
        return alphas, alphas

    def save_multi_models(self, save_path_w, save_path_gan=None, **kw):
        from .io import checkpoint as ckpt

        ckpt.save_pytree(save_path_w + "_walk_module.ckpt", {"walk": self.walk})

    def load_multi_models(self, save_path_w, save_path_gan=None, **kw):
        from .io import checkpoint as ckpt

        self.walk, _, _ = ckpt.load_walk(save_path_w, self.walk,
                                         attr_list=getattr(self, "attrList", None))
        if save_path_gan:
            # fine-tuned GAN surface (reference load_multi_models under
            # updateGAN, transform_base.py:501-509) — the same swap
            # cli/vis_w.py and cli/eval.py perform
            g_new, d_new = ckpt.load_gan_checkpoint(save_path_gan)
            with torch.no_grad():
                self.editor.g.load_state_dict(g_new, strict=True)
                if d_new is not None and self.editor.d is not None:
                    self.editor.d.load_state_dict(d_new, strict=True)

    def clip_ims(self, ims):
        from .engine.editor import clip_ims

        return clip_ims(ims)


def find_model_using_name(model: str, transform: str):
    """-> a factory(**graph_kwargs) building a CompatGraph, mirroring
    graphs/__init__.py:3-22 + transform_graph_scene.py's class factory.
    graph_kwargs may name the ``device`` (cuda when absent)."""

    def factory(**graph_kwargs):
        from .config.options import TrainOptions
        from .engine.build import build_editor_from_options
        from .tasks.transforms import get_task

        argv = ["--model", model, "--transform", transform, "--overwrite_config"]
        if graph_kwargs.get("attrList"):
            al = graph_kwargs["attrList"]
            argv += ["--attrList", al if isinstance(al, str) else ",".join(al)]
        if graph_kwargs.get("attrPath"):
            argv += ["--attrPath", graph_kwargs["attrPath"]]
        if graph_kwargs.get("walk_type"):
            argv += ["--walk_type", graph_kwargs["walk_type"]]
        if graph_kwargs.get("lr"):
            argv += ["--learning_rate", str(graph_kwargs["lr"])]
        opt = TrainOptions().parse(argv, print_opt=False)
        for k in ("dev_tiny", "resolution", "g_path", "reg_path", "no_gan_loss",
                  "no_content_loss"):
            if k in graph_kwargs:
                setattr(opt, k, graph_kwargs[k])
        editor, walk, info = build_editor_from_options(
            opt, device=graph_kwargs.get("device"))
        task = get_task(transform, walk_type=opt.walk_type,
                        nsliders=len(info["attr_list"]))
        return CompatGraph(editor, task, walk, info)

    return factory


def batch_input(graph_inputs: dict, s) -> dict:
    """Slice a dict of arrays by a batch slice (utils/util.py:5-16)."""
    out = {}
    for k, v in graph_inputs.items():
        out[k] = v[s] if isinstance(v, np.ndarray) else v
    return out
