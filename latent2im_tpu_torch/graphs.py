"""Alias module mirroring the reference's ``graphs`` package entry point —
PyTorch port of latent2im_tpu/graphs.py.

``from latent2im_tpu_torch import graphs; graphs.find_model_using_name(model,
transform)`` works like the reference's ``import graphs`` dispatch
(graphs/__init__.py:3-22). See compat.py for the facade it returns.
"""

from .compat import CompatGraph, batch_input, find_model_using_name

__all__ = ["find_model_using_name", "CompatGraph", "batch_input"]
