"""Latent walks of the port (see walks.py)."""

from .walks import (REGISTRY, apply_walk, init_walk, resolve_walk_kind,
                    walk_space)

__all__ = ["REGISTRY", "apply_walk", "init_walk", "resolve_walk_kind",
           "walk_space"]
