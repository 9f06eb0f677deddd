"""Attribute vocabularies (own copy of latent2im_tpu/config/attributes.py).

Per-transform attrList/attrTable built from the vocabulary files shipped in
this package (dataset/attributes_celeba.txt, 40 CelebA attributes;
dataset/attributes_scene.txt, 40 transient scene attributes), the inline
dsprites/chair/xray tables, and the --attrList subset filter.
"""

from __future__ import annotations

import os
from collections import OrderedDict

_PKG_DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "dataset"
)

DEFAULT_SCENE_TABLE = OrderedDict(
    {
        "daylight": 1, "night": 2, "sunrisesunset": 3, "sunny": 5, "clouds": 6,
        "fog": 7, "snow": 9, "warm": 10, "cold": 11, "beautiful": 13,
        "flowers": 14, "spring": 15, "summer": 16, "autumn": 17, "winter": 18,
        "colorful": 20, "dark": 24, "bright": 25, "rain": 29, "boring": 37,
        "lush": 39,
    }
)

XRAY_TABLE = OrderedDict(
    {"Cardiomegaly": 0, "Edema": 1, "Consolidation": 2, "Atelectasis": 3,
     "Effusion": 4}
)

DSPRITES_TABLE = OrderedDict({"scale": 0, "x": 1, "y": 2, "posx": 3, "posy": 4})
CHAIR_TABLE = OrderedDict({"x": 0, "y": 1})


def load_attr_file(path: str) -> OrderedDict:
    table: OrderedDict = OrderedDict()
    with open(path) as f:
        for i, line in enumerate(f):
            if line.strip():
                table[line.strip()] = i
    return table


def default_attr_path(transform: str) -> str:
    name = {
        "face": "attributes_celeba.txt",
        "scene": "attributes_scene.txt",
    }.get(transform)
    return "" if name is None else os.path.join(_PKG_DATA, name)


def build_attr_vocab(
    transform: str, attr_path: str = "", attr_list: str | None = None
) -> tuple[list[str], OrderedDict]:
    """-> (attrList, attrTable). `attr_list` is the comma-separated subset
    filter from --attrList; the table always covers the full vocabulary."""
    if transform == "face":
        table = load_attr_file(attr_path or default_attr_path("face"))
        if len(table) < 39:
            raise ValueError("celeba attribute file should list ~40 attrs")
    elif transform == "scene":
        if attr_path:
            table = load_attr_file(attr_path)
            if len(table) != 40:
                raise ValueError("len(attrList) should be 40")
        else:
            table = OrderedDict(DEFAULT_SCENE_TABLE)
    elif transform == "xray":
        table = OrderedDict(XRAY_TABLE)
    elif transform == "dsprites":
        table = OrderedDict(DSPRITES_TABLE)
    elif transform == "chair":
        table = OrderedDict(CHAIR_TABLE)
    else:
        raise KeyError(f"no attribute vocabulary for transform '{transform}'")

    if attr_list:
        names = attr_list.split(",")
        missing = [n for n in names if n not in table]
        if missing:
            raise KeyError(f"attributes not in vocabulary: {missing}")
    else:
        names = list(table.keys())
    return names, table


def attr_indices(names: list[str], table: OrderedDict) -> list[int]:
    return [table[n] for n in names]


def parse_layers(layers) -> tuple[int, ...] | None:
    """--layers '0,1,2' -> (0, 1, 2); None passthrough."""
    if not layers:
        return None
    if isinstance(layers, (tuple, list)):
        return tuple(int(x) for x in layers)
    return tuple(int(x) for x in str(layers).split(","))
