"""index.html gallery over a directory of PNGs — own copy of
latent2im_tpu/utils/html.py (reference utils/html.py:5-26)."""

from __future__ import annotations

import os


def make_html(images_dir: str, width: int = 600) -> str:
    names = sorted(f for f in os.listdir(images_dir) if f.endswith(".png"))
    path = os.path.join(images_dir, "index.html")
    with open(path, "w", encoding="utf-8") as fid:
        fid.write('<table style="text-align:center;">')
        fid.write("<tr><td>Image #</td><td>Output</td></tr>")
        for name in names:
            fid.write("<tr>")
            fid.write(f"<td>{name}</td>")
            fid.write(
                f'<td><a href="{name}"><img src="{name}" width="{width}"/></a></td>'
            )
            fid.write("</tr>")
        fid.write("</table>")
    return path
