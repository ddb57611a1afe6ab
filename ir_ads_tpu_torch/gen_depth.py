"""Depth maps for RGB image folders: counterpart of the root gen_depth.py,
which builds the vCLR depth-view training data (reference gen_depth.py:1-24:
ZoeDepth through torch.hub, a per-image .npy depth, and a colour-mapped PNG
of it for the depth view).

    python -m ir_ads_tpu_torch.gen_depth --input imgs/ --output depth/ --proxy [--cmap]
        [--device cuda]

``--proxy`` computes the JAX package's stand-in for a depth model (smoothed
inverse luminance times a vertical prior: floors near, sky far; NOT a depth
model) as torch on ``--device`` (the card unless the caller asks for
``cpu``).  The original computes in f64, because its vertical prior is an
f64 ``linspace``, and so does this one: its box blur is a difference of 2-D
cumulative sums of about h * w terms, which would cancel in f32.  The
colour map (``depth_to_cmap``) runs in f32 as the original's does.  The
ZoeDepth route needs a download, which nothing here may make: without
``--proxy`` the script stops with a message, as the JAX script does when it
has no network.  Images are read with PIL (``.jpg``, ``.jpeg``, ``.png``, in
name order); depth goes to ``<output>/<stem>.npy`` (f32) and, with
``--cmap``, the colour map to ``<output>_cmap/<stem>.png``.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]


def proxy_depth(img: Array, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """(H, W) f32 proxy depth of an (H, W, 3) uint8 image on ``device``: the
    grey level in f32, (1.2 - grey) times a vertical prior from 1 at the top
    to 0.2 at the bottom in f64, then a box blur of half-width max(H // 32,
    1) over the edge-padded map, as differences of its 2-D cumulative sums
    (the original's window: rows and columns [i - k, i + k) of the padded
    map's sums), in f64; the result rounded to f32."""
    x = torch.as_tensor(img if torch.is_tensor(img) else np.array(img), device=device)
    gray = x.float().mean(-1) / 255.0
    h, w = gray.shape
    vert = torch.linspace(1.0, 0.2, h, dtype=torch.float64, device=x.device)[:, None]
    d = (1.2 - gray).double() * vert
    k = max(h // 32, 1)
    rows = torch.arange(-k, h + k, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-k, w + k, device=x.device).clamp(0, w - 1)
    c = d[rows][:, cols].cumsum(0).cumsum(1)
    d = (c[2 * k:, 2 * k:] - c[:-2 * k, 2 * k:] - c[2 * k:, :-2 * k]
         + c[:-2 * k, :-2 * k]) / float((2 * k) ** 2)
    return d[:h, :w].float()


def depth_to_cmap(depth: Array) -> torch.Tensor:
    """(H, W, 3) uint8 colour map of a depth map, in f32: the depth
    normalised to [0, 1], then three clipped hat functions (red far, blue
    near), times 255, truncated."""
    d = torch.as_tensor(depth if torch.is_tensor(depth) else np.array(depth)).float()
    lo, hi = d.min(), d.max()
    d = (d - lo) / torch.clamp(hi - lo, min=1e-6)
    rgb = [torch.clamp(1.5 - (4 * d - c).abs(), 0, 1) for c in (3, 2, 1)]
    return (torch.stack(rgb, -1) * 255).to(torch.uint8)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--proxy", action="store_true", help="use the proxy depth")
    p.add_argument("--cmap", action="store_true", help="also write colour-map PNGs")
    p.add_argument("--device", default="cuda", help="the proxy's device (default: the card)")
    args = p.parse_args(argv)
    if not args.proxy:
        raise SystemExit("ZoeDepth needs a download (torch.hub, isl-org/ZoeDepth), which this "
                         "port does not make: re-run with --proxy")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available (pass --device cpu)")
    from PIL import Image

    os.makedirs(args.output, exist_ok=True)
    if args.cmap:
        os.makedirs(args.output + "_cmap", exist_ok=True)
    for path in sorted(Path(args.input).glob("*")):
        if path.suffix.lower() not in {".jpg", ".jpeg", ".png"}:
            continue
        img = np.asarray(Image.open(path).convert("RGB"))
        depth = proxy_depth(img, args.device)
        np.save(os.path.join(args.output, path.stem + ".npy"), depth.cpu().numpy())
        if args.cmap:
            Image.fromarray(depth_to_cmap(depth).cpu().numpy()).save(
                os.path.join(args.output + "_cmap", path.stem + ".png"))
    print(f"depth written to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
