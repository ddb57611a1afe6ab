"""Checkpoint conversion CLI: the counterpart of the JAX package's
convert_pth.py, without JAX.

Import (a reference .pth -> weights.msgpack in the JAX package's form,
which both packages' val_mm read):
  python -m ir_ads_tpu_torch.convert_pth import --pth model.pth --out weights_dir/ \\
      [--backbone SwinTransformer-L] [--num-classes 40] \\
      [--pretrained-swin [--window-size 12]]  # a raw upstream Swin checkpoint

Export (weights.msgpack -> a torch state_dict of ``params.<flax path>`` and
``batch_stats.<flax path>`` keys, the flax layouts, as the JAX package's
``do_export`` writes it):
  python -m ir_ads_tpu_torch.convert_pth export --weights weights_dir/weights.msgpack \\
      --out model.pth

Import builds the port's CMNeXt for ``--backbone`` (its weights drawn from
seed 0 where the checkpoint has none, as load_state_dict(strict=False)
leaves them), imports the checkpoint with ``utils.torch_import`` and writes
``utils.checkpoint.save_weights``.  Runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Sequence

import torch


def read_pth(path: str) -> Dict[str, torch.Tensor]:
    """A .pth's tensors, from its ``state_dict``, ``model`` or
    ``model_state_dict`` entry where it has one."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model", "model_state_dict"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    return {k: v for k, v in ckpt.items() if isinstance(v, torch.Tensor)}


def do_import(pth: str, out: str, backbone: str = "SwinTransformer-B",
              num_classes: int = 40, pretrained_swin: bool = False, window_size: int = 12,
              **model_kw) -> List[str]:
    """Writes ``out``/weights.msgpack; returns the importer's warnings.
    ``model_kw`` goes to ``CMNeXt`` (``backbone_kwargs``, ``head_dims``)."""
    from ir_ads_tpu_torch.models.cmnext import CMNeXt
    from ir_ads_tpu_torch.serve import init_random_
    from ir_ads_tpu_torch.utils.checkpoint import save_weights
    from ir_ads_tpu_torch.utils.torch_import import (
        import_cmnext_state_dict, import_pretrained_swin,
    )

    sd = read_pth(pth)
    model = CMNeXt(backbone=backbone, num_classes=num_classes, **model_kw)
    init_random_(model, 0)
    if pretrained_swin:
        state, warnings = import_pretrained_swin(sd, model.state_dict(), window_size)
    else:
        state, warnings = import_cmnext_state_dict(sd, model.state_dict())
    for w in warnings[:20]:
        print("warn:", w)
    if len(warnings) > 20:
        print(f"... {len(warnings) - 20} more warnings")
    os.makedirs(out, exist_ok=True)
    save_weights(os.path.join(out, "weights.msgpack"), state)
    print(f"imported {len(sd)} tensors -> {out}/weights.msgpack")
    return warnings


def exported(weights: str) -> Dict[str, torch.Tensor]:
    """weights.msgpack (or its directory) as ``params.<path>`` and
    ``batch_stats.<path>`` tensors, the path's keys joined by dots."""
    from ir_ads_tpu_torch.utils.checkpoint import load_weights
    from ir_ads_tpu_torch.utils.jax_params import _walk

    tree = load_weights(weights)
    return {".".join((coll,) + path): torch.from_numpy(arr)
            for coll in ("params", "batch_stats") for path, arr in _walk(tree[coll])}


def do_export(weights: str, out: str) -> int:
    """Writes the torch state_dict ``exported(weights)`` to ``out``;
    returns its number of tensors."""
    sd = exported(weights)
    torch.save(sd, out)
    print(f"exported {len(sd)} tensors -> {out}")
    return len(sd)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    pi = sub.add_parser("import")
    pi.add_argument("--pth", required=True)
    pi.add_argument("--out", required=True)
    pi.add_argument("--backbone", default="SwinTransformer-B")
    pi.add_argument("--num-classes", type=int, default=40)
    pi.add_argument("--pretrained-swin", action="store_true")
    pi.add_argument("--window-size", type=int, default=12)
    pe = sub.add_parser("export")
    pe.add_argument("--weights", required=True)
    pe.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if args.cmd == "import":
        do_import(args.pth, args.out, args.backbone, args.num_classes, args.pretrained_swin,
                  args.window_size)
    else:
        do_export(args.weights, args.out)


if __name__ == "__main__":
    main()
