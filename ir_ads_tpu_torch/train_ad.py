"""Anomaly-separation training and evaluation on the port: counterpart of
the JAX package's train_ad.py.

  1. Train the deviation network (ResNet trunk + score head, f32, Adam over
     every parameter) on balanced 2:1 normal:outlier batches with CutMix
     pseudo-anomalies and the deviation loss (labels {0, 1, 2}; 1 and 2 are
     outliers).
  2. Evaluate AUROC on the unseen-defect test split (eval mode: the
     BatchNorms' running statistics).
  3. With ``--lightsb``, fit a Light Schrödinger Bridge between the normal
     and the anomalous training features and score the test set by its
     potential, alone and combined with the deviation score.

    python -m ir_ads_tpu_torch.train_ad --dataset_root data/mvtec --classname carpet \\
        --nAnomaly 10 --epochs 10 [--lightsb]
    python -m ir_ads_tpu_torch.train_ad ... --device cpu

Runs on the GPU unless ``--device cpu`` is given; it sets no global
precision flag and logs the ones it ran with (PyTorch's default lets cuDNN
take TF32 in f32 convolutions).  ``--seed`` draws the trunk's initial
weights (flax's initialisers, not JAX's draws); the batches' seeds and the
bridge's sampling draws are the JAX driver's.  The weights file,
``{output}/{classname}_weights.msgpack``, is the one the JAX driver writes:
its ``load_weights`` reads it with ``AnomalyScoreNet``'s template.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ir_ads_tpu_torch.anomaly import (
    AnomalyScoreNet,
    LightSBParams,
    deviation_loss,
    get_log_C,
    get_log_potential,
    init_lightsb,
    init_r_by_samples,
)
from ir_ads_tpu_torch.anomaly.data import ADConfig, MVTecAD, balanced_batches, test_batches
from ir_ads_tpu_torch.utils.checkpoint import save_anomaly_weights
from ir_ads_tpu_torch.utils.logging import get_logger


def auroc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based AUROC (Mann-Whitney U), ties given their average rank."""
    order = np.argsort(scores)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(scores) + 1)
    s_sorted = scores[order]
    i = 0
    while i < len(s_sorted):
        j = i
        while j + 1 < len(s_sorted) and s_sorted[j + 1] == s_sorted[i]:
            j += 1
        if j > i:
            ranks[order[i: j + 1]] = ranks[order[i: j + 1]].mean()
        i = j + 1
    pos = labels > 0
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def build(backbone: str, lr: float, device: torch.device,
          seed: int = 0) -> Tuple[AnomalyScoreNet, torch.optim.Optimizer]:
    """The score network, its weights drawn from ``seed``, and Adam over
    all its parameters (optax.adam's defaults)."""
    model = AnomalyScoreNet(backbone, generator=torch.Generator().manual_seed(seed))
    model = model.to(device)
    return model, torch.optim.Adam(model.parameters(), lr=lr)


def train_step(model: AnomalyScoreNet, optimizer: torch.optim.Optimizer,
               imgs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """One deviation step in train mode (batch statistics, the running ones
    updated); returns the loss before the update, on the device."""
    model.train()
    score, _ = model(imgs)
    loss = deviation_loss(score, (labels > 0).to(torch.float32))
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


@torch.no_grad()
def infer(model: AnomalyScoreNet, imgs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(score, pooled features) in eval mode."""
    model.eval()
    return model(imgs)


def evaluate(model: AnomalyScoreNet, dataset: MVTecAD, batch_size: int,
             device: torch.device) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``infer`` over ``test_batches(dataset)``: (scores, labels, features)."""
    scores, labels, feats = [], [], []
    for imgs, lbl in test_batches(dataset, batch_size):
        s, f = infer(model, torch.from_numpy(imgs).to(device))
        scores.append(s.cpu().numpy())
        feats.append(f.cpu().numpy())
        labels.append(lbl)
    return np.concatenate(scores), np.concatenate(labels), np.concatenate(feats)


def fit_lightsb(feats0: torch.Tensor, feats1: torch.Tensor, generator: torch.Generator,
                n_potentials: int = 10, epsilon: float = 1.0, steps: int = 500,
                lr: float = 1e-2) -> Tuple[LightSBParams, float, float]:
    """Fit the bridge from p0 (normal features) to p1 (anomalous) by the
    LightSB objective E_{x~p0}[log C(x)] - E_{y~p1}[log v(y)], Adam at
    ``lr``; the potentials' means start at samples of p1 and the batches are
    the JAX driver's numpy draws.  Returns (params, epsilon, the last
    step's objective, before its update)."""
    dim = feats0.shape[-1]
    params, eps = init_lightsb(generator, dim=dim, n_potentials=n_potentials, epsilon=epsilon)
    idx = np.random.RandomState(0).choice(len(feats1), n_potentials)
    params = init_r_by_samples(params, feats1[torch.as_tensor(idx, device=feats1.device)])
    params = LightSBParams(*(None if p is None else p.detach().clone().requires_grad_(True)
                             for p in params))
    opt = torch.optim.Adam([p for p in params if p is not None], lr=lr)
    rng = np.random.RandomState(1)
    draws = [(rng.choice(len(feats0), min(128, len(feats0)), replace=False),
              rng.choice(len(feats1), min(128, len(feats1)), replace=True))
             for _ in range(steps)]
    idx0 = torch.as_tensor(np.stack([d[0] for d in draws]), device=feats0.device)
    idx1 = torch.as_tensor(np.stack([d[1] for d in draws]), device=feats1.device)
    loss = torch.zeros(())
    for i in range(steps):
        loss = (get_log_C(params, eps, feats0[idx0[i]]).mean()
                - get_log_potential(params, eps, feats1[idx1[i]]).mean())
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    fitted = LightSBParams(*(None if p is None else p.detach() for p in params))
    return fitted, eps, float(loss.detach())


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--classname", required=True)
    p.add_argument("--know_class", default=None)
    p.add_argument("--nAnomaly", type=int, default=10)
    p.add_argument("--cont_rate", type=float, default=0.0)
    p.add_argument("--outlier_root", default=None)
    p.add_argument("--img_size", type=int, default=448)
    p.add_argument("--backbone", default="resnet18", choices=["resnet18", "resnet50"])
    p.add_argument("--batch_size", type=int, default=48)
    p.add_argument("--steps_per_epoch", type=int, default=20)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--lightsb", action="store_true", help="fit the bridge")
    p.add_argument("--sb_potentials", type=int, default=10)
    p.add_argument("--output", default="output/anomaly")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0, help="the trunk's initial weights")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> float:
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_ad: CUDA is not available (pass --device cpu to run on "
                           "the CPU)")
    logger = get_logger()
    logger.info(f"device {device}, f32; TF32 allowed in cuDNN convolutions "
                f"{torch.backends.cudnn.allow_tf32}, in matmuls "
                f"{torch.backends.cuda.matmul.allow_tf32}")

    cfg = ADConfig(dataset_root=args.dataset_root, classname=args.classname,
                   know_class=args.know_class, n_anomaly=args.nAnomaly,
                   cont_rate=args.cont_rate, img_size=args.img_size,
                   outlier_root=args.outlier_root)
    trainset = MVTecAD(cfg, train=True)
    testset = MVTecAD(cfg, train=False)
    logger.info(f"{args.classname}: train {len(trainset)} "
                f"({len(trainset.outlier_idx)} outliers), test {len(testset)}")

    model, optimizer = build(args.backbone, args.lr, device, args.seed)
    for epoch in range(args.epochs):
        t0, losses = time.time(), []
        for imgs, labels in balanced_batches(trainset, args.batch_size, args.steps_per_epoch,
                                             seed=10 + epoch):
            losses.append(train_step(model, optimizer, torch.from_numpy(imgs).to(device),
                                     torch.from_numpy(labels).to(device)))
        logger.info(f"epoch {epoch + 1}/{args.epochs} loss "
                    f"{float(torch.stack(losses).mean()):.4f} ({time.time() - t0:.1f}s)")

    scores, labels, feats = evaluate(model, testset, args.batch_size, device)
    roc = auroc(scores, labels)
    logger.info(f"deviation-score AUROC: {roc:.4f}")

    if args.lightsb:
        # the bridge between the training set's normal and known-anomaly features
        _, tr_labels, tr_feats = evaluate(model, trainset, args.batch_size, device)
        f0 = torch.from_numpy(tr_feats[tr_labels == 0]).to(device)
        f1 = torch.from_numpy(tr_feats[tr_labels > 0]).to(device)
        if len(f1) >= 2:
            sb_params, eps, sb_loss = fit_lightsb(
                f0, f1, torch.Generator(device).manual_seed(2),
                n_potentials=min(args.sb_potentials, len(f1)))
            logger.info(f"LightSB fitted (final objective {sb_loss:.4f})")
            with torch.no_grad():  # the bridge potential as an auxiliary anomaly score
                sb_score = get_log_potential(sb_params, eps,
                                             torch.from_numpy(feats).to(device)).cpu().numpy()
            roc_sb = auroc(sb_score, labels)
            roc_comb = auroc((scores - scores.mean()) / (scores.std() + 1e-8)
                             + (sb_score - sb_score.mean()) / (sb_score.std() + 1e-8), labels)
            logger.info(f"LightSB-potential AUROC: {roc_sb:.4f}  combined: {roc_comb:.4f}")

    path = os.path.join(args.output, f"{args.classname}_weights.msgpack")
    save_anomaly_weights(path, model.state_dict())
    logger.info(f"saved weights to {path}")
    return roc


if __name__ == "__main__":
    main()
