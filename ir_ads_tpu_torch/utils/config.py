"""YAML config loading: ``load_config(path)`` merges a configs/*.yaml file
over ``DEFAULTS``.  Counterpart of ir_ads_tpu/utils/config.py, with the same
defaults and the same merge, so that a config gives the same dict through
either package.  The port reads no ``DEVICE`` key: device, dispatch and
workers are arguments of its entry points.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

DEFAULTS: Dict[str, Any] = {
    "DEVICE": "tpu",
    "SAVE_DIR": "output",
    "MODEL": {
        "NAME": "CMNeXt",
        "BACKBONE": "SwinTransformer-B",
        "PRETRAINED": "",
        "RESUME": "",
    },
    "DATASET": {
        "NAME": "NYU",
        "ROOT": "data/NYUDepthv2",
        "IGNORE_LABEL": 255,
        "MODALS": ["img", "depth"],
    },
    "TRAIN": {
        "IMAGE_SIZE": [480, 640],
        "BATCH_SIZE": 4,
        "EPOCHS": 400,
        "EVAL_START": 200,
        "EVAL_INTERVAL": 1,
        "AMP": True,  # bf16 compute
        "DDP": False,
    },
    "LOSS": {"NAME": "CrossEntropy", "CLS_WEIGHTS": False},
    "OPTIMIZER": {
        "NAME": "adamw",
        "LR": 4e-4,
        "WEIGHT_DECAY": 0.01,
        "TRAIN_TYPE": "Adapter",
    },
    "SCHEDULER": {
        "NAME": "warmuppolylr",
        "POWER": 0.9,
        "WARMUP": 10,
        "WARMUP_RATIO": 0.1,
    },
    "EVAL": {
        "MODEL_PATH": "",
        "IMAGE_SIZE": [480, 640],
        "BATCH_SIZE": 1,
        "MSF": {
            "ENABLE": False,
            "FLIP": True,
            "SCALES": [0.5, 0.75, 1.0, 1.25, 1.5, 1.75],
        },
    },
}


def _merge(base: Dict, override: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in (override or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        user = yaml.safe_load(f) or {}
    return _merge(DEFAULTS, user)
