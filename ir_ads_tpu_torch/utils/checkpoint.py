"""Read the JAX package's ``weights.msgpack`` (ir_ads_tpu/utils/checkpoint.py
``save_weights``) without flax.

The file is flax's msgpack state dict: nested maps of string keys, each
array an ext type 1 whose payload is itself msgpack of (shape, dtype name,
C-order bytes); ext type 3 is a numpy scalar in the same form.
``load_weights`` returns the ``{"params", "batch_stats"}`` tree as numpy
arrays (bfloat16 leaves widened to float32, which is exact), ready for
``utils.jax_params.from_flax``.  flax splits arrays over 2^30 bytes into a
chunked form (``__msgpack_chunked_array__``); no CMNeXt leaf is that large,
and the reader raises on it rather than misread it.  Writing waits for the
port's training entry point.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

_NDARRAY, _COMPLEX, _NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


def _array(data: bytes) -> np.ndarray:
    import msgpack

    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    name = dtype_name.decode()
    if name == "bfloat16":  # the upper half of an f32
        bits = np.frombuffer(buffer, dtype=np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape).copy()


def _ext_hook(code: int, data: bytes):
    import msgpack

    if code == _NDARRAY:
        return _array(data)
    if code == _NPSCALAR:
        return _array(data)[()]
    if code == _COMPLEX:
        re, im = msgpack.unpackb(data)
        return complex(re, im)
    raise ValueError(f"load_weights: unknown msgpack ext type {code}")


def _check_unchunked(tree, path=()) -> None:
    if isinstance(tree, dict):
        if CHUNKED in tree:
            raise NotImplementedError(
                f"load_weights: {'/'.join(path)} is in flax's chunked-array form "
                "(a leaf over 2^30 bytes), which this reader does not take")
        for k, v in tree.items():
            _check_unchunked(v, path + (str(k),))


def load_weights(path: str) -> Dict[str, Any]:
    """``path``: a weights.msgpack file, or a checkpoint directory holding
    one.  Returns {"params": ..., "batch_stats": ...} as numpy."""
    import msgpack

    if os.path.isdir(path):
        path = os.path.join(path, "weights.msgpack")
    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    _check_unchunked(tree)
    missing = {"params", "batch_stats"} - set(tree)
    if missing:
        raise ValueError(f"load_weights: {path} has no {sorted(missing)}")
    return {"params": tree["params"], "batch_stats": tree["batch_stats"]}
