"""Checkpoints in the JAX package's form (ir_ads_tpu/utils/checkpoint.py),
read and written without flax, so that either package resumes the other's.

A checkpoint is a directory: ``weights.msgpack`` ({"params", "batch_stats"},
what inference needs), ``train_state.msgpack`` ({"opt_state", "step"}) and
``manifest.json`` ({"best_miou", "epoch", "config"}).  The msgpack files are
flax's state dicts: nested maps of string keys, each array an ext type 1
whose payload is itself msgpack of (shape, dtype name, C-order bytes); ext
type 3 is a numpy scalar in the same form.  ``load_weights`` returns the
``{"params", "batch_stats"}`` tree as numpy arrays (bfloat16 leaves widened
to float32, which is exact), ready for ``utils.jax_params.from_flax``.
flax splits arrays over 2^30 bytes into a chunked form
(``__msgpack_chunked_array__``); no CMNeXt leaf is that large, and the
reader and the writer raise on it rather than misread or miswrite it.

``opt_state`` is the tree that ``flax.serialization.to_state_dict`` makes of
the optax state that the JAX ``get_optimizer`` builds, for AdamW or SGD,
``TRAIN_TYPE`` Adapter or all, with or without ``grad_clip_norm``
(``opt_state_tree``): a chain is a map "0", "1", ...; ``optax.masked``
wraps its state as {"inner_state": ...} and stands a frozen leaf's moment
in as an empty map; AdamW's moments are ``mu`` and ``nu`` (torch's
``exp_avg`` and ``exp_avg_sq``) beside their ``count`` (torch's ``step``),
SGD's momentum is ``trace`` (torch's ``momentum_buffer``), and the
schedule's state is its own ``count``.  The reader holds a checkpoint to
the form the run's recipe gives and raises on any other.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

_NDARRAY, _COMPLEX, _NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


CHUNK_BYTES = 2 ** 30  # flax chunks arrays larger than this


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


def _read(path: str) -> Dict[str, Any]:
    import msgpack

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=_ext_hook, raw=False)
    _check_unchunked(tree)
    return tree


def _ext_pack(obj):
    import msgpack

    def payload(arr: np.ndarray) -> bytes:
        if arr.nbytes > CHUNK_BYTES:
            raise NotImplementedError("checkpoint: an array over 2^30 bytes needs flax's "
                                      "chunked form, which this writer does not make")
        return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes("C")), use_bin_type=True)

    if isinstance(obj, np.ndarray):
        return msgpack.ExtType(_NDARRAY, payload(obj))
    if isinstance(obj, np.generic):
        return msgpack.ExtType(_NPSCALAR, payload(np.asarray(obj)))
    raise TypeError(f"checkpoint: cannot write {type(obj).__name__}")


def _write(path: str, tree: Dict[str, Any]) -> int:
    """flax's ``to_bytes`` form of a tree of dicts and numpy arrays; returns
    the bytes written."""
    import msgpack

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    data = msgpack.packb(tree, default=_ext_pack, strict_types=True)
    with open(path, "wb") as f:
        f.write(data)
    return len(data)


def load_weights(path: str) -> Dict[str, Any]:
    """``path``: a weights.msgpack file, or a checkpoint directory holding
    one.  Returns {"params": ..., "batch_stats": ...} as numpy."""
    if os.path.isdir(path):
        path = os.path.join(path, "weights.msgpack")
    tree = _read(path)
    missing = {"params", "batch_stats"} - set(tree)
    if missing:
        raise ValueError(f"load_weights: {path} has no {sorted(missing)}")
    return {"params": tree["params"], "batch_stats": tree["batch_stats"]}


def save_weights(path: str, state_dict: Dict[str, torch.Tensor]) -> int:
    """The port's state_dict as the JAX package's weights.msgpack
    (``to_flax``); returns the bytes written."""
    from ir_ads_tpu_torch.utils.jax_params import to_flax

    return _write(path, to_flax(state_dict))


def save_dino_weights(path: str, state_dict: Dict[str, torch.Tensor]) -> int:
    """A ``DINODetector`` state_dict as the JAX package's weights.msgpack
    (``dino_to_flax``, the unrolled transformer layout, which the JAX
    train_net's template has); returns the bytes written."""
    from ir_ads_tpu_torch.utils.jax_params import dino_to_flax

    return _write(path, dino_to_flax(state_dict))


def load_dino_weights(path: str) -> Dict[str, torch.Tensor]:
    """A detector's weights.msgpack (either transformer layout) as the
    port's state_dict."""
    from ir_ads_tpu_torch.utils.jax_params import dino_from_flax

    return dino_from_flax(load_weights(path))


def save_anomaly_weights(path: str, state_dict: Dict[str, torch.Tensor]) -> int:
    """An ``AnomalyScoreNet`` state_dict as the file the JAX train_ad's
    ``save_weights(path, params, batch_stats)`` writes (``anomaly_to_flax``);
    returns the bytes written."""
    from ir_ads_tpu_torch.utils.jax_params import anomaly_to_flax

    return _write(path, anomaly_to_flax(state_dict))


def load_anomaly_weights(path: str) -> Dict[str, torch.Tensor]:
    """An anomaly weights file of either package as the port's
    ``AnomalyScoreNet`` state_dict."""
    from ir_ads_tpu_torch.utils.jax_params import anomaly_from_flax

    return anomaly_from_flax(load_weights(path))


# --------------------------------------------------------------------------
# optax's state tree
# --------------------------------------------------------------------------

OPTIMIZERS = ("adamw", "sgd")
MOMENTS = {"adamw": {"mu": "exp_avg", "nu": "exp_avg_sq"}, "sgd": {"trace": "momentum_buffer"}}


def _moment_tree(state, key: Optional[str]) -> Dict:
    """A moment of every trainable parameter as a flax params tree (zeros
    where the optimizer holds none yet, and throughout for ``key`` None), a
    frozen leaf as the empty map ``optax.masked`` leaves."""
    from ir_ads_tpu_torch.utils.jax_params import to_flax

    opt_state = state.optimizer.state
    values = {}
    for n, p in state.model.named_parameters():
        if not p.requires_grad:  # an empty array of the leaf's rank marks it
            values[n] = torch.empty((0,) * p.ndim)
            continue
        t = opt_state.get(p, {}).get(key) if key else None
        values[n] = torch.zeros_like(p) if t is None else t

    def masked(tree):
        return {k: masked(v) if isinstance(v, dict) else (v if v.size else {})
                for k, v in tree.items()}

    return masked(to_flax(values)["params"])


def opt_state_tree(state, zeros: bool = False) -> Dict:
    """``to_state_dict`` of the optax state of ``state``'s recipe
    (``state.optimizer_name``, ``train_type``, ``grad_clip_norm``), filled
    from its torch optimizer, or with zeros."""
    name = state.optimizer_name
    if name not in OPTIMIZERS:
        raise NotImplementedError(f"checkpoint: optimizer {name!r}: the JAX package "
                                  f"builds {OPTIMIZERS}")
    count = np.asarray(0 if zeros else state.step, np.int32)
    moments = {k: _moment_tree(state, None if zeros else v) for k, v in MOMENTS[name].items()}
    if name == "adamw":  # chain(scale_by_adam, masked(add_decayed_weights), schedule)
        inner = {"0": {"count": count, **moments}, "1": {"inner_state": {}},
                 "2": {"count": count}}
    else:  # chain(add_decayed_weights, chain(trace, schedule))
        inner = {"0": {}, "1": {"0": moments, "1": {"count": count}}}
    if state.grad_clip_norm is not None:  # chain(clip_by_global_norm, tx)
        inner = {"0": {}, "1": inner}
    if "Adapter" in state.train_type:  # chain(masked(tx), masked(set_to_zero))
        return {"0": {"inner_state": inner}, "1": {"inner_state": {}}}
    return inner


def _same_form(got, want, path="opt_state") -> None:
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            have = sorted(got) if isinstance(got, dict) else type(got).__name__
            raise ValueError(f"checkpoint: {path} has {have}, the run's optimizer "
                             f"{sorted(want)}")
        for k in want:
            _same_form(got[k], want[k], f"{path}/{k}")
    elif np.shape(got) != np.shape(want):
        raise ValueError(f"checkpoint: {path} is {np.shape(got)}, the run's optimizer "
                         f"holds {np.shape(want)}")


def _moments_in(tree: Dict, state) -> Dict:
    """The map that holds the moments in an ``opt_state_tree`` of
    ``state``'s recipe (AdamW's also holds its count)."""
    if "Adapter" in state.train_type:
        tree = tree["0"]["inner_state"]
    if state.grad_clip_norm is not None:
        tree = tree["1"]
    return tree["0"] if state.optimizer_name == "adamw" else tree["1"]["0"]


def save_checkpoint(directory: str, state, best_miou: float = 0.0, epoch: int = 0,
                    extra: Optional[Dict] = None) -> int:
    """The JAX package's checkpoint directory of a ``TrainState``; returns
    the bytes written."""
    os.makedirs(directory, exist_ok=True)
    n = save_weights(os.path.join(directory, "weights.msgpack"), state.model.state_dict())
    n += _write(os.path.join(directory, "train_state.msgpack"),
                {"opt_state": opt_state_tree(state), "step": np.asarray(state.step, np.int32)})
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump({"best_miou": best_miou, "epoch": epoch, **(extra or {})}, f)
    return n


def load_checkpoint(directory: str, state) -> Dict:
    """Restore a ``TrainState`` in place from a checkpoint directory of
    either package: the weights and statistics, the optimizer's moments and
    count, the step.  Returns the manifest."""
    from ir_ads_tpu_torch.utils.jax_params import from_flax

    state.model.load_state_dict(from_flax(load_weights(directory)))
    train = _read(os.path.join(directory, "train_state.msgpack"))
    want = opt_state_tree(state, zeros=True)
    _same_form(train["opt_state"], want)
    name = state.optimizer_name
    core = _moments_in(train["opt_state"], state)
    params = {n: p for n, p in state.model.named_parameters() if p.requires_grad}
    moments = {torch_key: from_flax({"params": core[k]}) for k, torch_key in MOMENTS[name].items()}
    opt = state.optimizer
    for n, p in params.items():
        st = {key: m[n].to(device=p.device, dtype=p.dtype) for key, m in moments.items()}
        if name == "adamw":
            st["step"] = torch.tensor(float(core["count"]), dtype=torch.float32)
        opt.state[p] = st
    state.step = int(train["step"])
    with open(os.path.join(directory, "manifest.json")) as f:
        return json.load(f)
