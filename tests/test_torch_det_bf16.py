"""The detector in bf16 against the JAX package's ``dtype=jnp.bfloat16``
DINO, on the CPU, before the top-k proposal selection (encoder memory,
proposal scores; everything after the selection is discontinuous).

flax normalises in f32 with f32 scale, bias and statistics and rounds once;
the port keeps those parameters f32 (``serve.cast_model_``: the frozen BNs,
the GroupNorms, the LayerNorms, the mask head's BN) and computes as flax
does (``ops.layers``).  BN running means are drawn around +-3, as trained
ones can be.  Measured on this file's inputs, relative norm distance from
JAX bf16 (op by op) with every parameter rounded (the earlier rule) / with
flax's rule / with the biases also added to the rounded products as flax
adds them (``ops.layers.with_bias``): encoder memory 2.142e-2 / 1.118e-2 /
1.016e-2 (bar 1.6e-2), proposal scores 1.101e-2 / 6.315e-3 / 4.999e-3 (bar
8.5e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ir_ads_tpu.detection import dino as jdino
from ir_ads_tpu.detection.transformer import make_output_proposals
from ir_ads_tpu_torch.detection.dino import DINODetector
from ir_ads_tpu_torch.serve import cast_model_
from ir_ads_tpu_torch.utils.jax_params import dino_from_flax
from test_torch_bf16 import BF16, _means_at_3, _rel
from test_torch_det_model import SHAPES, TINY as DET_TINY, _image
from test_torch_model import random_variables


def test_dino_bf16_matches_jax_bf16_before_the_selection():
    image = _image()
    model = jdino.DINODetector(**DET_TINY)
    v = random_variables(model, 41, jnp.asarray(image))
    v["params"] = jax.tree_util.tree_map_with_path(
        lambda path, a: a / 0.05 / np.sqrt(np.prod(a.shape[:-1]))
        if path[-1].key == "kernel" else a, v["params"])
    for name in ("level_embeds", "tgt_embed"):
        v["params"]["transformer"][name] = v["params"]["transformer"][name] * 10
    v = _means_at_3(v, 53)
    valid = make_output_proposals(SHAPES)[1]
    _, state = jdino.DINODetector(**DET_TINY, dtype=jnp.bfloat16).apply(
        v, jnp.asarray(image), train=False, capture_intermediates=True,
        mutable=["intermediates"])
    inter = state["intermediates"]["transformer"]
    memory = inter[f"encoder_{DET_TINY['num_encoder_layers'] - 1}"]["__call__"][0]
    enc_class = inter[f"class_embed_{DET_TINY['num_decoder_layers']}"]["__call__"][0]
    scores = np.where(valid[None], np.asarray(enc_class, np.float32).max(-1), 0.0)

    port = DINODetector(**DET_TINY)
    port.load_state_dict(dino_from_flax(v))
    cast_model_(port.eval(), BF16)
    seen = {}
    hook = port.transformer.register_forward_hook(lambda mod, args, out: seen.update(out))
    with torch.no_grad():
        port(torch.from_numpy(image))
    hook.remove()
    assert seen["memory"].dtype == BF16
    got_scores = np.where(valid[None], seen["enc_scores"].float().numpy(), 0.0)
    print(f"memory {_rel(seen['memory'].float().numpy(), memory):.3e}, "
          f"scores {_rel(got_scores, scores):.3e}")
    assert _rel(seen["memory"].float().numpy(), memory) <= 1.6e-2
    assert _rel(got_scores, scores) <= 8.5e-3
