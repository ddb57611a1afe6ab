"""The tiny CMNeXt sliding-window slice under the r5 dispatch on both sides:
the JAX package with its Pallas kernels in interpret mode (v4 half-block +
fused tail at stages 0-1, v6 whole block at stages 2-3, rows DSCF at
levels 0-2, the einsum DSCF with the packed rpe kernel at level 3) against
the port's default, which runs the same dispatch with its kernels' plain
versions on the CPU.  f32, atol 2e-3 / rtol 1e-3 as
tests/test_swin_parity.py.
"""

import jax.numpy as jnp
import numpy as np
import torch

from ir_ads_tpu.evaluation.semseg_eval import make_sliding_window_fn as jax_sliding
from ir_ads_tpu.models.cmnext import CMNeXt as JaxCMNeXt
from ir_ads_tpu_torch.evaluation.semseg_eval import make_sliding_window_fn
from ir_ads_tpu_torch.models.cmnext import CMNeXt
from ir_ads_tpu_torch.utils.jax_params import from_flax
from test_torch_model import TINY, random_variables

# n = 2 x 4 offsets a field at every DSCF level (2n % 8 == 0): JAX's pallas3
# runs its rows kernels and meets the port's K3 + K4 (at 64x80, n = 6, both
# sides take the einsum branch: tests/test_torch_model.py)
H, W = 64, 112

R5_ENV = {
    "IR_ADS_SWIN_ATTN": "pallas4,pallas4,pallas6,pallas6",
    "IR_ADS_FFN": "fused",
    "IR_ADS_DSCF_ATTN": "pallas3,pallas3,pallas3,xla",
    "IR_ADS_DSCF_RPE3": "pallas",
    "IR_ADS_PALLAS_INTERPRET": "1",
}


def test_sliding_window_slice_matches_jax_r5(monkeypatch):
    for k, v in R5_ENV.items():
        monkeypatch.setenv(k, v)
    rng = np.random.RandomState(18)
    rgb = rng.randn(2, H, W, 3).astype(np.float32)
    dte = rng.randn(2, H, W, 3).astype(np.float32)
    model = JaxCMNeXt(backbone="SwinTransformer-B", num_classes=5,
                      backbone_kwargs=dict(TINY, drop_path_rate=0.0),
                      head_dims=(32, 16), mmst_mask=False, upsample_logits=False)
    v = random_variables(model, 19, jnp.asarray(rgb), jnp.asarray(dte))
    fwd = lambda r, d: model.apply(v, r, d, train=False)[0]  # noqa: E731
    want = np.asarray(jax_sliding(fwd, (H, W), (H, W), 5, overlap=1.0 / 3.0,
                                  flip=True, fuse=True)(jnp.asarray(rgb), jnp.asarray(dte)))

    port = CMNeXt(num_classes=5, backbone_kwargs=TINY, head_dims=(32, 16),
                  upsample_logits=False).eval()
    assert [blk.attn_impl for blk in (s.blocks[0] for s in port.backbone.stages)] == [
        "pallas4", "pallas4", "pallas6", "pallas6"]
    assert [m.deform_atten.attn_impl for m in port.backbone.DeformMPGBlocks] == [
        "pallas3", "pallas3", "pallas3", "xla"]
    port.load_state_dict(from_flax(v))
    predict = make_sliding_window_fn(lambda r, d: port(r, d)[0], (H, W), (H, W), 5)
    with torch.no_grad():
        got = predict(torch.from_numpy(rgb), torch.from_numpy(dte)).numpy()
    assert got.shape == (2, H, W, 5)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)
