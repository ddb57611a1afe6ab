"""The port's spatially sharded eval (parallel/halo.py,
evaluation/semseg_eval.make_spatial_sharded_forward, val_mm's
EVAL.SPATIAL_SHARD) against the JAX package's ``spatial_shard_apply`` on
the 8-device CPU mesh of tests/conftest.py, for n = 1, 2 and 4 strips: the
shifted-window model of tests/test_spatial_shard_eval.py and the tiny
CMNeXt of tests/test_torch_model.py at one block a stage, weights through
from_flax.  The port runs its strips one after another on the CPU, the
same function as the mesh's.  The JAX forwards are jitted at XLA's backend
optimisation level 0 (the same f32 function)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from ir_ads_tpu.evaluation.semseg_eval import (
    make_spatial_sharded_forward as jax_sharded_forward,
)
from ir_ads_tpu.models.cmnext import CMNeXt as JaxCMNeXt
from ir_ads_tpu.parallel.mesh import make_mesh
from ir_ads_tpu_torch import val_mm
from ir_ads_tpu_torch.data.loader import DataLoader
from ir_ads_tpu_torch.evaluation.semseg_eval import make_forward_fn, make_spatial_sharded_forward
from ir_ads_tpu_torch.models.backbones.swin import SwinStage
from ir_ads_tpu_torch.models.cmnext import CMNeXt
from ir_ads_tpu_torch.ops.layers import Conv, PatchEmbed, resize_bilinear
from ir_ads_tpu_torch.parallel.halo import halo_exchange, spatial_shard_apply
from ir_ads_tpu_torch.utils.config import load_config
from ir_ads_tpu_torch.utils.jax_params import from_flax, to_flax
from tests.conftest import requires_devices
from tests.test_spatial_shard_eval import _TinySwinSeg
from tests.test_torch_heads import FAST_COMPILE, close
from tests.test_torch_mit import fill_variables
from tests.test_torch_model import TINY, random_variables

N_STRIPS = [1, 2, 4]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_sharded(apply, variables, n, halo, *mods):
    """JAX's sharded forward over an n-device ``space`` mesh, jitted with
    the variables as an argument (closed over, they would be traced into
    the program as constants)."""
    mesh = make_mesh(data=1, space=n, devices=jax.devices()[:n])

    def predict(v, *m):
        return jax_sharded_forward(lambda packed: apply(v, packed), mesh, halo)(*m)

    return np.asarray(jax.jit(predict, compiler_options=FAST_COMPILE)(variables, *mods))


class TinySwinSeg(nn.Module):
    """The port's _TinySwinSeg: patch embedding, one shifted-window Swin
    stage of two blocks, a 1x1 classifier, upsampled to the input."""

    def __init__(self):
        super().__init__()
        self.patch_embed = PatchEmbed(16, 4, in_chans=6)
        self.stages = nn.ModuleList([SwinStage(16, 2, 2, 4, False, mlp_ratio=2.0)])
        self.head = Conv(16, 5, 1)

    def forward(self, x):
        y, _ = self.stages[0](self.patch_embed(x), "rgb")
        return resize_bilinear(self.head(y), x.shape[1:3], align_corners=False)


@pytest.fixture(scope="module")
def tiny_swin():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (1, 128, 32, 6)))
    model = _TinySwinSeg()
    v = random_variables(model, 1, jnp.asarray(x))
    port = TinySwinSeg().eval()
    p = v["params"]
    missing, unexpected = port.load_state_dict(from_flax({"params": {
        "patch_embed": p["pe"], "stages_0": p["stage"], "head": p["head"]}}), strict=False)
    assert not unexpected and all(".MLP_DTE_Adapter." in k for k in missing)  # rgb only
    return model, v, port, x


@requires_devices(4)
@pytest.mark.parametrize("n", N_STRIPS)
def test_sharded_swin_matches_jax(tiny_swin, n):
    model, v, port, x = tiny_swin
    halo = 32  # the strips of n = 4 are 32 rows
    want = _jax_sharded(model.apply, v, n, halo, jnp.asarray(x[..., :3]), jnp.asarray(x[..., 3:]))
    with torch.no_grad():
        got = make_spatial_sharded_forward(port, n, halo)(
            torch.from_numpy(x[..., :3].copy()), torch.from_numpy(x[..., 3:].copy()))
    assert tuple(got.shape) == want.shape == (1, 128, 32, 5)
    close(got, want)


H, W = 64, 64
SHARD_TINY = dict(TINY, depths=(1, 1, 1, 1))  # one block a stage: _TinySwinSeg shifts


@pytest.fixture(scope="module")
def tiny_cmnext():
    rng = np.random.RandomState(12)
    rgb = rng.randn(1, H, W, 3).astype(np.float32)
    dte = rng.randn(1, H, W, 3).astype(np.float32)
    model = JaxCMNeXt(backbone="SwinTransformer-B", num_classes=5,
                      backbone_kwargs=dict(SHARD_TINY, drop_path_rate=0.0),
                      head_dims=(32, 16), mmst_mask=False)
    port = CMNeXt(num_classes=5, backbone_kwargs=SHARD_TINY, head_dims=(32, 16)).eval()
    # values in the port's tree carried to flax's: no JAX trace for the shapes
    v = fill_variables(to_flax(port.state_dict()), 13)
    port.load_state_dict(from_flax(v))
    return model, v, port, rgb, dte


def _cmnext_apply(model):
    def apply(v, packed):
        rgb, dte = jnp.split(packed, 2, axis=-1)
        return model.apply(v, rgb, dte, train=False)[0]

    return apply


@requires_devices(4)
@pytest.mark.parametrize("n", N_STRIPS)
def test_sharded_cmnext_matches_jax(tiny_cmnext, n):
    """Strips of 64 / n rows with a halo of 16: the DSCF's tile
    equivalence, strip by strip, on both sides."""
    model, v, port, rgb, dte = tiny_cmnext
    halo = 16
    want = _jax_sharded(_cmnext_apply(model), v, n, halo, jnp.asarray(rgb), jnp.asarray(dte))

    def forward(packed):
        return port(*packed.chunk(2, -1))[0]

    with torch.no_grad():
        got = make_spatial_sharded_forward(forward, n, halo)(torch.from_numpy(rgb),
                                                             torch.from_numpy(dte))
    assert tuple(got.shape) == want.shape == (1, H, W, 5)
    close(got, want)


def test_halo_exchange_rows():
    """Each strip gets its neighbours' rows, zeros past the image; the
    bounds JAX refuses are refused."""
    x = torch.arange(2 * 12 * 3, dtype=torch.float32).reshape(2, 12, 3, 1)
    strips = halo_exchange(list(x.chunk(3, 1)), 2)
    assert all(tuple(s.shape) == (2, 8, 3, 1) for s in strips)
    assert torch.equal(strips[1], x[:, 2:10])
    assert torch.equal(strips[0][:, :2], torch.zeros(2, 2, 3, 1))
    assert torch.equal(strips[2][:, 6:], torch.zeros(2, 2, 3, 1))
    with pytest.raises(ValueError, match="exceeds the local shard height"):
        halo_exchange(list(x.chunk(3, 1)), 5)
    with pytest.raises(ValueError, match="does not divide"):
        spatial_shard_apply(lambda t: t, 5, 1)(x)
    for devices in (["cpu"] * 2, ["cpu"] * 4):  # one device a strip, or a raise
        with pytest.raises(ValueError, match="give one a strip"):
            spatial_shard_apply(lambda t: t, 3, 1, devices)
    assert torch.equal(spatial_shard_apply(lambda t: t, 3, 2, ["cpu"] * 3)(x), x)


@requires_devices(4)
def test_jax_refuses_what_the_port_refuses():
    x = jnp.zeros((1, 12, 4, 2))
    mesh = make_mesh(data=1, space=4, devices=jax.devices()[:4])
    with pytest.raises(ValueError):
        jax_sharded_forward(lambda t: t, mesh, 5)(x)
    with pytest.raises(AssertionError):
        jax_sharded_forward(lambda t: t, make_mesh(data=1, space=5, devices=jax.devices()[:5]),
                            1)(x)


def keep_sharded_logits(monkeypatch):
    """The list that each batch's logits of val_mm's sharded eval are
    appended to, its ``make_spatial_forward`` wrapped."""
    kept, make = [], val_mm.make_spatial_forward

    def keeping(*args, **kw):
        predict = make(*args, **kw)

        def run(rgb, dte):
            kept.append(predict(rgb, dte))
            return kept[-1]
        return run

    monkeypatch.setattr(val_mm, "make_spatial_forward", keeping)
    return kept


def test_val_mm_spatial_shard_on_the_cpu(monkeypatch):
    """``val_mm.main`` with EVAL.SPATIAL_SHARD at configs/synthetic_smoke.yaml:
    one strip (one CPU), its logits those of the sharded forward and of the
    model on the zero-padded image cropped back (tile equivalence)."""
    cfg = load_config("configs/synthetic_smoke.yaml")
    cfg["EVAL"]["SPATIAL_SHARD"] = {"ENABLE": True, "HALO": 16}
    kept = keep_sharded_logits(monkeypatch)
    out = val_mm.main(cfg, device="cpu")
    assert out["mode"] == "spatial_shard" and np.isfinite(out["miou"])
    dataset, _ = val_mm._val_dataset(cfg)
    model = val_mm.build_eval_model(cfg, dataset.n_classes, "cpu")
    forward = make_forward_fn(model)
    loader = DataLoader(dataset, cfg["EVAL"]["BATCH_SIZE"], shuffle=False, drop_last=False)
    assert len(kept) == len(loader)
    for got, b in zip(kept, loader):
        rgb, dte = torch.from_numpy(b[0]), torch.from_numpy(b[1])
        pad = (0, 0, 0, 0, 16, 16)
        want = forward(torch.nn.functional.pad(rgb, pad), torch.nn.functional.pad(dte, pad))
        want = resize_bilinear(want, (H + 32, W), align_corners=False)[:, 16:-16]
        assert torch.equal(got, want)
        sharded = val_mm.make_spatial_forward(model, False, 16, [torch.device("cpu")])
        assert torch.equal(got, sharded(rgb, dte))
