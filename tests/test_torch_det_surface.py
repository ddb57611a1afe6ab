"""The rest of the detrex / detectron2 surface and the proxy depth, on the
CPU, against the JAX package and the root gen_depth.py:

  * ``ConditionalSelfAttention`` (with and without a mask),
    ``ConditionalCrossAttention`` (first layer and later ones) and
    ``PositionEmbeddingLearned`` against flax, their flax weights carried
    over by ``utils.jax_params.from_flax``, f32 at 2e-5;
  * ``transforms``, ``samplers`` and ``structures`` equal to the JAX
    package's on the same numpy generators, seeds and shard arguments:
    images, boxes, index streams and arrays bit for bit; the training
    stream's default shard from ``torch.distributed`` (rank 1 of 3
    reported) equal to JAX's with the same shard given;
  * ``gen_depth``'s proxy depth and colour map against the root
    ``gen_depth.proxy_depth`` / ``depth_to_cmap`` at 1e-6, and its entry
    point on a folder of PNGs against the root script's.

A few seconds in one process: three small flax inits.
"""

import itertools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ir_ads_tpu.detection import conditional_attn as jca
from ir_ads_tpu.detection import samplers as jsamplers
from ir_ads_tpu.detection import structures as jstructures
from ir_ads_tpu.detection import transforms as jtransforms
from ir_ads_tpu_torch import gen_depth as tdepth
from ir_ads_tpu_torch.detection import conditional_attn as tca
from ir_ads_tpu_torch.detection import samplers as tsamplers
from ir_ads_tpu_torch.detection import structures as tstructures
from ir_ads_tpu_torch.detection import transforms as ttransforms
from ir_ads_tpu_torch.utils.jax_params import from_flax

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import gen_depth as jdepth  # noqa: E402  (the root script, numpy only)

TOL = dict(atol=2e-5, rtol=2e-5)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carried(port, variables):
    port.load_state_dict(from_flax(_np(variables)), strict=True)
    return port


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# --------------------------------------------------------------------------
# conditional attention, learned position embedding
# --------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_conditional_self_attention_matches_flax(masked):
    rng = np.random.RandomState(1)
    q, pos = (rng.randn(2, 7, 32).astype(np.float32) for _ in range(2))
    mask = (rng.rand(7, 7) < 0.3) if masked else None
    mod = jca.ConditionalSelfAttention(32, 4)
    v = mod.init(jax.random.PRNGKey(0), jnp.asarray(q), jnp.asarray(pos))
    want = mod.apply(v, jnp.asarray(q), jnp.asarray(pos),
                     None if mask is None else jnp.asarray(mask))
    port = _carried(tca.ConditionalSelfAttention(32, 4), v)
    with torch.no_grad():
        got = port(*_t(q, pos), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("first", [True, False])
def test_conditional_cross_attention_matches_flax(first):
    rng = np.random.RandomState(2)
    q, q_pos, q_sine = (rng.randn(2, 5, 32).astype(np.float32) for _ in range(3))
    mem, mem_pos = (rng.randn(2, 9, 32).astype(np.float32) for _ in range(2))
    args = (q, mem, mem, q_pos, mem_pos, q_sine)
    mod = jca.ConditionalCrossAttention(32, 4)
    # initialised as a first layer, so that the tree holds query_pos_proj
    v = mod.init(jax.random.PRNGKey(0), *(jnp.asarray(a) for a in args), True)
    want = mod.apply(v, *(jnp.asarray(a) for a in args), first)
    port = _carried(tca.ConditionalCrossAttention(32, 4), v)
    with torch.no_grad():
        got = port(*_t(*args), first)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_position_embedding_learned_matches_flax():
    mod = jca.PositionEmbeddingLearned(num_pos_feats=16, max_size=12)
    v = mod.init(jax.random.PRNGKey(3), 7, 9)
    port = _carried(tca.PositionEmbeddingLearned(num_pos_feats=16, max_size=12), v)
    with torch.no_grad():
        got = port(7, 9)
    assert got.shape == (7, 9, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(mod.apply(v, 7, 9)))
    fresh = tca.PositionEmbeddingLearned(16, 12).row_embed
    assert 0.0 <= float(fresh.detach().min()) and float(fresh.detach().max()) < 1.0


# --------------------------------------------------------------------------
# host transforms
# --------------------------------------------------------------------------

def _image_and_boxes(seed, h=60, w=90):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    boxes = np.asarray([[3, 4, 40, 50], [10.5, 0, 89, 59]], np.float32)
    return img, boxes


@pytest.mark.parametrize("short,max_size", [(30, 1333), (100, 120), (45, 1333)])
def test_resize_shortest_edge_matches_jax(short, max_size):
    img, boxes = _image_and_boxes(4)
    got = ttransforms.resize_shortest_edge(img, boxes, short, max_size)
    want = jtransforms.resize_shortest_edge(img, boxes, short, max_size)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_random_flip_and_color_aug_match_jax_draw_for_draw():
    """Both sides of the flip's coin and every branch of the colour
    distortion over 24 seeds; the generators end in the same state."""
    flipped = set()
    for seed in range(24):
        img, boxes = _image_and_boxes(seed)
        rng_t, rng_j = np.random.default_rng(seed), np.random.default_rng(seed)
        got = ttransforms.random_flip(img, boxes, rng_t)
        want = jtransforms.random_flip(img, boxes, rng_j)
        flipped.add(got[0] is not img)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(ttransforms.color_aug_ssd(img, rng_t),
                                      jtransforms.color_aug_ssd(img, rng_j))
        assert rng_t.random() == rng_j.random()
    assert flipped == {True, False}


# --------------------------------------------------------------------------
# samplers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("shard", [(0, 1), (1, 3)])
def test_training_sampler_matches_jax(shuffle, shard):
    got = tsamplers.training_sampler(11, shuffle, 5, *shard)
    want = jsamplers.training_sampler(11, shuffle, 5, *shard)
    assert list(itertools.islice(got, 40)) == list(itertools.islice(want, 40))


def test_training_sampler_shard_from_torch_distributed(monkeypatch):
    """No process group: shard 0 of 1, JAX's process index and count on one
    host.  With one initialised (reported here: rank 1 of 3), its rank and
    world size, as JAX's stream with that shard given."""
    assert tsamplers.default_shard() == (0, 1)
    want = jsamplers.training_sampler(10, seed=2)
    assert (list(itertools.islice(tsamplers.training_sampler(10, seed=2), 25))
            == list(itertools.islice(want, 25)))
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 3)
    assert tsamplers.default_shard() == (1, 3)
    got = list(itertools.islice(tsamplers.training_sampler(10, seed=2), 25))
    assert got == list(itertools.islice(jsamplers.training_sampler(10, True, 2, 1, 3), 25))


def test_repeat_factor_and_inference_samplers_match_jax():
    anns = [[0], [0], [0, 1], [], [0, 2], [2]]
    for thresh in (0.001, 0.5, 0.9):
        got = tsamplers.repeat_factors_from_category_frequency(anns, 6, thresh)
        want = jsamplers.repeat_factors_from_category_frequency(anns, 6, thresh)
        np.testing.assert_array_equal(got, want)
    rf = jsamplers.repeat_factors_from_category_frequency(anns, 6, 0.9)
    for shuffle in (True, False):
        assert (list(itertools.islice(tsamplers.repeat_factor_sampler(rf, shuffle, 3), 60))
                == list(itertools.islice(jsamplers.repeat_factor_sampler(rf, shuffle, 3), 60)))
    for size, shard, n in ((10, 1, 2), (10, 2, 3), (7, 0, 4), (3, 3, 4)):
        assert (list(tsamplers.inference_sampler(size, shard, n))
                == list(jsamplers.inference_sampler(size, shard, n)))
    wide = [True, False, True, False, True, True, False, True]
    for batch in (1, 2, 3):
        assert (list(tsamplers.aspect_ratio_group_stream(iter(range(8)), wide, batch))
                == list(jsamplers.aspect_ratio_group_stream(iter(range(8)), wide, batch)))


# --------------------------------------------------------------------------
# structures
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,cap,with_masks", [(3, 5, True), (7, 4, False), (0, 2, True)])
def test_instances_match_jax(n, cap, with_masks):
    rng = np.random.RandomState(n)
    boxes = rng.rand(n, 4).astype(np.float32) * 50
    labels = rng.randint(0, 9, n)
    scores = rng.rand(n).astype(np.float32)
    masks = (rng.rand(n, 6, 8) > 0.5) if with_masks else None
    got = tstructures.instances_from_arrays(boxes, labels, scores, cap, masks)
    want = jstructures.instances_from_arrays(boxes, labels, scores, cap, masks)
    for g, w in ((got, want), (got.compact(), want.compact())):
        assert len(g) == len(w) == min(n, cap)
        for a, b in zip(g, w):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)
                assert a.dtype == b.dtype


@pytest.mark.parametrize("div", [32, 7, 1])
def test_image_list_matches_jax(div):
    rng = np.random.RandomState(div)
    images = [rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
              for h, w in ((20, 30), (33, 17), (5, 64))]
    for g, w in zip(tstructures.image_list_from(images, div),
                    jstructures.image_list_from(images, div)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


# --------------------------------------------------------------------------
# the proxy depth
# --------------------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(48, 64), (100, 37), (20, 20)])
def test_proxy_depth_and_cmap_match_the_root_script(h, w):
    img = np.random.RandomState(h).randint(0, 256, (h, w, 3)).astype(np.uint8)
    want = jdepth.proxy_depth(img)
    got = tdepth.proxy_depth(img, "cpu")
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    cmap = tdepth.depth_to_cmap(want).numpy()
    assert cmap.dtype == np.uint8
    np.testing.assert_allclose(cmap, jdepth.depth_to_cmap(want), atol=1e-6, rtol=0)


def test_gen_depth_entry_point_matches_the_root_script(tmp_path, monkeypatch):
    from PIL import Image

    src = tmp_path / "imgs"
    src.mkdir()
    rng = np.random.RandomState(7)
    for name, (h, w) in (("a", (40, 56)), ("b", (33, 64))):
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(src / f"{name}.png")
    (src / "notes.txt").write_text("skipped")
    out = tmp_path / "depth"
    assert tdepth.main(["--input", str(src), "--output", str(out), "--proxy", "--cmap",
                        "--device", "cpu"]) == 0
    monkeypatch.setattr(sys, "argv", ["gen_depth.py", "--input", str(src), "--output",
                                      str(tmp_path / "ref"), "--proxy", "--cmap"])
    jdepth.main()
    assert sorted(p.name for p in out.iterdir()) == ["a.npy", "b.npy"]
    for stem in ("a", "b"):
        np.testing.assert_allclose(np.load(out / f"{stem}.npy"),
                                   np.load(tmp_path / "ref" / f"{stem}.npy"), atol=1e-6, rtol=0)
        # the depths agree to 1e-6, so a colour level truncated to uint8
        # may sit one step apart (test_proxy_depth_and_cmap_match_the_root_script
        # holds the map itself on equal depths)
        got = np.asarray(Image.open(tmp_path / "depth_cmap" / f"{stem}.png")).astype(int)
        want = np.asarray(Image.open(tmp_path / "ref_cmap" / f"{stem}.png")).astype(int)
        assert np.abs(got - want).max() <= 1
    with pytest.raises(SystemExit, match="--proxy"):
        tdepth.main(["--input", str(src), "--output", str(out)])
