"""The port's data modules against the JAX package's, on synthesized trees:
each of the seven dataset layouts (PNG and JPEG written here) and
``Synthetic`` give bit-equal samples and labels through the val transform
at a size that resamples; the loaders give equal batches with shuffle and
drop_last on and off (process workers once, in a process without JAX); a
``RawCache`` built by either package opens in the other with equal arrays;
``load_weights`` reads flax's msgpack bit for bit, bfloat16 leaves
included, and refuses the chunked form.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization
from PIL import Image

from ir_ads_tpu.data import augmentations as jaug
from ir_ads_tpu.data import cache as jcache
from ir_ads_tpu.data import datasets as jds
from ir_ads_tpu.data import loader as jloader
from ir_ads_tpu.utils.checkpoint import save_weights
from ir_ads_tpu_torch.data import augmentations as taug
from ir_ads_tpu_torch.data import cache as tcache
from ir_ads_tpu_torch.data import datasets as tds
from ir_ads_tpu_torch.data import loader as tloader
from ir_ads_tpu_torch.utils.checkpoint import load_weights

ROOT = Path(__file__).resolve().parent.parent
H, W = 40, 60
SIZE = (48, 64)  # short side 40 -> 48, then 48x72 -> 64x96: two resamples


def _img(rng, h=H, w=W, c=3):
    return rng.randint(0, 256, (h, w, c)).astype(np.uint8)


def _save(path, arr):
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)


def _label(rng, n, void=True, h=H, w=W):
    lbl = rng.randint(0, n + 1 if void else n, (h, w)).astype(np.uint8)
    if void:
        lbl[rng.rand(h, w) < 0.05] = 255
    return lbl


def _split(root, name, names):
    (root / name).parent.mkdir(parents=True, exist_ok=True)
    (root / name).write_text("\n".join(names) + "\n")


def _tree(kind, root, rng):
    """Two val samples in ``kind``'s layout; returns (modals, kwargs)."""
    names = ["a_01", "b_02"]
    if kind == "NYU":
        for n in names:
            _save(root / "RGB" / f"{n}.jpg", _img(rng))
            _save(root / "HHA" / f"{n}.jpg", _img(rng))
            _save(root / "Label" / f"{n}.png", _label(rng, 40))
        _split(root, "test.txt", names)
        return ["img", "depth"], {}
    if kind == "SUN":
        for n in names:
            _save(root / "RGB" / f"{n}.jpg", _img(rng))
            _save(root / "Depth" / f"{n}.png", _img(rng))
            _save(root / "labels" / f"{n}.png", _label(rng, 37))
        _split(root, "test.txt", names)
        return ["img", "depth"], {}
    if kind == "MFNet":
        for n in names:
            _save(root / "rgb" / f"{n}.png", _img(rng))
            _save(root / "ther" / f"{n}.png", _img(rng)[..., 0])
            _save(root / "labels" / f"{n}.png", _label(rng, 9, void=False))
        _split(root, "test.txt", names)
        return ["img", "thermal"], {}
    if kind == "PST":
        for n in names:
            _save(root / "test" / "rgb" / f"{n}.png", _img(rng))
            _save(root / "test" / "thermal" / f"{n}.png", _img(rng, c=4))
            _save(root / "test" / "labels" / f"{n}.png", _label(rng, 5, void=False))
        return ["img", "thermal"], {}
    if kind == "DELIVER":
        for i, n in enumerate(names):
            base = Path("cloud" if i else "fog") / "val" / "seq0"
            _save(root / "img" / base / f"{n}_rgb.png", _img(rng))
            _save(root / "hha" / base / f"{n}_depth.png", _img(rng))
            _save(root / "lidar" / base / f"{n}_lidar.png", _img(rng))
            _save(root / "event" / base / f"{n}_event.png", _img(rng, 20, 30))  # resized
            _save(root / "semantic" / base / f"{n}_semantic.png", _label(rng, 25))
        return ["img", "depth", "event", "lidar"], {}
    if kind == "DeepCrack":
        for n in names:
            _save(root / "val_img" / f"{n}.jpg", _img(rng))
            _save(root / "val_lab" / f"{n}.png", (_label(rng, 1, void=False) * 255).astype(np.uint8))
        return ["img", "depth"], {}
    if kind == "MCubeS":
        w = W + 192  # the left crop
        for n in names:
            (root / "polL_color").mkdir(parents=True, exist_ok=True)
            Image.fromarray(rng.randint(0, 65536, (H, w)).astype(np.uint16)).save(
                root / "polL_color" / f"{n}.png")
            for sub in ("polL_aolp_sin", "polL_aolp_cos", "polL_dolp"):
                (root / sub).mkdir(parents=True, exist_ok=True)
                np.save(root / sub / f"{n}.npy", rng.uniform(-1, 1, (H, w)).astype(np.float32))
            (root / "NIR_warped").mkdir(parents=True, exist_ok=True)
            Image.fromarray(rng.randint(0, 65536, (H, w)).astype(np.uint16)).save(
                root / "NIR_warped" / f"{n}.png")
            _save(root / "GT" / f"{n}.png", _label(rng, 20, h=H, w=w))
        _split(root, "list_folder/val.txt", names)
        return ["img", "aolp", "dolp", "nir"], {}
    return ["img", "depth"], dict(length=3, image_size=(H, W), num_classes=6)


@pytest.mark.parametrize("kind", sorted(tds.DATASETS))
def test_dataset_matches_jax(kind, tmp_path):
    modals, kw = _tree(kind, tmp_path, np.random.RandomState(len(kind)))
    root = "" if kind == "Synthetic" else str(tmp_path)
    want_ds = jds.get_dataset(kind)(root, "val", jaug.get_val_augmentation(SIZE), modals, **kw)
    got_ds = tds.get_dataset(kind)(root, "val", taug.get_val_augmentation(SIZE), modals, **kw)
    raw = tds.get_dataset(kind)(root, "val", None, modals, **kw)
    assert len(got_ds) == len(want_ds) >= 2 and got_ds.n_classes == want_ds.n_classes
    assert list(got_ds.CLASSES) == list(want_ds.CLASSES)
    assert (got_ds.PALETTE is None) == (want_ds.PALETTE is None)
    for i in range(len(got_ds)):
        (gs, gl), (ws, wl) = got_ds[i], want_ds[i]
        assert raw[i][0]["img"].shape[:2] != gs["img"].shape[:2]  # the transform resampled
        assert sorted(gs) == sorted(ws) == sorted(modals)
        for m in modals:
            assert gs[m].dtype == ws[m].dtype
            np.testing.assert_array_equal(gs[m], ws[m])
        assert gl.dtype == wl.dtype
        np.testing.assert_array_equal(gl, wl)


def test_device_normalize_matches_host_normalize():
    import torch

    x = np.random.RandomState(1).randint(0, 256, (2, 5, 7, 3)).astype(np.uint8)
    want = taug.Normalize()({"img": x[0], "depth": x[1]})
    for modal, idx in (("img", 0), ("depth", 1)):
        got = taug.device_normalize(torch.from_numpy(x[idx]), modal).numpy()
        np.testing.assert_array_equal(got, want[modal])
        np.testing.assert_array_equal(
            got, np.asarray(jaug.device_normalize(jnp.asarray(x[idx]), modal)))


def _synthetic(pkg, length=7, norm=True):
    aug = (jaug if pkg == "jax" else taug)
    tf = aug.get_val_augmentation(SIZE) if norm else aug.get_val_augmentation_device_norm(SIZE)
    ds = (jds if pkg == "jax" else tds).Synthetic
    return ds("", "val", tf, ["img", "depth"], length=length, image_size=(H, W), num_classes=6)


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_batches_match_jax(shuffle, drop_last):
    kw = dict(shuffle=shuffle, drop_last=drop_last, num_workers=2, seed=11, epoch=2)
    want = list(jloader.DataLoader(_synthetic("jax"), 3, **kw))
    got = list(tloader.DataLoader(_synthetic("torch"), 3, **kw))
    assert len(got) == len(want) == (2 if drop_last else 3)
    for g, w in zip(got, want):
        assert [a.dtype for a in g] == [a.dtype for a in w]
        assert g[-1].dtype == np.int32
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    raw = next(iter(tloader.DataLoader(_synthetic("torch", norm=False), 3, **kw)))
    assert raw[0].dtype == np.uint8 and raw[-1].dtype == np.int32


def test_loader_process_workers():
    """Process workers give the thread workers' batches (in a process
    without JAX, so that fork copies no JAX threads)."""
    code = (
        "import numpy as np\n"
        "from ir_ads_tpu_torch.data import augmentations as a, datasets as d, loader as l\n"
        "ds = d.Synthetic('', 'val', a.get_val_augmentation((48, 64)), ['img', 'depth'], "
        "length=5, image_size=(40, 60), num_classes=6)\n"
        "kw = dict(shuffle=True, drop_last=False, num_workers=2)\n"
        "t = list(l.DataLoader(ds, 2, workers='thread', **kw))\n"
        "p = list(l.DataLoader(ds, 2, workers='process', **kw))\n"
        "assert len(t) == len(p) == 3\n"
        "for x, y in zip(t, p):\n"
        "    for u, v in zip(x, y):\n"
        "        np.testing.assert_array_equal(u, v)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stdout + out.stderr
    with pytest.raises(ValueError, match="workers"):
        tloader.DataLoader(_synthetic("torch"), 2, workers="fiber")


@pytest.mark.parametrize("maker", ["jax", "torch"])
def test_raw_cache_opens_in_the_other_package(maker, tmp_path):
    src = _synthetic(maker, length=3, norm=False)
    build = (jcache if maker == "jax" else tcache).RawCache.build
    build(src, str(tmp_path), transform=src.transform)
    other = tcache if maker == "jax" else jcache
    opened = other.RawCache.open(str(tmp_path))
    mine = (jcache if maker == "jax" else tcache).RawCache.open(str(tmp_path))
    served = other.RawCache.open(str(tmp_path), transform=src.transform)
    assert len(opened) == len(mine) == 3 and opened.modals == ["img", "depth"]
    for i in range(3):
        (a, la), (b, lb), (c, lc) = opened[i], mine[i], served[i]
        for m in ("img", "depth"):
            assert a[m].dtype == np.uint8 and a[m].shape == (H, W, 3)  # raw, decoded once
            np.testing.assert_array_equal(a[m], b[m])
            np.testing.assert_array_equal(c[m], src[i][0][m])  # then the transform
        np.testing.assert_array_equal(la, lb)
        np.testing.assert_array_equal(lc, src[i][1])


def test_load_weights_reads_flax_msgpack(tmp_path):
    import ml_dtypes

    rng = np.random.RandomState(2)
    params = {"stage": {"kernel": rng.randn(3, 4).astype(np.float32),
                        "half": rng.randn(5).astype(ml_dtypes.bfloat16),
                        "ids": np.arange(6, dtype=np.int32).reshape(2, 3)}}
    stats = {"bn": {"mean": rng.randn(4).astype(np.float32), "count": np.float32(3.0)}}
    save_weights(str(tmp_path / "w" / "weights.msgpack"), params, stats)
    got = load_weights(str(tmp_path / "w"))  # the directory, as MODEL_PATH may name it
    np.testing.assert_array_equal(got["params"]["stage"]["kernel"], params["stage"]["kernel"])
    np.testing.assert_array_equal(got["params"]["stage"]["ids"], params["stage"]["ids"])
    half = got["params"]["stage"]["half"]
    assert half.dtype == np.float32
    np.testing.assert_array_equal(half, params["stage"]["half"].astype(np.float32))
    np.testing.assert_array_equal(got["batch_stats"]["bn"]["mean"], stats["bn"]["mean"])
    assert float(got["batch_stats"]["bn"]["count"]) == 3.0


def test_load_weights_refuses_the_chunked_form(tmp_path, monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"params": {"big": np.zeros(100, np.float32)}, "batch_stats": {}}
    (tmp_path / "weights.msgpack").write_bytes(serialization.msgpack_serialize(tree))
    with pytest.raises(NotImplementedError, match="chunked"):
        load_weights(str(tmp_path / "weights.msgpack"))
