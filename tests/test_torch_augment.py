"""The port's augmentations against the JAX package's: the same transform
from the same seed gives the same Items, on synthetic items and on the
fixture's dataset items; the zoom-out subsample's keep-mask equals the JAX
package's native one."""
import copy

import numpy as np
import pytest

from eventad_tpu import native as jax_native
from eventad_tpu.config import Config as JaxConfig
from eventad_tpu.data import augment as ja
from eventad_tpu.data.dataset import Item as JaxItem
from eventad_tpu.data.dataset import SequenceDataset as JaxDataset
from eventad_tpu.data.fixtures import generate_dataset as jax_generate
from eventad_tpu_torch import native
from eventad_tpu_torch.config import Config
from eventad_tpu_torch.data import augment as pa
from eventad_tpu_torch.data.dataset import Item, SequenceDataset

import _torch_threads  # noqa: F401  (one intra-op thread)


def _item(rng, cls=Item, w=64, h=48, n=700):
    ev = dict(x=rng.randint(0, w, n).astype(np.int32),
              y=rng.randint(0, h, n).astype(np.int32),
              t=np.sort(rng.randint(0, 10**6, n)).astype(np.int32),
              p=rng.choice([-1, 1], n).astype(np.int8))
    bbox = np.array([[10, 10, 20, 15, 0, 1], [40, 20, 15, 20, 1, 2],
                     [60, 40, 10, 10, 0, 3]], np.float32)
    return cls(events=ev, image=rng.randint(0, 255, (h, w, 3), np.uint8),
               bbox=bbox.copy(), bbox0=bbox[:2].copy(), sequence="s",
               frame_id=0, width=w, height=h, time_window=10**6)


def _equal(got, want):
    for k in "xytp":
        assert got.events[k].dtype == want.events[k].dtype, k
        np.testing.assert_array_equal(got.events[k], want.events[k], k)
    for f in ("image", "bbox", "bbox0"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, f)


AUG = dict(aug_p_flip=0.5, aug_trans=0.1, aug_zoom=1.5)


@pytest.mark.parametrize("zoom_min", [1.0, 0.6])
@pytest.mark.parametrize("seed", [0, 11])
def test_training_transform_equal(zoom_min, seed):
    """Twelve items through one transform each: the random streams of the
    flip, crop, zoom (zoom-out subsample included) and translate advance
    alike."""
    mine = pa.training_transform(Config(**AUG, aug_zoom_min=zoom_min), seed)
    ref = ja.training_transform(JaxConfig(**AUG, aug_zoom_min=zoom_min),
                                seed)
    for i in range(12):
        a = _item(np.random.RandomState(100 + i))
        b = _item(np.random.RandomState(100 + i), JaxItem)
        _equal(mine(a), ref(b))


@pytest.mark.parametrize("make", [
    lambda m: m.RandomHFlip(p=1.0, seed=1),
    lambda m: m.RandomCrop((0.5, 0.6), p=1.0, seed=2),
    lambda m: m.RandomZoom((0.5, 0.9), seed=3),
    lambda m: m.RandomZoom((1.1, 1.6), seed=3),
    lambda m: m.RandomTranslate(0.2, seed=4),
    lambda m: m.Crop((0.1, 0.2), (0.8, 0.9)),
    lambda m: m.testing_transform(None),
], ids=["hflip", "crop", "zoom_out", "zoom_in", "translate", "final_crop",
        "testing"])
def test_each_transform_equal(make):
    mine, ref = make(pa), make(ja)
    for i in range(4):
        _equal(mine(_item(np.random.RandomState(i))),
               ref(_item(np.random.RandomState(i), JaxItem)))


def test_zoom_subsample_mask_equals_native():
    rng = np.random.RandomState(7)
    for _ in range(10):
        n = rng.randint(1, 4000)
        w, h = rng.randint(2, 40), rng.randint(2, 30)
        x = rng.randint(-3, w + 4, n).astype(np.int32)
        y = rng.randint(-3, h + 4, n).astype(np.int32)
        p = rng.choice([-1, 1], n).astype(np.int8)
        thr = float(1 / rng.uniform(0.5, 1.0) ** 2)
        np.testing.assert_array_equal(
            native.zoom_subsample_mask(x, y, p, w, h, thr),
            jax_native.zoom_subsample_mask(x, y, p, w, h, thr))


def test_dataset_items_through_training_transform(tmp_path):
    """SequenceDataset with the training transform of one seed: every item
    equal to the JAX package's (the transform's streams cross items)."""
    kw = dict(width=96, height=72, scale=1, batch_size=2)
    jax_generate(tmp_path, JaxConfig(**kw), n_train=1, n_val=1, n_frames=6,
                 events_per_window=600)
    split = str(tmp_path / "rol_split.yaml")
    cfg = Config(**kw, **AUG, aug_zoom_min=0.7, split=split)
    jcfg = JaxConfig(**kw, **AUG, aug_zoom_min=0.7, split=split)
    mine = SequenceDataset(cfg, tmp_path, "train",
                           transform=pa.training_transform(cfg, seed=3))
    ref = JaxDataset(jcfg, tmp_path, "train",
                     transform=ja.training_transform(jcfg, seed=3))
    assert len(mine) == len(ref) == 5
    for i in range(len(ref)):
        _equal(mine[i], ref[i])
    # the transform leaves the dataset's own arrays as they were
    before = copy.deepcopy(mine._preload_cache)
    mine[0]
    for k in "xytp":
        np.testing.assert_array_equal(
            before["synth_train_00"][0][k],
            mine._preload_cache["synth_train_00"][0][k])
