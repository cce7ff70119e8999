"""The port's data layer against the JAX package's on the same seeded
inputs: fixture files, h5 windows, dataset items (preloaded and read per
window, with ``set_num_us``), the in-memory dataset, ``collate``, the
``Loader``'s order and its three modes, and ``parse_args`` with a YAML
overlay.  Everything equal exactly."""
import dataclasses
import warnings
from pathlib import Path

import cv2
import h5py
import numpy as np
import pytest

from eventad_tpu.config import Config as JaxConfig
from eventad_tpu.config import parse_args as jax_parse_args
from eventad_tpu.data import batching as jb
from eventad_tpu.data.dataset import SequenceDataset as JaxDataset
from eventad_tpu.data.fixtures import generate_dataset as jax_generate
from eventad_tpu.data.h5io import EventFile as JaxEventFile
from eventad_tpu_torch.config import Config, parse_args
from eventad_tpu_torch.data.batching import (EventBatch, Loader, collate,
                                             pick_bucket)
from eventad_tpu_torch.data.dataset import (MemoryDataset, SequenceDataset,
                                            check_dataset_balance)
from eventad_tpu_torch.data.fixtures import (fixture_sequences,
                                             generate_dataset)
from eventad_tpu_torch.data.h5io import (EventFile, create_ms_to_idx,
                                         write_events)

import _torch_threads  # noqa: F401  (one intra-op thread)

# sensor 192 x 144 at scale 2: the frames are resized (INTER_CUBIC) and the
# tracks rescaled on the way to the 96 x 72 model geometry
KW = dict(width=192, height=144, scale=2, batch_size=2)
GEN = dict(n_train=1, n_val=2, n_frames=8, events_per_window=800)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("fixtures")
    jax_generate(base / "jax", JaxConfig(**KW), **GEN)
    generate_dataset(base / "port", Config(**KW), **GEN)
    return base / "jax", base / "port"


def _cfgs(root, **kw):
    split = str(root / "rol_split.yaml")
    return (Config(**KW, split=split, **kw),
            JaxConfig(**KW, split=split, **kw))


def test_fixture_files_equal(roots):
    jroot, proot = roots
    files = sorted(p.relative_to(jroot) for p in jroot.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(proot) for p in proot.rglob("*")
                           if p.is_file())
    kinds = {".h5": 0, ".png": 0, ".npy": 0, ".txt": 0}
    for rel in files:
        a, b = jroot / rel, proot / rel
        if rel.suffix == ".h5":
            with h5py.File(a) as fa, h5py.File(b) as fb:
                names = []
                fa.visit(names.append)
                for name in names:
                    if isinstance(fa[name], h5py.Dataset):
                        assert fa[name].dtype == fb[name].dtype, name
                        np.testing.assert_array_equal(fa[name][()],
                                                      fb[name][()], name)
        elif rel.suffix == ".png":
            pa, pb = cv2.imread(str(a)), cv2.imread(str(b))
            assert pa.shape == (144, 192, 3)
            np.testing.assert_array_equal(pa, pb)
        elif rel.suffix == ".npy":
            ta, tb = np.load(a), np.load(b)
            assert ta.dtype == tb.dtype
            np.testing.assert_array_equal(ta, tb)
        else:
            # timestamps.txt, rol_split.yaml, toa_values.json
            assert a.read_bytes() == b.read_bytes(), rel
        kinds[rel.suffix] = kinds.get(rel.suffix, 0) + 1
    assert kinds[".h5"] == 4 and kinds[".png"] == 32 and kinds[".txt"] == 4
    assert '"synth_val_00": 6' in (proot / "toa_values.json").read_text()


def test_load_window_at_millisecond_edges(tmp_path):
    rng = np.random.RandomState(3)
    n = 4000
    t = np.sort(rng.randint(0, 60_000, n)).astype(np.int64)
    # events exactly on millisecond edges and runs of equal times
    t[::97] = (t[::97] // 1000) * 1000
    t = np.sort(t)
    ev = dict(x=rng.randint(0, 90, n).astype(np.uint16),
              y=rng.randint(0, 70, n).astype(np.uint16), t=t,
              p=rng.randint(0, 2, n).astype(np.uint8))
    path = tmp_path / "e.h5"
    write_events(path, ev, t_offset=17)
    mine, ref = EventFile(path), JaxEventFile(path)
    assert mine.t_offset == ref.t_offset == 17
    assert mine.n_events == ref.n_events == n
    np.testing.assert_array_equal(mine.f["ms_to_idx"][()],
                                  create_ms_to_idx(t))
    windows = [(0, 1000), (999, 1001), (1000, 2000), (2000, 2001),
               (12_345, 30_000), (-500, 700), (59_000, 61_000),
               (59_999, 10**9), (5000, 5000), (30_001, 29_000)]
    for t0, t1 in windows:
        got, want = mine.load_window(t0, t1), ref.load_window(t0, t1)
        sel = (t >= t0) & (t < t1)
        assert len(got["t"]) == sel.sum()
        for k in "xytp":
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], f"{k} {t0} {t1}")
    # pickles without its handle, reopens on use
    import pickle
    again = pickle.loads(pickle.dumps(mine))
    assert again._f is None and again.n_events == n


def _items_equal(got, want):
    for f in ("sequence", "frame_id", "width", "height", "time_window"):
        assert getattr(got, f) == getattr(want, f), f
    for k in "xytp":
        assert got.events[k].dtype == want.events[k].dtype, k
        np.testing.assert_array_equal(got.events[k], want.events[k], k)
    for f in ("image", "bbox", "bbox0"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, f)


@pytest.mark.parametrize("preload", [True, False])
@pytest.mark.parametrize("num_us", [-1, 20_000])
def test_dataset_items_equal(roots, preload, num_us):
    jroot, proot = roots
    cfg, jcfg = _cfgs(proot)
    n = 0
    for split in ("val", "test"):
        mine = SequenceDataset(cfg, proot, split)
        ref = JaxDataset(jcfg, jroot, split)
        mine.preload_events = ref.preload_events = preload
        mine.set_num_us(num_us)
        ref.set_num_us(num_us)
        assert len(mine) == len(ref) == 7 * (2 if split == "val" else 1)
        for i in range(len(ref)):
            _items_equal(mine[i], ref[i])
            n += 1
    assert n == 21


def test_memory_dataset_equals_files(roots):
    """Items cut from the generator's arrays in memory equal the items read
    back from its files (scale 1: frames at model size)."""
    _, proot = roots
    kw = dict(KW, width=96, height=72, scale=1)
    seqs = [s for g, s in fixture_sequences(Config(**kw), **GEN)
            if g == "val"]
    root = proot.parent / "scale1"
    generate_dataset(root, Config(**kw), **GEN)
    cfg = Config(**kw, split=str(root / "rol_split.yaml"))
    disk = SequenceDataset(cfg, root, "val")
    mem = MemoryDataset(cfg, seqs)
    assert len(mem) == len(disk) == 14
    for i in range(len(mem)):
        _items_equal(mem[i], disk[i])
    with pytest.raises(ValueError, match="frames are not"):
        MemoryDataset(Config(**dict(KW, scale=1)), seqs)


def _batch_equal(got: EventBatch, want, gmeta, wmeta):
    assert gmeta.sequences == wmeta.sequences
    assert gmeta.frame_ids == wmeta.frame_ids
    assert gmeta.n_items == wmeta.n_items
    assert gmeta.truncated_events == wmeta.truncated_events
    for name in got._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, name)


@pytest.mark.parametrize("buckets", [(256, 1024, 4096), (128, 256),
                                     (512,)])
def test_collate_equal(roots, buckets):
    jroot, proot = roots
    cfg, jcfg = _cfgs(proot, event_buckets=buckets)
    mine = SequenceDataset(cfg, proot, "val")
    ref = JaxDataset(jcfg, jroot, "val")
    truncated = 0
    for i in range(0, len(ref), 2):
        idx = list(range(i, min(i + 2, len(ref))))
        got, gm = collate([mine[j] for j in idx], cfg)
        want, wm = jb.collate([ref[j] for j in idx], jcfg)
        assert got.pos.shape[1] == pick_bucket(
            max(len(mine[j].events["t"]) for j in idx), buckets)
        _batch_equal(got, want, gm, wm)
        truncated += gm.truncated_events
    # the small buckets truncate (most recent events kept), the large don't
    assert (truncated > 0) == (buckets[-1] < 1024)


def _loader_cfgs(proot):
    # every sequence of the fixture (split ""): 28 items, 14 batches
    return (Config(**KW, split=""), JaxConfig(**KW, split=""))


def test_loader_order_equals_reference(roots):
    jroot, proot = roots
    cfg, jcfg = _loader_cfgs(proot)
    mine = Loader(SequenceDataset(cfg, proot, "val"), cfg, shuffle=True,
                  seed=5, prefetch=0, num_workers=0)
    ref = jb.Loader(JaxDataset(jcfg, jroot, "val"), jcfg, shuffle=True,
                    seed=5, prefetch=0, num_workers=0)
    assert len(mine) == len(ref) == 14 and mine.mode() == "serial"
    for _epoch in range(2):
        for (gb, gm), (wb, wm) in zip(mine, ref, strict=True):
            _batch_equal(gb, wb, gm, wm)


def test_loader_three_modes_equal(roots):
    """Serial, prefetch thread and spawned decode processes: the same
    batches in the same order, bit for bit, over two epochs (the pool
    persists); a truncating bucket warns once and counts in every mode."""
    _, proot = roots
    cfg = Config(**KW, split="", event_buckets=(256,))
    ds = SequenceDataset(cfg, proot, "val")
    loaders = [Loader(ds, cfg, shuffle=True, seed=2, prefetch=0,
                      num_workers=0),
               Loader(ds, cfg, shuffle=True, seed=2, num_workers=0),
               Loader(ds, cfg, shuffle=True, seed=2, num_workers=2)]
    assert [ld.mode() for ld in loaders] == ["serial", "thread",
                                             "processes"]
    try:
        for epoch in range(2):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                runs = [list(ld) for ld in loaders]
            # one warning a loader, in its first epoch
            assert len([w for w in caught if "largest padding bucket"
                        in str(w.message)]) == (3 if epoch == 0 else 0)
            for run in runs[1:]:
                assert len(run) == len(runs[0]) == 14
                for (gb, gm), (wb, wm) in zip(run, runs[0]):
                    _batch_equal(gb, wb, gm, wm)
        counts = {ld.truncated_events for ld in loaders}
        assert len(counts) == 1 and counts.pop() > 0
    finally:
        loaders[2].close()
    assert loaders[2]._pool is None
    check = check_dataset_balance({"val": loaders[0]})
    assert check["val"]["anomaly"] > 0 and check["val"]["normal"] > 0


class _Broken:
    def __len__(self):
        return 8

    def __getitem__(self, i):
        raise KeyError(f"item {i} is missing")


def test_loader_surfaces_decode_errors():
    cfg = Config(**KW)
    for kw in (dict(prefetch=0, num_workers=0), dict(num_workers=0),
               dict(num_workers=2)):
        loader = Loader(_Broken(), cfg, **kw)
        try:
            with pytest.raises(KeyError, match="is missing"):
                list(loader)
        finally:
            loader.close()


def test_parse_args_with_yaml_overlay(tmp_path):
    overlay = tmp_path / "over.yaml"
    overlay.write_text("batch_size: 3\nlearning_rate: 0.01\n"
                       "dataset_directory: /data/rol\naug_zoom: 1.25\n"
                       "train_split: train\nnot_a_field: 1\n")
    second = tmp_path / "second.yaml"
    second.write_text("batch_size: 5\nfps: 30.0\n")
    argv = ["--config", str(overlay), "--eventad_config", str(second),
            "--learning_rate", "0.02", "--use_augmentations", "true",
            "--event_buckets", "1024,2048", "--num_workers", "0",
            "--fixture_train_steps", "7", "--split", ""]
    mine, ref = parse_args(argv), jax_parse_args(argv)
    shared = [f.name for f in dataclasses.fields(Config)]
    assert {f.name for f in dataclasses.fields(JaxConfig)} >= set(shared)
    for name in shared:
        assert getattr(mine, name) == getattr(ref, name), name
    # CLI > second YAML > first YAML > defaults
    assert (mine.batch_size, mine.learning_rate, mine.fps) == (5, 0.02, 30.0)
    assert mine.aug_zoom == 1.25 and mine.train_split == "train"
    # a missing overlay file is skipped, as in the JAX package
    assert parse_args(["--config", str(tmp_path / "none.yaml")]) == Config(
        config=str(tmp_path / "none.yaml"))


def test_entry_modules_read_the_dataset_directory(tmp_path, capsys):
    """train, test, train_detector and test_detector through
    SequenceDataset and Loader on a fixture they generate
    (``--synthetic_data true``), at a tiny geometry."""
    from eventad_tpu_torch import test as test_mod
    from eventad_tpu_torch import test_detector, train, train_detector
    generate_dataset(tmp_path / "data", Config(width=96, height=72, scale=1),
                     n_train=1, n_val=1, n_frames=5, events_per_window=400)
    args = ["--device", "cpu", "--synthetic_data", "true",
            "--dataset_directory", str(tmp_path / "data"), "--width", "96",
            "--height", "72", "--scale", "1", "--batch_size", "2",
            "--use_image", "false", "--event_buckets", "512",
            "--graph_lookback", "128", "--num_workers", "0",
            "--output_dir", str(tmp_path / "out"), "--epochs", "1"]
    res = train.main(args + ["--train_split", "train",
                             "--check_balance", "true"])
    assert (res["model_dir"] / "latest_checkpoint.pt").exists()
    assert (tmp_path / "out" / "results").exists()
    metrics = test_mod.main(args + ["--fps_warmup_batches", "0",
                                    "--fps_num_batches", "1"])
    assert {p.name for p in Path(metrics["result_dir"]).iterdir()} == {
        "test_results.csv", "metrics_summary.txt"}
    det = train_detector.main(args + ["--use_augmentations", "true",
                                      "--no_aug_epochs", "1"])
    assert det["checkpoint"].exists()
    test_detector.main(args + ["--test_checkpoint", str(det["checkpoint"])])
    out = capsys.readouterr().out
    assert "train items: 4, val items: 4" in out
    assert "no-aug phase" in out and "loaded checkpoint" in out
    frames = list((tmp_path / "out" / "test_results").glob("*_det_*/*.png"))
    assert len(frames) == 4
