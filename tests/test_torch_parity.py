"""The port's ``parity`` against the JAX package's, its result files, its
checkpoint readers and its run utilities.

One module-scoped run: the JAX ``parity.main`` on the arguments of
``tests/test_parity_fixture.py`` into a temporary dataset directory (it
generates the fixture and writes ``dagr_fixture.pth`` /
``eventad_fixture.pth``), then the port's ``parity.main`` on the same
directory, which reuses those checkpoints.  Measured on the CPU: the five
metric families equal (AUC_unadjusted to 1.1e-16), the score digests
within 2.5e-6 (score_mean) and 9.6e-7 (score_max) of the JAX run's.  Held
here to 1e-9 and 1e-5, and to the golden pins within their own 1e-4."""
import csv
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from eventad_tpu.config import Config as JaxConfig
from eventad_tpu.models.convert import \
    load_torch_state_dict as jax_load_state
from eventad_tpu.utils import result as jres
from eventad_tpu.utils import viz as jviz
from eventad_tpu.utils.visualization import \
    validate_and_visualize as jax_validate
from eventad_tpu_torch import parity
from eventad_tpu_torch.config import Config
from eventad_tpu_torch.data.fixtures import generate_dataset
from eventad_tpu_torch.models.convert import (convert_full_model,
                                              export_reference_state,
                                              load_torch_state_dict,
                                              split_reference_state)
from eventad_tpu_torch.models.dagr import init_model
from eventad_tpu_torch.utils import result as pres
from eventad_tpu_torch.utils import viz as pviz
from eventad_tpu_torch.utils.logging import RunLogger
from eventad_tpu_torch.utils.visualization import validate_and_visualize

import _torch_threads  # noqa: F401  (one intra-op thread)

GOLDEN = json.loads((Path(__file__).parent / "golden"
                     / "parity_fixture.json").read_text())
ARGS = [
    "--synthetic_data", "true",
    "--width", "96", "--height", "72", "--scale", "1",
    "--batch_size", "2", "--use_image", "false",
    "--event_buckets", "4096", "--graph_lookback", "512",
    "--num_workers", "0", "--seed", "7",
]
METRIC_TOL = 1e-9     # the five families and AUC_unadjusted, port vs JAX
DIGEST_TOL = 1e-5     # score_mean, score_max, port vs JAX
GOLDEN_TOL = 1e-4     # tests/test_parity_fixture.py's own


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # imported here, as tests/test_parity_fixture.py does: the root script
    # configures JAX's compilation cache when it is imported
    import parity as jax_parity
    root = tmp_path_factory.mktemp("parity")
    data = str(root / "data")
    want = jax_parity.main(ARGS + ["--dataset_directory", data,
                                   "--output_dir", str(root / "jax")])
    stamp = (root / "data" / "dagr_fixture.pth").stat().st_mtime_ns
    got = parity.main(ARGS + ["--dataset_directory", data,
                              "--output_dir", str(root / "port"),
                              "--device", "cpu"])
    assert (root / "data" / "dagr_fixture.pth").stat().st_mtime_ns == stamp
    return root, want, got


def test_port_reproduces_the_jax_run_and_the_golden_pins(runs):
    _, want, got = runs
    assert set(got) == set(want) == set(GOLDEN)
    for k in ("AUC", "AUC_unadjusted", "AP", "AUC-Frame", "mTTA",
              "mRESPONSE"):
        assert abs(got[k] - want[k]) <= METRIC_TOL, (k, got[k], want[k])
    for k in ("score_mean", "score_max"):
        assert abs(got[k] - want[k]) <= DIGEST_TOL, (k, got[k], want[k])
    for k, pin in GOLDEN.items():
        assert abs(got[k] - pin) < GOLDEN_TOL, (k, got[k], pin)


def _result_dir(base: Path) -> Path:
    (d,) = list((base / "test_results").iterdir())
    assert d.name.startswith("eventad_dagr_experiment_")
    return d


def test_result_files_equal(runs):
    root, _, _ = runs
    jdir, pdir = _result_dir(root / "jax"), _result_dir(root / "port")
    assert len(jdir.name) == len(pdir.name)
    assert sorted(p.name for p in jdir.iterdir()) == sorted(
        p.name for p in pdir.iterdir()) == ["metrics_summary.txt",
                                            "test_results.csv"]
    # same rows and text, to the four printed decimals
    for name in ("test_results.csv", "metrics_summary.txt"):
        assert (jdir / name).read_text() == (pdir / name).read_text(), name


def test_result_utilities_equal(tmp_path):
    cfg = Config(dataset_directory="/data/rol")
    jcfg = JaxConfig(dataset_directory="/data/rol")
    for mode in ("train", "test"):
        a = pres.setup_directories(str(tmp_path / "p"), "exp", mode)
        b = jres.setup_directories(str(tmp_path / "j"), "exp", mode)
        assert set(a) == set(b)
        for key in ("result_dir", "model_dir"):
            if key in a:
                assert Path(a[key]).relative_to(tmp_path / "p").parts[:1] \
                    == Path(b[key]).relative_to(tmp_path / "j").parts[:1]
                assert Path(a[key]).name.rsplit("_", 2)[0] == "exp"
    pf = pres.setup_result_file(str(tmp_path), cfg)
    pres.append_epoch_row(pf, 0, 0.5, 0.6, 0.7, 0.3, 1e-3)
    pres.append_fps(pf, 12.345)
    (tmp_path / "p.csv").write_text(Path(pf).read_text())
    jf = jres.setup_result_file(str(tmp_path), jcfg)
    jres.append_epoch_row(jf, 0, 0.5, 0.6, 0.7, 0.3, 1e-3)
    jres.append_fps(jf, 12.345)
    assert (tmp_path / "p.csv").read_text() == Path(jf).read_text()
    rows = list(csv.reader(open(jf)))
    assert rows[3] == ["Epoch", "Train Loss", "Val Loss", "ROC AUC", "AP",
                       "Learning Rate"]


def test_self_contained_port_run(tmp_path, capsys):
    """The port's own fixture and checkpoints (a short head fine-tune from
    the port's seeded model), converted back and evaluated."""
    data = tmp_path / "data"
    # a fixture of one sequence a split, written first (parity then finds
    # its split file), and a smaller bucket and lookback than the golden
    # run's keep it short
    generate_dataset(data, Config(width=96, height=72, scale=1), n_train=1,
                     n_val=1, n_frames=8)
    got = parity.main(ARGS + ["--dataset_directory", str(data),
                              "--output_dir", str(tmp_path / "out"),
                              "--fixture_train_steps", "12",
                              "--event_buckets", "1024",
                              "--graph_lookback", "256", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "fixture head trained 12 steps" in out
    assert "==== Parity vs BASELINE.md (FIXTURE" in out
    for name in ("rol_split.yaml", "toa_values.json", "dagr_fixture.pth",
                 "eventad_fixture.pth"):
        assert (data / name).exists(), name
    rdir = _result_dir(tmp_path / "out")
    assert {p.name for p in rdir.iterdir()} == {"metrics_summary.txt",
                                                "test_results.csv"}
    assert set(got) == set(GOLDEN)
    assert all(np.isfinite(got[k]) for k in ("AUC", "AP", "AUC-Frame",
                                             "score_mean", "score_max"))
    # the checkpoints hold the fine-tuned head: converting them back
    # gives the weights the port exported
    cfg = Config(width=96, height=72, scale=1, batch_size=2,
                 use_image=False, event_buckets=(1024,), seed=7)
    model, _, _ = convert_full_model(cfg, str(data / "dagr_fixture.pth"),
                                     str(data / "eventad_fixture.pth"),
                                     "cpu")
    seeded, _, _ = init_model(cfg, torch.Generator().manual_seed(7), "cpu")
    a, b = export_reference_state(model), export_reference_state(seeded)
    dagr_a, head_a = split_reference_state(a)
    dagr_b, head_b = split_reference_state(b)
    assert all(np.array_equal(dagr_a[k], dagr_b[k]) for k in dagr_b)
    assert any(not np.array_equal(head_a[k], head_b[k]) for k in head_b)


def test_state_dict_unwrapping_and_prefixes(tmp_path):
    cfg = Config(width=96, height=72, scale=1, batch_size=2,
                 use_image=False, event_buckets=(1024,))
    model, _, _ = init_model(cfg, torch.Generator().manual_seed(3), "cpu")
    dagr, head = split_reference_state(export_reference_state(model))
    t = {k: torch.from_numpy(v) for k, v in head.items()}
    lin = torch.nn.Linear(3, 2)
    files = {"ema_model": {"ema": {"model": t}}, "model": {"model": t},
             "flat": t, "module": lin}
    for name, obj in files.items():
        torch.save(obj, tmp_path / f"{name}.pth")
        got = load_torch_state_dict(str(tmp_path / f"{name}.pth"))
        want = jax_load_state(str(tmp_path / f"{name}.pth"))
        assert set(got) == set(want), name
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], f"{name} {k}")
    # a head saved from a wrapped EventADModel: module. prefixes stripped,
    # its dagr_model. keys dropped
    wrapped = {"module." + k: v for k, v in t.items()}
    wrapped.update({"module.dagr_model." + k: torch.from_numpy(v)
                    for k, v in dagr.items()})
    torch.save({"model": wrapped}, tmp_path / "head.pth")
    torch.save({"ema": {k: torch.from_numpy(v) for k, v in dagr.items()}},
               tmp_path / "dagr.pth")
    again, _, _ = convert_full_model(cfg, str(tmp_path / "dagr.pth"),
                                     str(tmp_path / "head.pth"), "cpu")
    for (k, v), (_, w) in zip(model.state_dict().items(),
                              again.state_dict().items()):
        assert torch.equal(v, w), k


def test_validation_plots_logger_and_frames(tmp_path):
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(3):
        logits = torch.from_numpy(rng.randn(2, 5, 2).astype(np.float32))
        valid = torch.from_numpy(rng.rand(2, 5) > 0.3)
        labels = torch.from_numpy((rng.rand(2, 5) > 0.6).astype(np.int32))
        batches.append((logits, valid, labels, torch.tensor(1.5),
                        torch.tensor(int(valid.sum()))))

    class FakeBatch:
        def __init__(self, i):
            self.i = i
            self.bbox_mask = np.ones(1, bool)

        def is_empty(self):
            return False
    loader = [(FakeBatch(i), None) for i in range(3)]
    got = validate_and_visualize(lambda b: batches[b.i], loader,
                                 str(tmp_path / "p"), 0)
    want = jax_validate(lambda b: [x.numpy() for x in batches[b.i]], loader,
                        str(tmp_path / "j"), 0)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert {p.name for p in (tmp_path / "p").iterdir()} == {
        p.name for p in (tmp_path / "j").iterdir()} == {
        "roc_curve_epoch_0.png", "pr_curve_epoch_0.png"}

    log = RunLogger(tmp_path / "log", hparams=Config(batch_size=3))
    log.log({"loss": 1.25}, step=4)
    log.log_image("frame", np.zeros((4, 6, 3), np.uint8))
    log.close()
    rec = json.loads((tmp_path / "log" / "metrics.jsonl").read_text())
    assert rec["loss"] == 1.25 and rec["step"] == 4
    assert json.loads((tmp_path / "log" / "hparams.json").read_text())[
        "batch_size"] == "3"
    assert (tmp_path / "log" / "frame_0.png").exists()

    image = rng.rand(24, 32, 3).astype(np.float32)
    events = dict(x=rng.randint(-2, 34, 50), y=rng.randint(-2, 26, 50),
                  p=rng.choice([-1, 1], 50))
    dets = dict(boxes=np.array([[2, 3, 12, 15]], np.float32),
                labels=np.array([1]), scores=np.array([0.8], np.float32))
    targets = dict(boxes=np.array([[4, 4, 20, 20]], np.float32),
                   labels=np.array([0]))
    import cv2
    pviz.save_detection_frame(tmp_path / "p.png", image, events, dets,
                              targets)
    jviz.save_detection_frame(tmp_path / "j.png", image, events, dets,
                              targets)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "p.png")),
                                  cv2.imread(str(tmp_path / "j.png")))
