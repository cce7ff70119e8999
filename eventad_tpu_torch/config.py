"""Configuration of the PyTorch port: the fields and derived geometry of
``eventad_tpu.config.Config`` without jax.

Only the fields the port reads are carried (the scoring forward, head
training, evaluation, detection serving and training, the data layer and
``parity``), with the same names and defaults (reference dagr-S /
EventAD values, ``eventad_tpu/config/defaults.py``).  ``parse_args`` gives
the same ``--field value`` command line and the same YAML overlays
(``--config``, ``--eventad_config``; CLI > YAML > defaults).
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Tuple


@dataclass
class Config:
    # ---- paths (reference config/eventad_config.py:19-33) ----
    dataset_directory: str = "./data/detector/ROL"
    checkpoint: str = "./checkpoints/detector/dagr_s_50.pth"
    config: str = ""            # optional YAML overlay path
    eventad_config: str = ""    # optional second YAML overlay
    split: str = "./config/rol_split.yaml"
    toa: str = "./config/toa_values.json"

    # ---- graph (dagr-S, reference ev_tgn.py:22-37) ----
    radius: float = 0.01
    time_window_us: int = 1_000_000
    max_neighbors: int = 16

    # ---- network (reference net.py:34-97) ----
    activation: str = "relu"
    aggr: str = "sum"
    kernel_size: int = 5
    pooling_aggr: str = "max"
    base_width: float = 0.5
    after_pool_width: float = 1.0
    net_stem_width: float = 0.5
    yolo_stem_width: float = 0.5
    num_scales: int = 2
    pooling_dim_at_output: str = "5x7"
    use_image: bool = True
    no_events: bool = False
    keep_temporal_ordering: bool = False
    img_net: str = "resnet50"

    # ---- anomaly head (reference config/eventad_config.py) ----
    batch_size: int = 6
    x_dim: int = 64
    h_dim: int = 256
    max_boxes: int = 30
    threshold: float = 0.5

    # ---- head training (reference config/eventad_config.py:46-101,
    # train.py:17-44) ----
    epochs: int = 100
    learning_rate: float = 1e-3
    weight_decay: float = 1e-5
    grad_clip: float = 1.0
    lr_decay_factor: float = 0.5
    lr_patience: int = 5
    min_lr: float = 1e-6
    seed: int = 42
    plot_interval: int = 5           # ROC/PR plots every this many epochs
    pretrained_model: str = ""
    resume: str = ""
    fps: float = 20.0                # mRESPONSE's frame rate in ``parity``

    # ---- detector training (reference dagr-S optimisation, train_detector
    # of the JAX package; ``clip`` is DAGR's global-norm clip, not the
    # head's ``grad_clip``) ----
    clip: float = 0.1
    optimizer: str = "adam"          # "sgd", else AdamW
    lr: float = 0.003
    lr_scheduler: str = "cosine"     # the detector's is warm-up + cosine
    no_aug_epochs: int = 0           # final epochs with the L1 branch on
    # generate the on-disk fixture (data/fixtures.py) into
    # ``dataset_directory`` first, when it holds no split file
    synthetic_data: bool = False

    # ---- data (reference utils/data.py, eventad_config.py:121) ----
    num_workers: int = 4
    no_eval: bool = False
    # reference quirk: training data comes from the split named "test" with
    # the testing transform (utils/data.py:27-30); override to use "train"
    train_split: str = "test"
    use_augmentations: bool = False
    check_balance: bool = False
    aug_p_flip: float = 0.5
    aug_trans: float = 0.1
    aug_zoom: float = 1.5
    # lower zoom bound; < 1 enables zoom-out with the density-preserving
    # event subsample (reference augment.py:139-189 with zoom < 1)
    aug_zoom_min: float = 1.0
    # ``parity`` fixture mode: head fine-tune steps on cached features
    # before the evaluation
    fixture_train_steps: int = 800

    # ---- experiment / test (reference test.py:113-129) ----
    experiment_name: str = "eventad_dagr_experiment"
    output_dir: str = "./output"
    test_checkpoint: str = ""
    legacy_frame_collapse: bool = False
    measure_fps: bool = True
    fps_warmup_batches: int = 70
    fps_num_batches: int = 20

    # ---- raw sensor geometry (reference eventad_config.py:97-98) ----
    height: int = 720
    width: int = 1080
    scale: int = 3

    # ---- event tables ----
    event_buckets: Tuple[int, ...] = (8192, 16384, 32768, 65536)
    graph_lookback: int = 1024
    max_queue_size: int = 128
    compute_dtype: str = "float32"

    @property
    def model_width(self) -> int:
        """Event/image width seen by the model (reference dsec_data.py:83)."""
        return self.width // self.scale

    @property
    def model_height(self) -> int:
        return self.height // self.scale

    @property
    def radius_px(self) -> int:
        """Pixel radius of the event graph (reference ev_tgn.py:29)."""
        return int(self.radius * self.model_width) + 1

    @property
    def delta_t_us(self) -> int:
        """Temporal radius in microseconds (reference ev_tgn.py:28)."""
        return int(self.radius * self.time_window_us)

    @property
    def effective_radius(self) -> float:
        """Normalized Cartesian max value (reference net.py:70)."""
        w = self.model_width
        return 2 * float(int(self.radius * w + 2)) / w

    def poolings(self):
        """Voxel sizes ``(vx, vy, vt)`` of the 4 pooling layers
        (reference net.py:19-28)."""
        py, px = map(int, self.pooling_dim_at_output.split("x"))
        return [(1.0 / px / 2 ** (3 - i), 1.0 / py / 2 ** (3 - i), 1.0)
                for i in range(4)]

    def grid_dims(self):
        """Cells ``(nx, ny)`` of every pooled level."""
        return [(int(round(1.0 / v[0])), int(round(1.0 / v[1])))
                for v in self.poolings()]

    def channels(self):
        """Backbone channel plan (reference net.py:34-37)."""
        return [1,
                int(self.base_width * 32),
                int(self.after_pool_width * 64),
                int(self.net_stem_width * 128),
                int(self.net_stem_width * 128),
                int(self.net_stem_width * 128)]

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def load_yaml_overlay(cfg: Config, path: str) -> Config:
    """The keys of a YAML file that name :class:`Config` fields replace
    them (others are ignored); ``yaml`` is imported only here."""
    import yaml
    with open(path) as f:
        overlay = yaml.safe_load(f) or {}
    known = {f.name for f in dataclasses.fields(Config)}
    return cfg.replace(**{k: v for k, v in overlay.items() if k in known})


def parse_args(argv=None, **overrides) -> Config:
    """``--field value`` for every :class:`Config` field (booleans as
    ``true``/``false``, ``event_buckets`` comma-separated).  The YAML files
    named by ``--config`` and then ``--eventad_config`` (where they exist)
    overlay the defaults, the command line wins over them, ``overrides``
    over all.  Unknown arguments are left to the caller's own parser."""
    parser = argparse.ArgumentParser(add_help=False)
    for f in dataclasses.fields(Config):
        if isinstance(f.default, bool):
            kind = lambda s: s.lower() in ("1", "true", "yes")  # noqa: E731
        elif f.name == "event_buckets":
            kind = lambda s: tuple(int(x) for x in s.split(","))  # noqa: E731
        else:
            kind = type(f.default)
        parser.add_argument("--" + f.name, default=None, type=kind)
    ns, _ = parser.parse_known_args(argv)
    cli = {k: v for k, v in vars(ns).items() if v is not None}
    cfg = Config()
    for path_key in ("config", "eventad_config"):
        path = cli.get(path_key, "")
        if path and Path(path).exists():
            cfg = load_yaml_overlay(cfg, path)
    return cfg.replace(**{**cli, **overrides})
