"""Configuration of the PyTorch port: the fields and derived geometry of
``eventad_tpu.config.Config`` without jax or yaml.

Only the fields the batched scoring forward reads are carried, with the
same names and defaults (reference dagr-S / EventAD values,
``eventad_tpu/config/defaults.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass
class Config:
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
    pooling_dim_at_output: str = "5x7"
    use_image: bool = True
    keep_temporal_ordering: bool = False
    img_net: str = "resnet50"

    # ---- anomaly head (reference config/eventad_config.py) ----
    batch_size: int = 6
    x_dim: int = 64
    h_dim: int = 256
    max_boxes: int = 30

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

