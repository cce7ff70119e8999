"""The model geometry a configuration file states, and what follows from
it (a copy of the fields and properties of the program's ``Config`` that
the reference and the counts read; the same defaults, the dagr-S widths)."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

# ResNet layouts: blocks per stage, expansion (torchvision)
LAYER_SPECS = {
    "resnet18": ([2, 2, 2, 2], 1),
    "resnet34": ([3, 4, 6, 3], 1),
    "resnet50": ([3, 4, 6, 3], 4),
}
FEATURE_LAYERS = ("conv1", "layer1", "layer2", "layer3", "layer4")


@dataclass(frozen=True)
class Geometry:
    radius: float = 0.01
    time_window_us: int = 1_000_000
    max_neighbors: int = 16
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
    batch_size: int = 6
    x_dim: int = 64
    h_dim: int = 256
    max_boxes: int = 30
    height: int = 720
    width: int = 1080
    scale: int = 3
    event_buckets: Tuple[int, ...] = (8192, 16384, 32768, 65536)
    graph_lookback: int = 1024
    max_queue_size: int = 128
    # the head's fixed widths (EventADConfig)
    coord_dim: int = 32
    event_layers: int = 2
    coord_layers: int = 1

    @classmethod
    def of(cls, fields: dict) -> "Geometry":
        """The geometry of a configuration's ``Config`` fields; fields the
        geometry does not hold (training and data settings) are left out."""
        known = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in fields.items() if k in known}
        if "event_buckets" in kw:
            kw["event_buckets"] = tuple(kw["event_buckets"])
        return cls(**kw)

    @property
    def model_width(self) -> int:
        return self.width // self.scale

    @property
    def model_height(self) -> int:
        return self.height // self.scale

    @property
    def radius_px(self) -> int:
        return int(self.radius * self.model_width) + 1

    @property
    def delta_t_us(self) -> int:
        return int(self.radius * self.time_window_us)

    @property
    def effective_radius(self) -> float:
        w = self.model_width
        return 2 * float(int(self.radius * w + 2)) / w

    def poolings(self):
        py, px = map(int, self.pooling_dim_at_output.split("x"))
        return [(1.0 / px / 2 ** (3 - i), 1.0 / py / 2 ** (3 - i), 1.0)
                for i in range(4)]

    def grid_dims(self):
        return [(int(round(1.0 / v[0])), int(round(1.0 / v[1])))
                for v in self.poolings()]

    def channels(self):
        return [1,
                int(self.base_width * 32),
                int(self.after_pool_width * 64),
                int(self.net_stem_width * 128),
                int(self.net_stem_width * 128),
                int(self.net_stem_width * 128)]

    def cart_max(self):
        """Attribute normalisers of the five levels."""
        eff = self.effective_radius
        p = self.poolings()
        return [eff, 2 * eff] + [2 * max(q[0], q[1]) for q in p[1:]]

    def layer_in_out(self):
        """(cin, cout) of the five backbone layers."""
        ch = self.channels()
        inputs = ch[:-1]
        if self.use_image:
            inputs = [inputs[i] + ch[1:][i] for i in range(5)]
        return [(inputs[i] + 2, ch[i + 1]) for i in range(5)]

    def tap_channels(self):
        _, e = LAYER_SPECS[self.img_net]
        return [64, 64 * e, 128 * e, 256 * e, 512 * e]
