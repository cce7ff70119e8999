"""Analytic FLOP accounting, dense vs streaming-incremental (a copy of
``eventad_tpu/utils/flops.py``, pure Python).

Reference: the asynchronous runtime logs per-layer sparse-update FLOPs
(src/dagr/asynchronous/flops/conv.py:4-37, flops/__init__.py:7-30,
aggregated by evaluate_flops.py:122-193). Here the same accounting is a pure
function of the graph statistics: for the dense pass, message FLOPs =
2 * E * basis_support * Cin (+ kernel matmul) per conv; for a streaming
delta, only edges touching changed nodes recompute.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class FlopLog:
    entries: List[dict] = field(default_factory=list)

    def add(self, layer: str, flops: float, **extra):
        self.entries.append(dict(layer=layer, flops=float(flops), **extra))

    def by_layer(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for e in self.entries:
            out[e["layer"]] = out.get(e["layer"], 0.0) + e["flops"]
        return out

    def total(self) -> float:
        return sum(e["flops"] for e in self.entries)


def spline_conv_flops(n_edges: int, cin: int, cout: int,
                      kernel_size: int = 5, n_nodes: int = 0,
                      basis_support: int = 4) -> float:
    """Dense conv cost: per-edge basis mixing + the dense kernel matmul +
    root linear (reference flops/conv.py counts 2*E*Cin*Cout for the LUT
    message; the basis-decomposed form is 2*E*S*Cin + 2*N*M*Cin*Cout)."""
    m = kernel_size * kernel_size
    msg = 2.0 * n_edges * basis_support * cin
    matmul = 2.0 * n_nodes * m * cin * cout
    root = 2.0 * n_nodes * cin * cout
    return msg + matmul + root


def streaming_conv_flops(n_changed_nodes: int, avg_degree: float, cin: int,
                         cout: int, kernel_size: int = 5) -> float:
    """Incremental cost: recompute messages only for edges whose source or
    destination changed (reference asynchronous/conv.py:94-238 semantics)."""
    e_touched = n_changed_nodes * avg_degree
    return spline_conv_flops(int(e_touched), cin, cout, kernel_size,
                             n_nodes=n_changed_nodes)


def backbone_flops(bc, n_events: int, avg_degree: float = 12.0,
                   log: FlopLog = None, streaming_changed: int = 0
                   ) -> FlopLog:
    """Per-layer FLOPs of the GNN pyramid at given occupancy.

    ``streaming_changed`` > 0 accounts an incremental update touching that
    many level-0 nodes instead of a dense pass."""
    from ..models.backbone import layer_in_out_channels
    log = log or FlopLog()
    pairs = layer_in_out_channels(bc)
    grids = bc.grids
    n_nodes = n_events
    changed = streaming_changed
    for li, (cin, cout) in enumerate(pairs):
        edges = n_nodes * avg_degree
        for blk in ("block1", "block2"):
            c_in = cin if blk == "block1" else cout
            if streaming_changed > 0:
                f = streaming_conv_flops(changed, avg_degree, c_in, cout,
                                         bc.kernel_size)
            else:
                f = spline_conv_flops(int(edges), c_in, cout,
                                      bc.kernel_size, n_nodes=n_nodes)
            log.add(f"layer{li+1}.{blk}", f, nodes=n_nodes)
        log.add(f"layer{li+1}.skip", 2.0 * n_nodes * cin * cout)
        if li < 4:
            nx, ny = grids[li]
            n_nodes = min(n_nodes, bc.batch_size * nx * ny)
            changed = min(changed, n_nodes)
    return log
