"""Torch-only worker functions of the multi-process tests: each child
process of ``eventad_tpu_torch.parallel.launch.spawn`` imports this module
(and so no JAX) and runs one of them on its rank."""
import os
import warnings
from pathlib import Path

from eventad_tpu_torch.parallel.launch import spawn
from eventad_tpu_torch.parallel.mesh import make_mesh
from eventad_tpu_torch.tools.dryrun_multichip import (detector_case,
                                                      head_case)

HERE = Path(__file__).resolve().parent
# the head's cases: the fixture geometry, 2 items a rank
HEAD = dict(batch_per_rank=2, n_events=1024, use_image=False, lookback=256)
DETECTOR = dict(batch_per_rank=1, n_events=512, lookback=128, steps=2,
                lr=1e-3)


def run(target: str, world: int, **kwargs) -> list:
    """``spawn`` of ``_torch_dist:<target>`` with this directory on the
    children's path."""
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(HERE), old) if p)
    try:
        return spawn(f"_torch_dist:{target}", world, kwargs=kwargs,
                     timeout=300)
    finally:
        if old is None:
            del os.environ["PYTHONPATH"]
        else:
            os.environ["PYTHONPATH"] = old


def mesh_and_steps(weights: str) -> dict:
    """On 4 ranks: the mesh shapes and the degrade rule, the head's data
    parallel steps on a 2x2 mesh (dropout on; and, from ``weights``,
    dropout off) and two dp x tp detector steps on it."""
    shapes = {spec: tuple(make_mesh(spec).mesh.shape)
              for spec in ("2x2", "4", "1x4")}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        degraded = tuple(make_mesh("4x2").mesh.shape)
    try:
        make_mesh("3")
        partial_raises = False
    except ValueError:
        partial_raises = True
    return dict(
        shapes=shapes, degraded=degraded,
        degrade_warned=any("degrading" in str(w.message) for w in caught),
        partial_raises=partial_raises,
        head=head_case("2x2", dropout=True, steps=1, **HEAD),
        head_from_jax=head_case("2x2", dropout=False, steps=1,
                                weights=weights, **HEAD),
        detector=detector_case("2x2", **DETECTOR))


def seq_case_world(**kwargs) -> list:
    """``seq_case`` over a mesh of every rank."""
    import torch.distributed as dist
    from eventad_tpu_torch.tools.dryrun_multichip import seq_case
    return seq_case(str(dist.get_world_size()), **kwargs)