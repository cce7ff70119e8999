"""Batch assembly and the host loader (counterpart of
``eventad_tpu/data/batching.py``).

A batch is static-shaped: events padded to the smallest bucket that fits
the largest item (the most recent kept when an item overflows the largest,
the invalid tail at ``t = 0``), boxes scattered into ``max_boxes + 1``
track slots per frame, and fixed-size raw box lists for the detection
metrics.  ``collate`` returns the port's :class:`EventBatch` of CPU
tensors.  The TPU staging fields (``search_starts``, ``image_s2d``) are not
carried, nor the optional host ``pool_tables`` (the pooling computes its
cell sums from the events), nor the previous frame's raw detection list
``bbox0`` (only its mask, which the evaluation loop reads).

:class:`Loader` batches a dataset serially, on a prefetch thread, or in
spawned decode processes that hand numpy arrays back through shared-memory
slots; the parent makes the tensors, and the workers see no CUDA device.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Iterator, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..native import queue_ranks  # noqa: F401  (re-exported)

# raw-detection slots per item: one number for the batch arrays and the
# shared-memory slot layout
MAX_DETECTIONS = 64


class EventBatch(NamedTuple):
    """One batch, every field a tensor (layouts as in the JAX package)."""
    pos: torch.Tensor          # [B, N, 3] int32 (x, y, t_us)
    polarity: torch.Tensor     # [B, N] float32 +-1
    valid: torch.Tensor        # [B, N] bool
    rank: torch.Tensor         # [B, N] int32 per-pixel recency rank
    image: torch.Tensor        # [B, H, W, 3] float32 in [0, 1]
    boxes: torch.Tensor        # [B, 2, S, 4] float32 xywh pixels
    box_present: torch.Tensor  # [B, 2, S] bool
    box_labels: torch.Tensor   # [B, S] int32
    bbox_mask: torch.Tensor    # [B, D] bool, raw current-frame detections
    bbox0_mask: torch.Tensor   # [B, D] bool, raw previous-frame detections
    bbox: torch.Tensor         # [B, D, 6] float32 (x, y, w, h, class, track)

    def to(self, device) -> "EventBatch":
        return EventBatch(*(a.to(device) for a in self))

    def is_empty(self) -> bool:
        """No current-frame box in the whole batch: the training and
        evaluation loops skip such a batch."""
        return not bool(self.bbox_mask.any())


@dataclasses.dataclass
class BatchMeta:
    """Host-side metadata the metrics pipeline needs."""
    sequences: List[str]
    frame_ids: List[int]
    n_items: int
    # events dropped because an item overflowed the largest padding bucket
    # (most recent kept); surfaced so truncation is never silent
    truncated_events: int = 0


def _batch_specs(cfg: Config, n_cap: int, d: int = MAX_DETECTIONS):
    """(field, dtype, shape) of every EventBatch array, in field order."""
    b, s = cfg.batch_size, cfg.max_boxes + 1
    h, w = cfg.model_height, cfg.model_width
    return [
        ("pos", np.int32, (b, n_cap, 3)),
        ("polarity", np.float32, (b, n_cap)),
        ("valid", np.bool_, (b, n_cap)),
        ("rank", np.int32, (b, n_cap)),
        ("image", np.float32, (b, h, w, 3)),
        ("boxes", np.float32, (b, 2, s, 4)),
        ("box_present", np.bool_, (b, 2, s)),
        ("box_labels", np.int32, (b, s)),
        ("bbox_mask", np.bool_, (b, d)),
        ("bbox0_mask", np.bool_, (b, d)),
        ("bbox", np.float32, (b, d, 6)),
    ]


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _slot_boxes(bbox: np.ndarray, max_boxes: int):
    """First box per track id -> slot arrays (EventAD.py:237-239 takes the
    first matching bbox index)."""
    s = max_boxes + 1
    out = np.zeros((s, 4), np.float32)
    present = np.zeros((s,), bool)
    labels = np.zeros((s,), np.int32)
    for row in bbox:
        tid = int(row[5])
        if tid < 1 or tid > max_boxes or present[tid]:
            continue
        out[tid] = row[:4]
        present[tid] = True
        labels[tid] = int(row[4])
    return out, present, labels


def collate_arrays(items: list, cfg: Config,
                   max_detections: int = MAX_DETECTIONS) -> tuple:
    """Pads a list of Items into ``(arrays, BatchMeta)``: ``arrays`` the
    numpy arrays of the :class:`EventBatch` fields, in field order."""
    n_max = max((len(it.events["t"]) for it in items), default=1)
    n_cap = pick_bucket(max(n_max, 1), cfg.event_buckets)
    arrays = {name: np.zeros(shape, dt) for name, dt, shape in
              _batch_specs(cfg, n_cap, max_detections)}
    arrays["rank"][:] = 2 ** 30
    h, w = cfg.model_height, cfg.model_width

    seqs, fids = [], []
    truncated = 0
    for b, it in enumerate(items[:cfg.batch_size]):
        n_all = len(it.events["t"])
        n = min(n_all, n_cap)
        truncated += n_all - n
        # keep the most recent events when over budget (the reference's
        # sliding window favours recency)
        sl = slice(n_all - n, n_all)
        pos = arrays["pos"][b]
        pos[:n, 0] = it.events["x"][sl]
        pos[:n, 1] = it.events["y"][sl]
        pos[:n, 2] = it.events["t"][sl]
        arrays["polarity"][b, :n] = it.events["p"][sl].astype(
            np.float32).reshape(-1)
        arrays["valid"][b, :n] = True
        arrays["rank"][b, :n] = queue_ranks(pos[:n, 0], pos[:n, 1], w, h)
        arrays["image"][b] = it.image.astype(np.float32) / 255.0
        b1, p1, l1 = _slot_boxes(it.bbox, cfg.max_boxes)
        b0, p0, _ = _slot_boxes(it.bbox0, cfg.max_boxes)
        arrays["boxes"][b, 1], arrays["box_present"][b, 1] = b1, p1
        arrays["box_labels"][b] = l1
        arrays["boxes"][b, 0], arrays["box_present"][b, 0] = b0, p0
        d1 = min(len(it.bbox), max_detections)
        arrays["bbox"][b, :d1] = it.bbox[:d1]
        arrays["bbox_mask"][b, :d1] = True
        arrays["bbox0_mask"][b, :min(len(it.bbox0), max_detections)] = True
        seqs.append(it.sequence)
        fids.append(it.frame_id)
    return arrays, BatchMeta(seqs, fids, len(items[:cfg.batch_size]),
                             truncated)


def _to_batch(arrays) -> EventBatch:
    return EventBatch(**{k: torch.from_numpy(v) for k, v in arrays.items()})


def collate(items: list, cfg: Config,
            max_detections: int = MAX_DETECTIONS) -> tuple:
    """Pads a list of Items into ``(EventBatch of CPU tensors,
    BatchMeta)``."""
    arrays, meta = collate_arrays(items, cfg, max_detections)
    return _to_batch(arrays), meta


def _slot_layout(cfg: Config):
    """Field -> (offset, dtype, max_shape) within one shared-memory slot,
    sized for the largest event bucket."""
    layout, off = {}, 0
    for name, dt, shape in _batch_specs(cfg, cfg.event_buckets[-1]):
        nbytes = int(np.prod(shape)) * np.dtype(dt).itemsize
        layout[name] = (off, dt, shape)
        off += -(-nbytes // 128) * 128     # keep fields 128B-aligned
    return layout, off


def _slot_views(buf, layout, n_cap):
    """numpy views into a slot for the actual bucket size ``n_cap``."""
    views = {}
    for name, (off, dt, shape) in layout.items():
        a = np.ndarray(shape, dtype=dt, buffer=buf, offset=off)
        if name in ("pos", "polarity", "valid", "rank"):
            a = a[:, :n_cap]
        views[name] = a
    return views


def _decode_worker(ds, cfg, shm_names, taskq, freeq, outq):
    """Persistent decode worker (module-level so "spawn" can pickle it by
    reference).  Loops on ``taskq`` tasks ``(epoch, batch_idx,
    item_indices)``, decodes + collates into a free shared-memory slot and
    sends only ``(epoch, batch_idx, slot, n_cap, meta)``; the arrays ride
    shared memory.  A ``None`` task shuts the worker down.  Decode errors
    are reported as ``(epoch, None, 0, 0, exception)`` and the worker keeps
    serving.  The worker hides every CUDA device from itself first (torch
    initialises CUDA lazily): the parent owns the card."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    from multiprocessing import shared_memory
    shms = []
    try:
        layout, _ = _slot_layout(cfg)
        # a spawned worker shares the parent's resource tracker, so its
        # attachment is the parent's registration; the parent unlinks
        shms = [shared_memory.SharedMemory(name=nm) for nm in shm_names]
        while True:
            task = taskq.get()
            if task is None:
                break
            ep, i, idx = task
            try:
                arrays, meta = collate_arrays([ds[int(j)] for j in idx], cfg)
                n_cap = arrays["pos"].shape[1]
                slot = freeq.get()
                try:
                    views = _slot_views(shms[slot].buf, layout, n_cap)
                    for name, arr in arrays.items():
                        np.copyto(views[name], arr)
                except BaseException:
                    # never leak the slot
                    freeq.put(slot)
                    raise
                outq.put((ep, i, slot, n_cap, meta))
            except Exception as e:  # reported to the consumer
                outq.put((ep, None, 0, 0, e))
    finally:
        for shm in shms:
            shm.close()


class Loader:
    """Host loader: sequential or shuffled batching, serial, on a prefetch
    thread, or in spawned decode processes (the reference's torch
    ``DataLoader`` with ``num_workers=4``, config/eventad_config.py:121).

    ``num_workers >= 2`` (and at least ``2 * num_workers`` batches) starts a
    persistent pool of decode processes (decode + collate per batch,
    results through shared-memory slots); the parent reorders and yields in
    batch order.  Else ``prefetch > 0`` decodes on one thread, else in the
    caller's.  Every mode yields the same batches.  The dataset is pickled
    to the workers (h5 handles dropped; each reopens its own).
    ``truncated_events`` counts the events dropped by overflowing items;
    the first truncation warns.  ``close()`` stops the pool."""

    def __init__(self, dataset, cfg: Config, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False,
                 prefetch: int = 2, num_workers: Optional[int] = None):
        self.ds = dataset
        self.cfg = cfg
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        # more decode processes than cores only adds overhead
        self.num_workers = (min(cfg.num_workers, os.cpu_count() or 1)
                            if num_workers is None else num_workers)
        self._epoch = 0
        self._pool = None
        self.truncated_events = 0
        self._warned_truncation = False

    def _note_truncation(self, meta: BatchMeta):
        self.truncated_events += meta.truncated_events
        if meta.truncated_events and not self._warned_truncation:
            warnings.warn(
                f"event window exceeded the largest padding bucket "
                f"({self.cfg.event_buckets[-1]}); dropped "
                f"{meta.truncated_events} oldest events (counter on "
                f"Loader.truncated_events)")
            self._warned_truncation = True

    def __len__(self):
        n = len(self.ds)
        b = self.cfg.batch_size
        return n // b if self.drop_last else -(-n // b)

    def mode(self) -> str:
        """How the next epoch decodes: "processes", "thread" or
        "serial"."""
        if self.num_workers >= 2 and len(self) >= 2 * self.num_workers:
            return "processes"
        return "thread" if self.prefetch > 0 else "serial"

    def _order(self):
        idx = np.arange(len(self.ds))
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self._epoch)
            rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[tuple]:
        mode = self.mode()
        order = self._order()
        self._epoch += 1
        n_batches = len(self)
        if mode == "processes":
            it = self._iter_processes(order, n_batches)
        elif mode == "thread":
            it = self._iter_thread(order, n_batches)
        else:
            it = self._iter_serial(order, n_batches)
        for batch, meta in it:
            self._note_truncation(meta)
            yield batch, meta

    def _chunk(self, order, i):
        b = self.cfg.batch_size
        return order[i * b:(i + 1) * b]

    def _iter_serial(self, order, n_batches):
        for i in range(n_batches):
            items = [self.ds[int(j)] for j in self._chunk(order, i)]
            yield collate(items, self.cfg)

    def _iter_thread(self, order, n_batches):
        import queue
        import threading

        def produce(q):
            try:
                for out in self._iter_serial(order, n_batches):
                    q.put(out)
                q.put(None)
            except Exception as e:  # surfaced to the consumer
                q.put(e)

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        th = threading.Thread(target=produce, args=(q,), daemon=True)
        th.start()
        while True:
            out = q.get()
            if out is None:
                break
            if isinstance(out, Exception):
                raise out
            yield out

    def _ensure_pool(self):
        """Starts the persistent decode pool once per Loader (spawning
        costs seconds; it is paid once, not per epoch)."""
        if self._pool is not None:
            return self._pool
        import multiprocessing as mp
        from multiprocessing import shared_memory
        ctx = mp.get_context("spawn")
        nw = self.num_workers
        layout, slot_bytes = _slot_layout(self.cfg)
        n_slots = 2 * nw + 2
        shms = [shared_memory.SharedMemory(create=True, size=slot_bytes)
                for _ in range(n_slots)]
        taskq, freeq, outq = ctx.Queue(), ctx.Queue(), ctx.Queue()
        for s in range(n_slots):
            freeq.put(s)
        procs = [ctx.Process(target=_decode_worker,
                             args=(self.ds, self.cfg,
                                   [m.name for m in shms], taskq, freeq,
                                   outq),
                             daemon=True)
                 for _ in range(nw)]
        self._pool = dict(procs=procs, shms=shms, layout=layout,
                          taskq=taskq, freeq=freeq, outq=outq)
        for p in procs:
            p.start()
        return self._pool

    def close(self):
        """Shuts down the decode pool (idempotent)."""
        pool, self._pool = self._pool, None
        if pool is None:
            return
        for _ in pool["procs"]:
            pool["taskq"].put(None)
        for p in pool["procs"]:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for m in pool["shms"]:
            m.close()
            try:
                m.unlink()
            except FileNotFoundError:
                pass

    def __del__(self):
        try:
            self.close()
        except Exception:  # interpreter shutdown: queues may be gone
            pass

    def _iter_processes(self, order, n_batches):
        import queue
        pool = self._ensure_pool()
        # epoch tag: results of an abandoned earlier epoch (the caller broke
        # out of the iterator) are dropped and their slots recycled
        ep = self._epoch
        for i in range(n_batches):
            pool["taskq"].put((ep, i,
                               [int(j) for j in self._chunk(order, i)]))
        pending: dict = {}
        nxt = 0
        while nxt < n_batches:
            if nxt in pending:
                yield pending.pop(nxt)
                nxt += 1
                continue
            try:
                rep, i, slot, n_cap, meta = pool["outq"].get(timeout=30)
            except queue.Empty:
                # liveness check: a worker killed by the OS (OOM) would
                # otherwise block the consumer forever
                dead = [p for p in pool["procs"] if not p.is_alive()]
                if dead:
                    raise RuntimeError(
                        f"{len(dead)} decode worker(s) died "
                        f"(exitcodes {[p.exitcode for p in dead]})")
                continue
            if i is None:
                if rep == ep:
                    raise meta
                continue                     # stale-epoch error: dropped
            if rep != ep:
                pool["freeq"].put(slot)      # stale-epoch result: recycled
                continue
            views = _slot_views(pool["shms"][slot].buf, pool["layout"],
                                n_cap)
            arrays = {k: np.array(v) for k, v in views.items()}
            pool["freeq"].put(slot)
            pending[i] = (_to_batch(arrays), meta)
