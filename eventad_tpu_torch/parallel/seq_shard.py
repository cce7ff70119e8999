"""Event-axis sequence parallelism for the frozen feature path of one long
stream (counterpart of ``eventad_tpu/parallel/seq_shard.py``).

The level-0 stage (neighbour search and the first layer, nearly all the
nodes) needs only a ``lookback`` halo of earlier events, while the pooled
levels are small cell tables that are cheapest replicated.  So:

* the stream ``[N]`` is cut into ``D`` contiguous blocks (events are
  time-sorted, so a block is a time slice), one per rank of the mesh's
  axis;
* the per-pixel queue ranks are computed on the whole stream on every rank
  before the blocks are cut, so the search's eviction cannot depend on
  where a block starts;
* each rank sends its whole block to the next rank (one
  ``batch_isend_irecv``; ``2 * lookback <= block`` makes that enough):
  its destinations reach back ``lookback`` events, and their second conv
  reads first-conv outputs up to ``lookback`` further back, so the first
  conv also runs on the halo's last ``lookback`` rows;
* the level-1 outputs and neighbour tables of the blocks are gathered
  (one ``all_gather`` a table) and the replicated finish is the streaming
  path's: ``backbone_forward(start_level=1, pos_src0=...)``.

The result equals the single-process streaming ``refresh`` on the same
stream (``tests/test_torch_seq_shard.py``), itself equal to the batch path.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.backbone import backbone_forward, level0_attr_range
from ..models.graph import Graph
from ..ops.event_graph import build_graph_auto, queue_rank
from ..ops.gather_window import gather_window_rows
from ..ops.norm import batch_norm
from ..ops.spline_basis import ACTS
from ..ops.spline_conv import offset_attr, spline_conv
from ..streaming.incremental import input_rows, norm_pos
from ..utils.tensors import constant

HALO_RANK = 10 ** 6   # rank 0's empty halo: invalid events at pixel 0


def check_blocks(n: int, d: int, lookback: int) -> int:
    """The block of ``n`` events over ``d`` ranks; raises ``ValueError``
    unless ``d`` divides ``n`` and ``2 * min(lookback, block) <= block``."""
    blk = n // d
    if blk * d != n:
        raise ValueError(f"seq shard: {n} events do not divide over {d} "
                         f"ranks")
    lb = min(lookback, blk)
    if 2 * lb > blk:
        raise ValueError(f"seq shard needs 2*lookback <= block "
                         f"({2 * lb} > {blk})")
    return blk


def _halo(block: torch.Tensor, idx: int, d: int, group) -> torch.Tensor:
    """The previous rank's ``block`` (one send to the next rank each), or
    None on rank 0."""
    ops = []
    recv = None
    if idx + 1 < d:
        ops.append(dist.P2POp(dist.isend, block,
                              dist.get_global_rank(group, idx + 1), group))
    if idx > 0:
        recv = torch.empty_like(block)
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, idx - 1), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return recv


def seq_sharded_level0(model, bc, gsc, pos, polarity, valid, image_feats,
                       mesh, axis: str = "data"):
    """The graph build and the level-0 layer over the event axis.

    Every rank passes the whole stream: ``pos [N, 3]`` int32 (time-sorted,
    absolute t), ``polarity [N]``, ``valid [N]``, and ``image_feats`` (the
    CNN pyramid with maps 0 and 1 upsampled to full resolution, as
    ``streaming.incremental.update_image`` keeps it) or None.  Returns the
    whole stream's ``(h1 [N, C1], img1 [N, Cimg], nbr [N, K] global,
    nbr_mask [N, K], off [N, K, 2])`` on every rank."""
    (radius_px, delta_t_us, max_nb, max_q, lookback, width, height,
     _tw) = gsc
    n = pos.shape[0]
    d = mesh[axis].size()
    blk = check_blocks(n, d, lookback)
    lb = min(lookback, blk)
    group = mesh.get_group(axis)
    idx = mesh.get_local_rank(axis)
    dev = pos.device

    # global queue ranks, before the blocks are cut
    ranks = queue_rank(pos[:, 1] * width + pos[:, 0], valid)
    t_now = torch.where(valid, pos[:, 2], 0).max()
    own = slice(idx * blk, (idx + 1) * blk)
    block = torch.cat([pos[own], polarity[own, None].view(torch.int32),
                       valid[own, None].to(torch.int32),
                       ranks[own, None]], 1).contiguous()
    halo = _halo(block, idx, d, group)
    if halo is None:
        halo = torch.zeros_like(block)
        halo[:, 5] = HALO_RANK
    win = torch.cat([halo, block])                       # [2 blk, 6]
    win_pos = win[:, :3].contiguous()
    win_pol = win[:, 3].contiguous().view(torch.float32)
    win_val = win[:, 4] > 0
    nbr, nbrm, off = (t[0] for t in build_graph_auto(
        win_pos[None], win_val[None], win[None, :, 5].contiguous(),
        radius=radius_px, delta_t_us=delta_t_us, max_neighbors=max_nb,
        max_queue_size=max_q, lookback=lb, grid_wh=(width, height)))

    posn = norm_pos(win_pos, t_now, gsc)
    x_in, img1 = input_rows(image_feats, posn, win_pol, win_val, bc)
    layer = model.dagr.backbone.layers[0]
    act = ACTS[bc.activation]
    fold = bc.aggr == "sum"
    s0 = 1 if fold else 0
    kw = dict(kernel_size=bc.kernel_size, aggr=bc.aggr,
              attr_range=level0_attr_range(bc), add_center_to_root=fold)

    def conv(src, rows, conv_p):
        nb, nm = nbr[rows, s0:].contiguous(), nbrm[rows, s0:].contiguous()
        attr = offset_attr(off[rows, s0:], nm, bc.cart_max[0], width, height)
        return spline_conv(src, nb, nm, attr, conv_p, x_dst=src[rows],
                           x_j=gather_window_rows(src, nb, nm, lookback=lb),
                           **kw)

    # block 1 for the halo's tail and the rank's block (their outputs feed
    # the block's block-2 gathers); rows below blk - lb are never read
    lo = slice(blk - lb, 2 * blk)
    h = batch_norm(conv(x_in, lo, layer.block1.conv), win_val[lo],
                   layer.block1.bn)
    h_b1 = torch.zeros((2 * blk, h.shape[1]), device=dev)
    h_b1[lo] = torch.where(win_val[lo, None], act(h), 0.0)
    # block 2 and the skip for the rank's block
    mine = slice(blk, 2 * blk)
    dmask = win_val[mine]
    h2 = batch_norm(conv(h_b1, mine, layer.block2.conv), dmask,
                    layer.block2.bn)
    skip = batch_norm(x_in[mine] @ layer.skip_lin + layer.skip_lin_bias,
                      dmask, layer.skip_bn)
    h1 = torch.where(dmask[:, None], act(h2 + skip), 0.0)
    # window rows -> stream rows (window row 0 is stream row idx*blk - blk)
    nbr_g = torch.where(nbrm[mine], nbr[mine] + (idx - 1) * blk, 0)

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(d)]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts)
    return (gather(h1), gather(img1[mine]), gather(nbr_g),
            gather(nbrm[mine].to(torch.uint8)).bool(), gather(off[mine]))


@torch.no_grad()
def seq_sharded_features(model, bc, gsc, pos, polarity, valid, image_feats,
                         mesh, axis: str = "data"):
    """The frozen feature extraction of one stream with the level-0 stage
    sharded over the event axis and the pooled levels replicated: the
    ``(out3, out4)`` graphs of ``streaming.incremental.
    pooled_backbone_outs`` after a ``refresh`` of the same stream."""
    (_r, _d, _k, _q, _l, width, height, _tw) = gsc
    h1, img1, nbr, nbrm, off = seq_sharded_level0(
        model, bc, gsc, pos, polarity, valid, image_feats, mesh, axis)
    x1 = torch.cat([h1, img1], 1) if bc.use_image else h1
    t_now = torch.where(valid, pos[:, 2], 0).max()
    posn = norm_pos(pos, t_now, gsc)
    g = Graph(x1, posn, nbr, nbrm, valid,
              torch.zeros((pos.shape[0],), dtype=torch.int32,
                          device=pos.device))
    wh = constant((width, height), torch.float32, pos.device)
    pos_src0 = (pos[:, None, :2] - off).to(torch.float32) / wh
    return backbone_forward(model.dagr.backbone, g, image_feats, bc,
                            start_level=1, pos_src0=pos_src0)
