"""MCAPolicy: where/how Monte-Carlo projection runs inside a model.

Port of ``repro/core/policy.py``.  ``mca_project`` runs the paper
pipeline

    importance -> Eq.9 r schedule -> tier quantization -> capacity routing
               -> block-sampled matmuls (per tier)      [mode="tiered"]
               -> per-token i.i.d. estimator            [mode="per_token"]

and returns (y, stats) with the paper's FLOPs accounting.  Stats values
that depend on the data stay device tensors; the host reads them once
per step.  While ``obs.devtel`` is enabled, each call also adds its tier
histogram to ``mca.device_tier_hist.t{i}`` on the device (one add, no
host read); under a mesh that is this rank's own routing, so
``obs.snapshot(aggregate="psum")`` gives the mesh's.

Under a mesh of more than one rank (``dist.context.use_mesh``) the
tiered routing is shard-local, as the reference's ``shard_map`` branch:
shard i routes the i-th contiguous chunk of the global flat tokens with
capacities from its own token count and the key ``fold_in(key, i)``, and
the tier histogram is summed over the ranks.  A rank that holds its rows
of the batch holds exactly chunk ``shard_index``; a rank that holds the
whole (replicated) batch routes all the chunks itself.  FLOPs and token
counts are the global batch's.

Where the global flat tokens do not divide the mesh the routing is
global, as the reference's fallback: one routing of all of them with the
capacities of their count and the unfolded key.  A rank that holds the
whole batch runs it alone; a rank that holds its data shard's rows (its
shard's tokens do not divide the ``"model"`` axis) gathers the data
ranks' tiers and importances (8 bytes a token, in rank order: the
global flat order), routes them, and runs its own rows with the global
capacities, so each tier draws the unsharded call's samples.  The tier
histogram is then the global one on every rank.

On a ``"model"`` axis larger than 1 (tensor parallelism) the routing is
the same: a rank routes every chunk its data shard holds (the chunks of
its ``"model"`` row: ``n_model`` of them, chunk i drawn from
``fold_in(key, i)`` as the data-parallel rank i would draw it), so the
model ranks route the same chunks and ``tier_hist`` sums over the data
axes only.  No weight is gathered.  ``tp="col"``: ``w`` holds this
rank's output columns; the block probabilities sum the ranks' block
norms, and the sampled product runs on the local columns.  ``tp="row"``:
``x`` and ``w`` hold this rank's input columns, placed on the whole
weight's block grid and zero-padded to the blocks they touch, so a
block split between two ranks is a block of each whose parts sum to
its product; the probabilities sum the ranks' norms of each block,
samples are drawn over every block and those outside the rank's blocks
weigh 0 (``dispatch.tiered_mca_matmul``'s ``local_blocks``), and the
caller sums the ranks' parts over ``"model"``.

The per-token mode on a model axis draws, on every model rank, the same
samples from the whole weight's block probabilities (the key is folded
with the data shard only): a column shard computes its columns, a row
shard the samples that fall in its blocks (``local_blocks`` as above).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.dist import context as dctx
from repro_torch.obs import devtel

from . import amm, dispatch, schedule

Stats = dict


@dataclasses.dataclass(frozen=True)
class MCAConfig:
    """User-facing MCA knobs. ``alpha`` is the paper's single error knob."""
    enabled: bool = False
    alpha: float = 0.2
    block: int = 128
    n_tiers: int = 4
    r_min_blocks: int = 1
    mode: str = "tiered"            # "tiered" | "per_token"
    # static capacity fractions (of token count) per tier, cheap->exact;
    # tier 0 is always unbounded.
    capacity_fracs: Tuple[float, ...] = (1.0, 0.5, 0.375, 0.25)
    sites: Tuple[str, ...] = ("v_proj", "o_proj")
    use_kernel: bool = False        # route per-tier matmuls to the kernel
    fast_colmax: bool = False       # fused conservative colmax (one pass)

    def active(self, site: str) -> bool:
        return self.enabled and site in self.sites

    def block_for(self, d: int) -> int:
        b = min(self.block, d)
        while d % b != 0:
            b //= 2
        return max(b, 1)


def _caps_for(n_tokens: int, n_tiers: int, fracs: Tuple[float, ...]
              ) -> Tuple[int, ...]:
    caps = []
    for t in range(n_tiers):
        if t == 0:
            caps.append(n_tokens)
        else:
            frac = fracs[min(t, len(fracs) - 1)]
            caps.append(max(1, int(round(frac * n_tokens))))
    return tuple(caps)


def exact_project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w)


def mca_project(key: Optional[int], x: torch.Tensor, w: torch.Tensor,
                importance: Optional[torch.Tensor], seq_len: int,
                cfg: MCAConfig, site: str, tp: Optional[str] = None
                ) -> Tuple[torch.Tensor, Stats]:
    """Project ``x @ w`` under the MCA policy.

    x: [..., n, d]; w: [d, f]; importance: [..., n] non-negative (None or
    inactive site -> exact matmul); seq_len: the ``n`` of Eq. 9; key: an
    integer key (``amm.fold_in``), None for exact.  ``tp``: None, or
    ``"col"`` / ``"row"`` when ``w`` is this rank's column- or
    row-parallel shard on a model axis (see the module doc); under
    ``"row"`` the result is this rank's part of the sum.
    """
    lead = x.shape[:-2]
    n, d = x.shape[-2], x.shape[-1]
    f = w.shape[-1]
    nm = dctx.model_size() if tp is not None else 1
    d_full = d * nm if tp == "row" else d
    f_full = f * nm if tp == "col" else f
    flat_n = math.prod(lead) * n
    shards = dctx.row_shards()           # > 1: this rank holds its rows
    exact_fl = amm.exact_flops(flat_n * shards, d_full, f_full)

    if not cfg.active(site) or importance is None or key is None:
        y = exact_project(x, w)
        return y, {"site": site, "exact_flops": exact_fl,
                   "mca_flops": exact_fl, "tokens": flat_n * shards}

    block = cfg.block_for(d_full)
    ladder = schedule.tier_ladder(d_full, block, cfg.n_tiers,
                                  cfg.r_min_blocks)

    x2 = x.reshape(flat_n, d)
    imp = importance.reshape(flat_n)
    # one boundary: its host seconds less those of its tiers (inside
    # tiered_mca_matmul) are the routing's
    with obs.timed("mca.project", cat="model"):
        r_cols = schedule.r_cols_from_attention(imp, seq_len, cfg.alpha,
                                                d_full)
        r_blocks = schedule.r_blocks_from_cols(r_cols, block)
        tier = schedule.assign_tiers(r_blocks, ladder)
        mesh = dctx.get_mesh()

        if cfg.mode == "per_token":
            if shards > 1:      # the data shard's rows draw their own
                key = amm.fold_in(key, dctx.axis_index(mesh,
                                                       dctx.dp_axes(mesh)))
            x2, w, probs, local_blocks = _tp_operands(x2, w, block, tp, mesh)
            y2 = dispatch.per_token_mca_matmul(key, x2, w, r_blocks, block,
                                               probs=probs,
                                               local_blocks=local_blocks)
            mca_fl = amm.sampled_flops(r_blocks, f_full, block)
            hist = local_hist = dispatch.tier_histogram(tier, len(ladder))
            if shards > 1:
                dp = dctx.dp_axes(mesh)
                mca_fl = dctx.psum(torch.as_tensor(mca_fl), mesh, dp)
                hist = dctx.psum(hist, mesh, dp)
        else:
            y2, hist, local_hist = _tiered_maybe_sharded(
                key, x2, w, tier, imp, ladder, cfg, block, tp)
            # int64 on the device: the sum reaches ~2e9 at d=f=3072 and a
            # few hundred tokens, where int32 would overflow
            hist64 = hist.to(torch.int64)
            mca_fl = sum(hist64[t] * (2 * r_t * block * f_full)
                         for t, r_t in enumerate(ladder))

        y = y2.reshape(*lead, n, f)
        # device-side tier occupancy, per call (the stats are read once
        # per step); a no-op unless devtel is enabled
        devtel.emit_vec(
            tuple(f"mca.device_tier_hist.t{i}" for i in range(len(ladder))),
            local_hist)
        mean_r = torch.mean(r_blocks.float())
        if shards > 1:
            mean_r = dctx.psum(mean_r, mesh, dctx.dp_axes(mesh)) / shards
        stats = {"site": site, "exact_flops": exact_fl, "mca_flops": mca_fl,
                 "tokens": flat_n * shards, "tier_hist": hist,
                 "mean_r_blocks": mean_r, "ladder": ladder}
    return y, stats


def _tp_operands(x2, w, block, tp, mesh):
    """(x2, w, the whole weight's block probabilities, local_blocks) for
    this rank's shard (see the module doc): ``"col"`` sums the ranks'
    block norms; ``"row"`` places this rank's columns on the block grid,
    zero-padding ``x2``'s columns and ``w``'s rows to the blocks they
    touch, and sums the ranks' norms of each block (a split block's is
    the sum of its parts).  The sums are differentiable, as the norms
    are at one rank."""
    if tp is None or dctx.model_size(mesh) == 1:
        return x2, w, amm.block_probs(w, block), None
    if tp == "col":
        n2 = dctx.sum_over_model(amm.block_sq_norms(w, block))
        return x2, w, amm.probs_from_sq_norms(n2), None
    d = x2.shape[1]
    off = dctx.model_index(mesh) * d
    first = off // block
    count = -(-(off + d) // block) - first
    lo = off - first * block
    hi = count * block - d - lo
    if lo or hi:
        x2 = torch.nn.functional.pad(x2, (lo, hi))
        w = torch.nn.functional.pad(w, (0, 0, lo, hi))
    k = d * dctx.model_size(mesh) // block
    n2 = torch.nn.functional.pad(amm.block_sq_norms(w, block),
                                 (first, k - first - count))
    probs = amm.probs_from_sq_norms(dctx.sum_over_model(n2))
    return x2, w, probs, (first, count)


def _tiered_maybe_sharded(key, x2, w, tier, imp, ladder, cfg, block,
                          tp=None):
    """Tiered dispatch, shard-local under a mesh of more than one rank.

    Returns (y2, tier_hist over the mesh, this rank's own tier_hist).
    Each chunk i of the global flat tokens is routed with the capacities
    of its own token count and drawn from ``fold_in(key, i)``; a rank
    holding its data shard's rows routes that shard's chunks (one, or
    ``n_model`` on a model axis) and sums the histogram over the data
    ranks, a rank holding the whole batch routes every chunk itself.
    Tokens that do not divide the mesh are routed globally
    (:func:`_tiered_global` for a rank holding its rows)."""
    n_tiers = len(ladder)
    flat_n = x2.shape[0]
    mesh = dctx.get_mesh()
    shards = dctx.row_shards()
    nm = dctx.model_size(mesh)
    x2, w, probs, local_blocks = _tp_operands(x2, w, block, tp, mesh)
    chunks = None
    if mesh is not None and mesh.size > 1:
        if shards > 1:
            if flat_n % nm:
                return _tiered_global(key, x2, w, tier, imp, ladder, cfg,
                                      block, probs, local_blocks, mesh,
                                      shards)
            n_local = flat_n // nm
            first = dctx.axis_index(mesh, dctx.dp_axes(mesh)) * nm
            chunks = [(first + j, j * n_local) for j in range(nm)]
        elif flat_n % mesh.size == 0:
            n_local = flat_n // mesh.size
            chunks = [(i, i * n_local) for i in range(mesh.size)]
    if chunks is None:
        return _tiered_global(key, x2, w, tier, imp, ladder, cfg, block,
                              probs, local_blocks, mesh, 1)

    caps = _caps_for(n_local, n_tiers, cfg.capacity_fracs)
    ys, hist = [], 0
    for i, start in chunks:
        sl = slice(start, start + n_local)
        tier_r = dispatch.apply_capacity(tier[sl], imp[sl], caps)
        ys.append(dispatch.tiered_mca_matmul(
            amm.fold_in(key, i), x2[sl], w, tier_r, imp[sl], ladder, caps,
            block, probs=probs, use_kernel=cfg.use_kernel,
            local_blocks=local_blocks))
        hist = hist + dispatch.tier_histogram(tier_r, n_tiers)
    y2 = ys[0] if len(ys) == 1 else torch.cat(ys)
    if shards > 1:
        return y2, dctx.psum(hist, mesh, dctx.dp_axes(mesh)), hist
    return y2, hist, hist


def _tiered_global(key, x2, w, tier, imp, ladder, cfg, block, probs,
                   local_blocks, mesh, shards):
    """One routing of all the mesh's tokens, with the capacities of their
    count and the unfolded key (the reference's fallback).  A rank that
    holds its data shard's rows (``shards > 1``) gathers the data ranks'
    tiers and importances in rank order, the global flat order, routes
    them, and runs its own rows with the global capacities, so each tier
    draws the samples of the unsharded call.  Returns (y2 of this rank's
    rows, the global tier_hist, this rank's rows' tier_hist)."""
    n_tiers = len(ladder)
    flat_n = x2.shape[0]
    caps = _caps_for(flat_n * shards, n_tiers, cfg.capacity_fracs)
    tier_all, imp_all = tier, imp
    if shards > 1:
        dp = dctx.dp_axes(mesh)
        tier_all = dctx.all_gather(tier, mesh, dp, 0)
        imp_all = dctx.all_gather(imp.detach(), mesh, dp, 0)
    routed = dispatch.apply_capacity(tier_all, imp_all, caps)
    hist = dispatch.tier_histogram(routed, n_tiers)
    mine, local = routed, hist
    if shards > 1:
        start = dctx.axis_index(mesh, dp) * flat_n
        mine = routed[start:start + flat_n]
        local = dispatch.tier_histogram(mine, n_tiers)
    # the rank's rows fit every global capacity: nothing is demoted again
    y2 = dispatch.tiered_mca_matmul(key, x2, w, mine, imp, ladder, caps,
                                    block, probs=probs,
                                    use_kernel=cfg.use_kernel,
                                    local_blocks=local_blocks)
    return y2, hist, local


def merge_stats(stats_list) -> Stats:
    """Aggregate FLOPs accounting across sites/layers."""
    out = {"exact_flops": 0, "mca_flops": 0}
    for s in stats_list:
        out["exact_flops"] = out["exact_flops"] + s["exact_flops"]
        out["mca_flops"] = out["mca_flops"] + s["mca_flops"]
    return out


def flops_reduction(stats: Stats):
    """The paper's headline metric: exact / MCA attention-encoding FLOPs."""
    mca = stats["mca_flops"]
    if isinstance(mca, torch.Tensor):
        return stats["exact_flops"] / torch.clamp(mca, min=1)
    return stats["exact_flops"] / max(mca, 1)
