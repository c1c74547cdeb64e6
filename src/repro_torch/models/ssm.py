"""Mamba-2 (SSD, state-space duality) layer — chunked scan, plain PyTorch.

Port of ``repro/models/ssm.py``: the SSD algorithm of arXiv:2405.21060,
an intra-chunk quadratic (semiseparable) term plus an inter-chunk state
recurrence.  MCA does not apply here (no attention matrix), so the layer
runs exact, and the reference has no Pallas kernel on this path: the
scan, the conv and the decode step are plain tensor code in both
packages.

The state is f32 (``a = -exp(a_log)``, dt = softplus(dt_raw + dt_bias));
activations keep the model dtype.

On a ``"model"`` axis whose size divides the SSD heads (and the groups,
unless there is one; :func:`heads_split`) a rank computes its heads, as
the reference's ``constrain_heads`` places them.  ``in_proj`` is
column-parallel over its ``[z | x | B | C | dt]`` columns, whose
contiguous split cuts through the segments, so its output is gathered
over ``"model"`` (B x S x its columns, no weight moved) and each rank
takes its heads' z, x and dt and the whole B and C (its groups' with
several).  The replicated conv convolves those channels; the gated
RMSNorm's sum of squares over the whole inner width is summed over
``"model"``; ``out_proj``'s rows, ordered by head, are the rank's, and
the parts are summed over ``"model"`` in f32.  The decode cache holds
the rank's heads' state and its channels' conv tail (the reference
places both replicated: a difference of placement, not of value).
Otherwise every rank computes every head.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist import context as dctx
from .common import dense_init, rmsnorm


def init_mamba2(g: torch.Generator, cfg, device):
    dt = cfg.torch_dtype
    d_in = cfg.ssm_inner
    ng, n = cfg.ssm_groups, cfg.ssm_state
    h = cfg.ssm_heads
    conv_ch = d_in + 2 * ng * n
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = torch.randn((cfg.conv_width, conv_ch), generator=g, **f32) * 0.1
    return {
        "in_proj": dense_init(g, cfg.d_model, 2 * d_in + 2 * ng * n + h, dt,
                              device),
        "conv_w": conv_w.to(dt),
        "conv_b": torch.zeros((conv_ch,), dtype=dt, device=device),
        "a_log": torch.zeros((h,), **f32),              # A = -exp(0) = -1
        "d_skip": torch.ones((h,), **f32),
        "dt_bias": torch.zeros((h,), **f32),
        "norm": torch.zeros((d_in,), **f32),
        "out_proj": dense_init(g, d_in, cfg.d_model, dt, device),
    }


def causal_conv1d(x, w, b):
    """Depthwise causal conv. x: [B,S,C]; w: [W,C]; left-pad W-1."""
    width = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, width - 1, 0))
    out = sum(xp[:, i:i + s] * w[i][None, None] for i in range(width))
    return out + b[None, None]


def ssd_chunked(xs, dt, a, bmat, cmat, chunk):
    """SSD forward. xs: [B,S,H,P]; dt: [B,S,H] f32; a: [H] f32 (negative);
    bmat/cmat: [B,S,G,N]; H % G == 0, S % chunk == 0.  Returns
    (y [B,S,H,P] in xs.dtype, final state [B,G,HG,N,P] f32).

    The reference scans over chunks, computing each chunk's intra-chunk
    term in the scan body.  Here that term is one batched einsum over all
    chunks (scores times decay contracted first, so no [.., q, q, g, hg,
    p] product is built), and only the inter-chunk state recurrence is a
    Python loop: the same arithmetic with fewer launches."""
    b, s, h, p = xs.shape
    g, n = bmat.shape[2], bmat.shape[3]
    hg = h // g
    q = chunk
    nc = s // q
    da = (dt * a[None, None]).reshape(b, nc, q, g, hg)        # log-decay
    xc = xs.float().reshape(b, nc, q, g, hg, p)
    dtc = dt.reshape(b, nc, q, g, hg)
    bc = bmat.float().reshape(b, nc, q, g, n)
    cc = cmat.float().reshape(b, nc, q, g, n)
    cum = torch.cumsum(da, dim=2)                             # [b,c,q,g,hg]
    xdt = xc * dtc[..., None]                                 # [b,c,q,g,hg,p]

    # intra-chunk: causal-masked decay kernel; the mask is applied before
    # the exp, so masked entries are exp(-inf) = 0 (the reference zeroes
    # them after) and the backward never meets an overflowed exp
    scores = torch.einsum("bcign,bcjgn->bcijg", cc, bc)      # [b,c,q,q,g]
    causal = torch.ones((q, q), dtype=torch.bool, device=xs.device).tril()
    diff = cum[:, :, :, None] - cum[:, :, None]               # [b,c,i,j,g,hg]
    ldec = torch.exp(torch.where(causal[:, :, None, None], diff,
                                 float("-inf")))
    y = torch.einsum("bcijgh,bcjghp->bcighp", scores[..., None] * ldec, xdt)

    # inter-chunk: each chunk's own state contribution, then the carried
    # state recurrence (two ops a chunk) and its read-out in one einsum
    decay_out = torch.exp(cum[:, :, -1:] - cum)               # [b,c,q,g,hg]
    state_c = torch.einsum("bcjgn,bcjghp->bcghnp", bc,
                           xdt * decay_out[..., None])
    total = torch.exp(cum[:, :, -1])[..., None, None]         # [b,c,g,hg,1,1]
    state = torch.zeros((b, g, hg, n, p), dtype=torch.float32,
                        device=xs.device)
    carried = []
    for c in range(nc):
        carried.append(state)
        state = state * total[:, c] + state_c[:, c]
    y_inter = torch.einsum("bcign,bcghnp->bcighp", cc,
                           torch.stack(carried, dim=1)) \
        * torch.exp(cum)[..., None]
    y = (y + y_inter).reshape(b, s, h, p)
    return y.to(xs.dtype), state


def ssd_sequential(xs, dt, a, bmat, cmat):
    """O(S) sequential oracle for tests."""
    b, s, h, p = xs.shape
    g, n = bmat.shape[2], bmat.shape[3]
    hg = h // g
    xf = xs.reshape(b, s, g, hg, p).float()
    dtf = dt.reshape(b, s, g, hg)
    bf, cf = bmat.float(), cmat.float()
    a_g = a.reshape(g, hg)[None]
    state = torch.zeros((b, g, hg, n, p), dtype=torch.float32,
                        device=xs.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * a_g)                    # [b,g,hg]
        upd = torch.einsum("bgn,bghp->bghnp", bf[:, t],
                           xf[:, t] * dtf[:, t, ..., None])
        state = state * decay[..., None, None] + upd
        ys.append(torch.einsum("bgn,bghnp->bghp", cf[:, t], state))
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y.to(xs.dtype), state


def heads_split(cfg) -> bool:
    """Whether a rank computes only its own SSD heads on the active
    mesh's model axis: it divides the heads and, with several groups,
    the groups."""
    nm = dctx.model_size()
    g = cfg.ssm_groups
    return nm > 1 and cfg.ssm_heads % nm == 0 and (g == 1 or g % nm == 0)


def _local(cfg):
    """(this rank's heads, its groups) as slices, and the inner width's
    channels of its heads (everything without :func:`heads_split`)."""
    h, g, ph = cfg.ssm_heads, cfg.ssm_groups, cfg.ssm_headdim
    if not heads_split(cfg):
        return slice(0, h), slice(0, g), slice(0, h * ph)
    hs = dctx.model_slice(h)
    gs = slice(0, 1) if g == 1 else dctx.model_slice(g)
    return hs, gs, slice(hs.start * ph, hs.stop * ph)


def _split_zxbcdt(zxbcdt, cfg):
    """(z, pre-conv xBC, dt_raw) of this rank's heads from the whole
    ``in_proj`` output (module doc), and the matching conv channels."""
    d_in = cfg.ssm_inner
    g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    if not heads_split(cfg):
        return (zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * g * n],
                zxbcdt[..., -h:], slice(0, d_in + 2 * g * n))
    hs, gs, ch = _local(cfg)
    b0 = 2 * d_in
    bc = [slice(b0 + gs.start * n, b0 + gs.stop * n),
          slice(b0 + (g + gs.start) * n, b0 + (g + gs.stop) * n)]
    cols = [slice(d_in + ch.start, d_in + ch.stop)] + bc
    conv = torch.cat([torch.arange(c.start - d_in, c.stop - d_in)
                      for c in cols]).to(zxbcdt.device)
    xbc = torch.cat([zxbcdt[..., c] for c in cols], dim=-1)
    return (zxbcdt[..., ch], xbc,
            zxbcdt[..., b0 + 2 * g * n + hs.start:b0 + 2 * g * n + hs.stop],
            conv)


def _shared(p):
    """The block's replicated parameters, each rank's use of which gives
    a part of their gradient (summed over ``"model"``)."""
    return {k: v if k in ("in_proj", "out_proj") else dctx.copy_to_model(v)
            for k, v in p.items()}


def _gated_norm(y, z, p, cfg, ch):
    """RMSNorm over the whole inner width, gated by silu(z): with the
    heads split, the sum of squares summed over ``"model"``."""
    if not heads_split(cfg):
        return rmsnorm(y, p["norm"], cfg.norm_eps) * F.silu(z)
    yf = y.float()
    ss = dctx.sum_over_model(torch.sum(torch.square(yf), dim=-1,
                                       keepdim=True))
    var = ss / cfg.ssm_inner
    out = (yf * torch.rsqrt(var + cfg.norm_eps)) * (1.0 + p["norm"][ch])
    return out.to(y.dtype) * F.silu(z)


def mamba2_forward(p, cfg, x, *, return_state=False):
    """Full-sequence Mamba-2 block. x: [B, S, d_model].  With
    ``return_state`` also returns the final SSD state [B,G,HG,N,P] (f32)
    and the decode conv cache: the last ``conv_width - 1``
    PRE-activation xBC rows (on a model axis, this rank's heads and
    channels: module doc)."""
    b, s, _ = x.shape
    d_in = cfg.ssm_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    h = cfg.ssm_heads
    ph = cfg.ssm_headdim
    hs, gs, ch = _local(cfg)
    hl, gl, dl = hs.stop - hs.start, gs.stop - gs.start, ch.stop - ch.start

    p = _shared(p)
    zxbcdt = dctx.full_cols(dctx.copy_to_model(x), p["in_proj"],
                            2 * d_in + 2 * g * n + h)
    z, xbc_raw, dt_raw, conv = _split_zxbcdt(zxbcdt, cfg)
    xbc = F.silu(causal_conv1d(xbc_raw, p["conv_w"][:, conv],
                               p["conv_b"][conv]))
    xs = xbc[..., :dl].reshape(b, s, hl, ph)
    bmat = xbc[..., dl:dl + gl * n].reshape(b, s, gl, n)
    cmat = xbc[..., dl + gl * n:].reshape(b, s, gl, n)
    dt = F.softplus(dt_raw.float() + p["dt_bias"][hs])
    a = -torch.exp(p["a_log"][hs])

    chunk = min(cfg.ssm_chunk, s)
    while s % chunk != 0:
        chunk //= 2
    y, final_state = ssd_chunked(xs, dt, a, bmat, cmat, chunk)
    y = y + p["d_skip"][hs].to(y.dtype)[None, None, :, None] * xs
    y = _gated_norm(y.reshape(b, s, dl), z, p, cfg, ch)
    out = dctx.row_parallel(y, p["out_proj"], d_in)
    if return_state:
        return out, final_state, xbc_raw[:, -(cfg.conv_width - 1):]
    return out


def init_mamba2_cache(cfg, batch, dtype, device, n_layers=None):
    """Zeroed decode cache: the f32 SSD state and the conv tail in
    ``dtype``; with ``n_layers`` every leaf is layer-stacked ``[L, B,
    ...]`` (the layout ``models/api.py`` uses).  On a model axis with
    the heads split, this rank's heads and conv channels."""
    n, ph = cfg.ssm_state, cfg.ssm_headdim
    hs, gs, ch = _local(cfg)
    hl, gl = hs.stop - hs.start, gs.stop - gs.start
    lead = (batch,) if n_layers is None else (n_layers, batch)
    return {
        "state": torch.zeros(lead + (gl, hl // gl, n, ph),
                             dtype=torch.float32, device=device),
        "conv": torch.zeros(lead + (cfg.conv_width - 1,
                                    ch.stop - ch.start + 2 * gl * n),
                            dtype=dtype, device=device),
    }


def mamba2_decode(p, cfg, x, cache):
    """Single-token decode. x: [B, 1, d_model]; cache {"state", "conv"}
    (on a model axis, this rank's heads and channels).  Returns (y [B, 1,
    d_model], new cache); the caller writes the new cache where it keeps
    it."""
    b = x.shape[0]
    d_in = cfg.ssm_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    h, ph = cfg.ssm_heads, cfg.ssm_headdim
    hs, gs, ch = _local(cfg)
    hl, gl, dl = hs.stop - hs.start, gs.stop - gs.start, ch.stop - ch.start
    hg = hl // gl

    zxbcdt = dctx.full_cols(x, p["in_proj"],
                            2 * d_in + 2 * g * n + h)[:, 0]     # [B, ...]
    z, xbc_new, dt_raw, conv = _split_zxbcdt(zxbcdt, cfg)

    conv_buf = torch.cat([cache["conv"], xbc_new[:, None]], dim=1)
    xbc = torch.sum(conv_buf * p["conv_w"][:, conv][None], dim=1) \
        + p["conv_b"][conv][None]
    xbc = F.silu(xbc)

    xs = xbc[..., :dl].reshape(b, gl, hg, ph).float()
    bmat = xbc[..., dl:dl + gl * n].reshape(b, gl, n).float()
    cmat = xbc[..., dl + gl * n:].reshape(b, gl, n).float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"][hs]).reshape(b, gl, hg)
    a = -torch.exp(p["a_log"][hs]).reshape(gl, hg)

    decay = torch.exp(dt * a[None])
    upd = torch.einsum("bgn,bghp->bghnp", bmat, xs * dt[..., None])
    state = cache["state"] * decay[..., None, None] + upd
    y = torch.einsum("bgn,bghnp->bghp", cmat, state)
    y = y + p["d_skip"][hs].reshape(gl, hg)[None, ..., None] * xs
    y = y.reshape(b, 1, dl).to(x.dtype)
    y = _gated_norm(y, z[:, None], p, cfg, ch)
    out = dctx.row_parallel(y, p["out_proj"], d_in)
    return out, {"state": state, "conv": conv_buf[:, 1:]}
