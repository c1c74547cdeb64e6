"""Mamba-2 (SSD, state-space duality) layer — chunked scan, plain PyTorch.

Port of ``repro/models/ssm.py``: the SSD algorithm of arXiv:2405.21060,
an intra-chunk quadratic (semiseparable) term plus an inter-chunk state
recurrence.  MCA does not apply here (no attention matrix), so the layer
runs exact, and the reference has no Pallas kernel on this path: the
scan, the conv and the decode step are plain tensor code in both
packages.

The state is f32 (``a = -exp(a_log)``, dt = softplus(dt_raw + dt_bias));
activations keep the model dtype.  The reference's ``constrain_heads``
is a mesh sharding hint with no single-device counterpart and is left
out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def mamba2_forward(p, cfg, x, *, return_state=False):
    """Full-sequence Mamba-2 block. x: [B, S, d_model].  With
    ``return_state`` also returns the final SSD state [B,G,HG,N,P] (f32)
    and the decode conv cache: the last ``conv_width - 1``
    PRE-activation xBC rows."""
    b, s, _ = x.shape
    d_in = cfg.ssm_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    h = cfg.ssm_heads
    ph = cfg.ssm_headdim

    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :d_in]
    xbc_raw = zxbcdt[..., d_in:d_in + d_in + 2 * g * n]
    dt_raw = zxbcdt[..., -h:]
    xbc = F.silu(causal_conv1d(xbc_raw, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :d_in].reshape(b, s, h, ph)
    bmat = xbc[..., d_in:d_in + g * n].reshape(b, s, g, n)
    cmat = xbc[..., d_in + g * n:].reshape(b, s, g, n)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])

    chunk = min(cfg.ssm_chunk, s)
    while s % chunk != 0:
        chunk //= 2
    y, final_state = ssd_chunked(xs, dt, a, bmat, cmat, chunk)
    y = y + p["d_skip"].to(y.dtype)[None, None, :, None] * xs
    y = y.reshape(b, s, d_in)
    y = rmsnorm(y, p["norm"], cfg.norm_eps) * F.silu(z)
    out = y @ p["out_proj"]
    if return_state:
        return out, final_state, xbc_raw[:, -(cfg.conv_width - 1):]
    return out


def init_mamba2_cache(cfg, batch, dtype, device, n_layers=None):
    """Zeroed decode cache: the f32 SSD state and the conv tail in
    ``dtype``; with ``n_layers`` every leaf is layer-stacked ``[L, B,
    ...]`` (the layout ``models/api.py`` uses)."""
    d_in = cfg.ssm_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    h, ph = cfg.ssm_heads, cfg.ssm_headdim
    lead = (batch,) if n_layers is None else (n_layers, batch)
    return {
        "state": torch.zeros(lead + (g, h // g, n, ph), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros(lead + (cfg.conv_width - 1, d_in + 2 * g * n),
                            dtype=dtype, device=device),
    }


def mamba2_decode(p, cfg, x, cache):
    """Single-token decode. x: [B, 1, d_model]; cache {"state", "conv"}.
    Returns (y [B, 1, d_model], new cache); the caller writes the new
    cache where it keeps it."""
    b = x.shape[0]
    d_in = cfg.ssm_inner
    g, n = cfg.ssm_groups, cfg.ssm_state
    h, ph = cfg.ssm_heads, cfg.ssm_headdim
    hg = h // g

    zxbcdt = (x @ p["in_proj"])[:, 0]                          # [B, ...]
    z = zxbcdt[..., :d_in]
    xbc_new = zxbcdt[..., d_in:d_in + d_in + 2 * g * n]
    dt_raw = zxbcdt[..., -h:]

    conv_buf = torch.cat([cache["conv"], xbc_new[:, None]], dim=1)
    xbc = torch.sum(conv_buf * p["conv_w"][None], dim=1) + p["conv_b"][None]
    xbc = F.silu(xbc)

    xs = xbc[..., :d_in].reshape(b, g, hg, ph).float()
    bmat = xbc[..., d_in:d_in + g * n].reshape(b, g, n).float()
    cmat = xbc[..., d_in + g * n:].reshape(b, g, n).float()
    dt = F.softplus(dt_raw.float() + p["dt_bias"]).reshape(b, g, hg)
    a = -torch.exp(p["a_log"]).reshape(g, hg)

    decay = torch.exp(dt * a[None])
    upd = torch.einsum("bgn,bghp->bghnp", bmat, xs * dt[..., None])
    state = cache["state"] * decay[..., None, None] + upd
    y = torch.einsum("bgn,bghnp->bghp", cmat, state)
    y = y + p["d_skip"].reshape(g, hg)[None, ..., None] * xs
    y = y.reshape(b, 1, d_in).to(x.dtype)
    y = rmsnorm(y, p["norm"], cfg.norm_eps) * F.silu(z[:, None])
    out = y @ p["out_proj"]
    return out, {"state": state, "conv": conv_buf[:, 1:]}
