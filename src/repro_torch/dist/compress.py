"""Error-feedback gradient compression for a slow all-reduce.

Port of ``repro/dist/compress.py``.  int8-quantizing a gradient cuts its
transfer 4x; error feedback (Seide et al. 2014 / Karimireddy et al. 2019)
carries the quantization residual into the next step, so the *sum over
time* of transmitted gradients telescopes to the true sum.

``quantize`` matches the reference bit for bit: the scale is
``amax / 127`` in f32, and ``torch.round`` rounds half to even as
``jnp.round`` does.  Trees are nested dicts and lists of tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .context import Mesh, psum

_QMAX = 127.0  # symmetric int8


def _map(fn, *trees):
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization: (q int8, scale f32 0-d)
    with g ~= q * scale."""
    g32 = g.float()
    amax = torch.max(torch.abs(g32))
    scale = torch.where(amax > 0, amax / _QMAX,
                        torch.ones((), dtype=torch.float32, device=g.device))
    q = torch.clamp(torch.round(g32 / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_buffer(tree):
    """Zero residuals matching ``tree`` (always f32)."""
    return _map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                      device=x.device), tree)


def ef_compress_tree(grads, err):
    """Error-feedback compression of a gradient tree: (q_tree, scale_tree,
    new_err) with ``new_err = (g + err) - dequantize(q, s)``, so
    ``sum_t dequant_t + err_T == sum_t g_t`` (telescoping)."""
    comp = _map(lambda g, e: g.float() + e, grads, err)
    qs = _map(quantize, comp)            # (q, s) pairs at comp's leaves
    q_tree = _map(lambda c, pair: pair[0], comp, qs)
    s_tree = _map(lambda c, pair: pair[1], comp, qs)
    new_err = _map(lambda c, q, s: c - dequantize(q, s), comp, q_tree,
                   s_tree)
    return q_tree, s_tree, new_err


def psum_compressed(grads, err, mesh: Mesh):
    """Compressed gradient all-reduce over the mesh's ranks.

    Each rank EF-compresses its local gradient and the *dequantized* int8
    payloads are summed with one ``all_reduce`` per leaf.  Returns
    (summed_grads, new_err); residuals stay rank-local."""
    q_tree, s_tree, new_err = ef_compress_tree(grads, err)
    summed = _map(lambda q, s: psum(dequantize(q, s), mesh), q_tree, s_tree)
    return summed, new_err


def compression_ratio(grads) -> float:
    """Wire-bytes ratio of f32 grads vs the int8+scale payload."""
    f32 = sum(leaf.numel() * 4 for leaf in _leaves(grads))
    int8 = sum(leaf.numel() + 4 for leaf in _leaves(grads))
    return f32 / max(int8, 1)
