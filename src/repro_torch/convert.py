"""Convert the reference's parameters into the port's.

The reference keeps a params pytree whose per-layer leaves are stacked on
a leading ``[L, ...]`` axis (``lax.scan`` over layers); the port keeps a
list of per-layer dicts.  Weights share the ``[d_in, d_out]`` layout, so
conversion is an unstack plus a copy, with no reshaping.  The hybrid
(RecurrentGemma) tree keeps its layers as ``{"groups": {"pos{i}":
[n_groups, ...] leaves}, "rem": [dicts]}``; it is interleaved into layer
order, layer ``gidx * len(pattern) + i`` being ``groups["pos{i}"][gidx]``
and the remainder following.  An encoder-decoder's ``enc_layers`` and
``dec_layers`` are unstacked the same way; every other entry (``embed``,
``enc_norm``, a VLM's ``patch_proj``, ...) is copied as it is.  With
tied embeddings there is no ``lm_head``: the port's head is the
embedding table, as in the reference.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch._device import resolve_device


def _tensor(a, device, dtype) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.kind == "V" or str(arr.dtype) == "bfloat16":
        # numpy has no bf16: take the raw bits and reinterpret
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _convert(tree, device, dtype):
    if isinstance(tree, Mapping):
        return {k: _convert(v, device, dtype) for k, v in tree.items()}
    return _tensor(tree, device, dtype)


def _unstack(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _unstack(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _n_layers(tree) -> int:
    while isinstance(tree, Mapping):
        tree = next(iter(tree.values()))
    return int(np.asarray(tree).shape[0])


_LAYER_STACKS = ("layers", "enc_layers", "dec_layers")


def _flat_layers(layers):
    """A reference layer stack -> per-layer trees in layer order."""
    if "groups" in layers:                          # the hybrid stack
        groups = layers["groups"]
        pat = [groups[f"pos{i}"] for i in range(len(groups))]
        return [_unstack(pos, gidx) for gidx in range(_n_layers(pat[0]))
                for pos in pat] + list(layers["rem"])
    return [_unstack(layers, i) for i in range(_n_layers(layers))]


def params_from_jax(tree: Mapping[str, Any],
                    device: Optional[Union[str, torch.device]] = None,
                    dtype: Optional[torch.dtype] = None) -> dict:
    """Reference params (nested dicts of numpy arrays, layer leaves
    ``[L, ...]``) -> the port's params on ``device`` (the card unless
    ``"cpu"``; without a card ``None`` raises).  ``dtype`` casts floating
    leaves (``None`` keeps each leaf's own dtype)."""
    device = resolve_device(device)
    return {k: ([_convert(layer, device, dtype) for layer in _flat_layers(v)]
                if k in _LAYER_STACKS else _convert(v, device, dtype))
            for k, v in tree.items()}
