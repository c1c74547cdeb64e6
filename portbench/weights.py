"""Random weights made by the benchmark, in the port's parameter layout.

Both sides get the same weights: the program the tree made here, the
reference the same tree made again from the same seed after the program
is freed.  The draws run on the device, in a few large calls: the
weights that share a scale lie in one flat buffer, filled by one
``randn`` per chunk of at most 2**28 elements (in float32, scaled, then
cast to the serving dtype, as the port's own initialisers round them).
Distributions are the port's: N(0, 1/d_in) for a projection, N(0,
0.02^2) for the embedding, the norms at identity (float32), the MoE
router in float32.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

_CHUNK = 1 << 28
_ALIGN = 128                 # elements: every view starts 256-byte aligned


def _padded_vocab(vocab: int) -> int:
    return ((vocab + 127) // 128) * 128


def _norm(m: Dict, device) -> Dict[str, torch.Tensor]:
    d = m["d_model"]
    if m["norm_type"] == "layernorm":
        return {"scale": torch.ones(d, device=device),
                "bias": torch.zeros(d, device=device)}
    return {"scale": torch.zeros(d, device=device)}


def _specs(m: Dict) -> List[Tuple[Tuple, Tuple[int, ...], float]]:
    """(path in the tree, shape, std) of every drawn weight, in the
    order they are laid out; the router is drawn apart (float32)."""
    d, dh = m["d_model"], m["d_head"]
    h, hkv, f = m["n_heads"], m["n_kv_heads"], m["d_ff"]
    out = [(("embed", "table"), (_padded_vocab(m["vocab_size"]), d), 0.02)]
    for i in range(m["n_layers"]):
        mix = ("layers", i, "mixer")
        out += [(mix + ("wq",), (d, h * dh), d ** -0.5),
                (mix + ("wk",), (d, hkv * dh), d ** -0.5),
                (mix + ("wv",), (d, hkv * dh), d ** -0.5),
                (mix + ("wo",), (h * dh, d), (h * dh) ** -0.5)]
        ffn = ("layers", i, "ffn")
        lead = (m["n_experts"],) if m.get("n_experts") else ()
        out += [(ffn + ("w_up",), lead + (d, f), d ** -0.5),
                (ffn + ("w_down",), lead + (f, d), f ** -0.5)]
        if m["ffn_type"] == "swiglu":
            out.append((ffn + ("w_gate",), lead + (d, f), d ** -0.5))
    if not m["tie_embeddings"]:
        out.append((("lm_head",), (d, _padded_vocab(m["vocab_size"])),
                    d ** -0.5))
    return out


def _put(tree, path, value) -> None:
    node = tree
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value


def make(m: Dict, dtype: torch.dtype, seed: int, device) -> Dict:
    """The parameter tree of model settings ``m`` (a configuration
    file's ``"model"``), drawn from ``seed`` on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    tree: Dict = {"embed": {}, "final_norm": _norm(m, device),
                  "layers": []}
    for _ in range(m["n_layers"]):
        layer = {"ln1": _norm(m, device), "ln2": _norm(m, device),
                 "mixer": {}, "ffn": {}}
        if m.get("qk_norm"):
            layer["mixer"]["q_norm"] = torch.zeros(m["d_head"], device=device)
            layer["mixer"]["k_norm"] = torch.zeros(m["d_head"], device=device)
        if m.get("n_experts"):
            layer["ffn"]["router"] = None
        tree["layers"].append(layer)
    groups: Dict[float, List] = {}
    for path, shape, std in _specs(m):
        groups.setdefault(std, []).append((path, shape))
    for std, members in groups.items():
        sizes = [-(-math.prod(s) // _ALIGN) * _ALIGN for _, s in members]
        flat = torch.empty(sum(sizes), dtype=dtype, device=device)
        for c0 in range(0, flat.numel(), _CHUNK):
            n = min(_CHUNK, flat.numel() - c0)
            draw = torch.randn(n, generator=g, device=device)
            flat[c0:c0 + n] = draw.mul_(std)
            del draw
        off = 0
        for (path, shape), size in zip(members, sizes):
            _put(tree, path, flat[off:off + math.prod(shape)].view(shape))
            off += size
    if m.get("n_experts"):
        d, e = m["d_model"], m["n_experts"]
        routers = torch.randn((m["n_layers"], d, e), generator=g,
                              device=device).mul_(d ** -0.5)
        for i, layer in enumerate(tree["layers"]):
            layer["ffn"]["router"] = routers[i]
    return tree
