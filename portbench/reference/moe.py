"""The MoE family (olmoe-1b-7b): ``_lm``'s decoder with a mixture of
SwiGLU experts as its feed-forward block, in plain float32 PyTorch.

Per token: the router's softmax over all E experts, the top k of it,
the raw probabilities of those k as gates (``moe_renorm_gates`` false,
OLMoE's ``norm_topk_prob: false``; divided by their sum where the
configuration sets it true), each chosen expert's SwiGLU, and the
gate-weighted sum.  No capacity: the published model drops no token, so
no (token, expert) pair is left out.

Departures from the published model:

- QK-norm is per 128-wide head (``_lm.head_norm`` with a [d_head]
  scale), as the program computes it; OLMoE normalises the whole
  2,048-wide q and k projections.  The benchmark's weights lay out the
  per-head scales.
- The weights are random, drawn from the seed (``portbench/weights.py``),
  not the checkpoint.

``picks``: the experts each MoE call is to use, in call order (layer by
layer: the prompt's real positions [n, k], then the served tokens' [m -
1, k]), instead of its own top k; the gates are the reference's own
probabilities of those experts.  ``route_record`` gets (probs [rows,
E], experts used [rows, k]) of every call, in that order.  With
``quant="fp8"`` the router's product is rounded too.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from portbench.reference import _lm


def moe_ffn(p: Dict, m: Dict, h: torch.Tensor, lin,
            pick: Optional[torch.Tensor] = None,
            route_record: Optional[List] = None) -> torch.Tensor:
    """The expert layer of tokens ``h`` [rows, d]."""
    k = m["top_k"]
    probs = torch.softmax(lin(h, p["router"].float()), dim=-1)
    if pick is None:
        pick = torch.topk(probs, k, dim=-1).indices
    pick = pick.long()
    gate = probs.gather(1, pick)
    if m.get("moe_renorm_gates", True):
        gate = gate / gate.sum(dim=-1, keepdim=True)
    if route_record is not None:
        route_record.append((probs, pick))
    flat = pick.reshape(-1)
    contrib = torch.zeros((flat.shape[0], h.shape[1]), device=h.device)
    for e in torch.unique(flat).tolist():
        rows = torch.nonzero(flat == e)[:, 0]
        x = h[rows // k]
        y = lin(F.silu(lin(x, p["w_gate"][e].float()))
                * lin(x, p["w_up"][e].float()), p["w_down"][e].float())
        contrib[rows] = y * gate.reshape(-1)[rows, None]
    return contrib.reshape(h.shape[0], k, h.shape[1]).sum(dim=1)


def served_logits(params: Dict, cfg: Dict, key: int, prompt: torch.Tensor,
                  s_pad: int, served: torch.Tensor,
                  quant: Optional[str] = None,
                  follow: Optional[List[torch.Tensor]] = None,
                  record: Optional[List] = None,
                  kv: Optional[List] = None,
                  picks: Optional[List[torch.Tensor]] = None,
                  route_record: Optional[List] = None) -> torch.Tensor:
    if cfg["model"]["ffn_type"] != "swiglu":
        raise ValueError("the MoE reference has SwiGLU experts only")
    calls = iter(picks) if picks is not None else None

    def ffn(p, m, h, lin, mca_key, s_pad_, n_pad, prefill):
        pick = next(calls) if calls is not None else None
        return moe_ffn(p, m, h, lin, pick, route_record)

    return _lm.served_logits(params, cfg, key, prompt, s_pad, served,
                             ffn=ffn, quant=quant, follow=follow,
                             record=record, kv=kv)
