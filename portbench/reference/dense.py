"""The dense family (starcoder2-3b): ``_lm``'s decoder with a GeLU or
SwiGLU feed-forward block."""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from portbench.reference import _lm


def _ffn(p, m, h, lin, key, s_pad, n_pad, prefill):
    return _lm.dense_ffn(p, m, h, lin)


def served_logits(params: Dict, cfg: Dict, key: int, prompt: torch.Tensor,
                  s_pad: int, served: torch.Tensor,
                  quant: Optional[str] = None,
                  follow: Optional[List[torch.Tensor]] = None,
                  record: Optional[List] = None,
                  kv: Optional[List] = None) -> torch.Tensor:
    return _lm.served_logits(params, cfg, key, prompt, s_pad, served,
                             ffn=_ffn, quant=quant, follow=follow,
                             record=record, kv=kv)
