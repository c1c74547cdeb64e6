"""``meta`` input stand-ins for every (arch x shape) dry-run cell.

Port of ``repro/launch/specs.py``: where the reference builds
``jax.ShapeDtypeStruct``\\ s for ``jit(...).lower()``, each stand-in here
is an empty tensor on the ``meta`` device (a shape and a dtype, no
storage), which ``launch.dryrun`` runs the step on.  Shapes come from
the assignment's per-arch shape sets (``repro_torch.configs.SHAPES``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.models import build_model


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_specs(cfg, seq: int, batch: int) -> Dict[str, torch.Tensor]:
    specs = {
        "tokens": _spec((batch, seq), torch.int32),
        "labels": _spec((batch, seq), torch.int32),
    }
    if cfg.family == "vlm":
        specs["patches"] = _spec((batch, cfg.n_patch_tokens, cfg.d_model),
                                 torch.bfloat16)
    if cfg.is_encoder_decoder:
        specs["frames"] = _spec((batch, cfg.encoder_len, cfg.d_model),
                                torch.bfloat16)
    return specs


def prefill_specs(cfg, seq: int, batch: int) -> Dict[str, torch.Tensor]:
    specs = {"tokens": _spec((batch, seq), torch.int32)}
    if cfg.family == "vlm":
        specs["patches"] = _spec((batch, cfg.n_patch_tokens, cfg.d_model),
                                 torch.bfloat16)
    if cfg.is_encoder_decoder:
        specs["frames"] = _spec((batch, cfg.encoder_len, cfg.d_model),
                                torch.bfloat16)
    return specs


def decode_specs(cfg, seq: int, batch: int):
    """(tokens, cache, t) stand-ins; cache sized for a ``seq`` history."""
    cache = build_model(cfg, device="meta").init_cache(batch, seq)
    return (_spec((batch, 1), torch.int32), cache, _spec((), torch.int32))


def input_specs(arch: str, shape: str, **cfg_overrides
                ) -> Tuple[object, str, dict]:
    """Returns (cfg, kind, specs) for one dry-run cell."""
    seq, batch, kind = SHAPES[shape]
    cfg = get_config(arch, **cfg_overrides)
    if kind == "train":
        return cfg, kind, train_specs(cfg, seq, batch)
    if kind == "prefill":
        return cfg, kind, prefill_specs(cfg, seq, batch)
    return cfg, kind, decode_specs(cfg, seq, batch)
