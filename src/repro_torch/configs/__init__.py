"""Architecture registry: ``--arch <id>`` resolves through ARCHS.

Port of ``repro/configs/__init__.py``, holding the architectures ported so
far: starcoder2-3b (the serving and training model) and bert-base (the
paper's encoder).  The others follow with their model families
(ROADMAP.md).
"""
from __future__ import annotations

import importlib

ARCHS = {
    "starcoder2-3b": "starcoder2_3b",
    "bert-base": "bert_base",
}


def get_config(arch: str, **overrides):
    if arch not in ARCHS:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; "
                       f"known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.config(**overrides)
