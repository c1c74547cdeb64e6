"""Architecture registry: ``--arch <id>`` resolves through ARCHS.

Port of ``repro/configs/__init__.py``, holding the architectures ported so
far: the dense GQA models (starcoder2-3b, the serving and training model;
chatglm3-6b, partial rotary; qwen3-32b, qk-norm; bert-base, the paper's
encoder), the MoE models (olmoe-1b-7b, granite-moe-1b-a400m) and the MLA
model minicpm3-4b.  The SSM, hybrid, VLM and audio models follow with
their families (ROADMAP.md).
"""
from __future__ import annotations

import importlib

ARCHS = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "starcoder2-3b": "starcoder2_3b",
    "qwen3-32b": "qwen3_32b",
    "chatglm3-6b": "chatglm3_6b",
    "minicpm3-4b": "minicpm3_4b",
    "bert-base": "bert_base",
}


def get_config(arch: str, **overrides):
    if arch not in ARCHS:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; "
                       f"known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.config(**overrides)
