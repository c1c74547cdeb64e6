"""Architecture registry: ``--arch <id>`` resolves through ARCHS.

Port of ``repro/configs/__init__.py``, with every architecture of the
reference: the dense GQA models (starcoder2-3b, the serving and training
model; chatglm3-6b, partial rotary; qwen3-32b, qk-norm; bert-base, the
paper's encoder), the MoE models (olmoe-1b-7b, granite-moe-1b-a400m), the
MLA model minicpm3-4b, the VLM internvl2-1b (a patch frontend stub), the
encoder-decoder whisper-small (a frames frontend stub, cross attention),
the SSM model mamba2-2.7b and the hybrid (RG-LRU and local attention)
model recurrentgemma-9b; and the dry-run's shape sets (``SHAPES``,
``LONG_OK``, ``cells``), as the reference's.
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
    "internvl2-1b": "internvl2_1b",
    "whisper-small": "whisper_small",
    "mamba2-2.7b": "mamba2_2p7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "bert-base": "bert_base",
}

# per-arch shape sets (assignment): name -> (seq_len, global_batch, kind)
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# archs allowed to run long_500k (sub-quadratic sequence mixing)
LONG_OK = {"mamba2-2.7b", "recurrentgemma-9b"}


def get_config(arch: str, **overrides):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; "
                       f"known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.config(**overrides)


def cells(include_bert: bool = False):
    """All assigned (arch x shape) dry-run cells, honoring skips."""
    out = []
    for arch in ARCHS:
        if arch == "bert-base" and not include_bert:
            continue
        for shape in SHAPES:
            if shape == "long_500k" and arch not in LONG_OK:
                continue
            out.append((arch, shape))
    return out
