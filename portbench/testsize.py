"""A cell cut to a size a CPU test run holds: starcoder2-3b's file and
the repo-context mix with every width and length shrunk (d 128, 2
layers, 4 slots, prompts of 32-128 tokens).  For the tests only."""
from __future__ import annotations

import copy
from typing import Dict, Tuple

from portbench import manifest

CELL = "starcoder2-3b.repo-context"


def tiny(dtype: str = "float32") -> Tuple[Dict, Dict, Dict]:
    """(config, mix, cell) of the tiny cell."""
    bench = manifest.benchmark()
    cell = manifest.cell(bench, CELL)
    cfg = copy.deepcopy(manifest.config(cell["config"]))
    cfg["model"].update(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                        d_head=32, d_ff=256, vocab_size=512)
    cfg["mca"]["block"] = 32
    cfg["dtype"] = dtype
    mix = copy.deepcopy(manifest.mix(cell["traffic"]))
    mix.update(slots=4, max_len=160, deck=8, requests=64, check_tokens=72,
               prompt={"dist": "lognormal", "median": 64, "sigma": 0.5,
                       "min": 32, "max": 128},
               output={"dist": "uniform", "min": 4, "max": 12})
    return cfg, mix, cell


#: limits for the tiny cell: float32 runs read 0, ~1e-6 and ~1e-6 (the
#: program and the reference do the same arithmetic in another order);
#: bf16 runs up to 0.0015, 0.009 and 0.016, the float8 control 0.036,
#: 0.09 and 0.16 or more
LIMITS = {"float32": {"widest_logit_gap": {"limit": 1e-3},
                      "importance_gap": {"limit": 1e-3},
                      "kv_gap": {"limit": 1e-3}},
          "bfloat16": {"widest_logit_gap": {"limit": 0.02},
                       "importance_gap": {"limit": 0.03},
                       "kv_gap": {"limit": 0.05}}}
