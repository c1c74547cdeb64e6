"""The port's examples (``examples/torch_*.py``) run to their end on the
CPU (``--device cpu``; the dry-run one needs no device), each in a
subprocess with a time limit, at reduced size: the quickstart as it is,
``torch_train_lm.py --tiny`` for 10 steps, ``torch_serve_mca.py`` after
2 warm-up steps, the dry run on one decode cell."""
import os
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]

CASES = {
    "torch_quickstart.py": (["--device", "cpu"],
                            ["[1] 2-of-4 block sample", "[4] starcoder2"]),
    "torch_train_lm.py": (["--tiny", "--steps", "10", "--device", "cpu"],
                          ["model: starcoder2-3b modified", "steps/s"]),
    "torch_serve_mca.py": (["--device", "cpu", "--warmup", "2"],
                           ["serve.flops_reduction (prefill)",
                            "attention-encoding FLOPs reduction"]),
    "torch_multipod_dryrun.py": (["--arch", "starcoder2-3b", "--shape",
                                  "decode_32k"],
                                 ["on 512 devices", "roofline terms"]),
}


@pytest.mark.parametrize("script", list(CASES))
def test_example_runs(script):
    args, lines = CASES[script]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                          *args], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    for line in lines:
        assert line in out.stdout, out.stdout[-3000:]


def test_examples_need_the_card_unless_asked():
    """Without ``--device cpu`` and without a card, an example that runs
    the model stops at once and says why."""
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable,
                          str(ROOT / "examples" / "torch_quickstart.py")],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "no CUDA device found" in out.stderr
