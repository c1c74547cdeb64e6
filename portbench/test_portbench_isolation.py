"""Isolation: nothing under ``portbench/`` imports JAX or the JAX package
``repro`` (compared by whole top-level names: ``repro_torch`` is the
port), nothing reads ``benchmarks/`` or ``src/repro/``, and the plain
reference imports nothing of the port either.  Checked statically over
every import statement and dynamically, in a fresh interpreter where
those packages cannot be imported."""
import ast
import pathlib
import subprocess
import sys
import textwrap

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    return sorted(HERE.rglob("*.py"))


def test_no_source_imports_jax_or_the_jax_package():
    assert len(_sources()) > 20
    bad = {str(p.relative_to(ROOT)): sorted(set(_roots(p)) & FORBIDDEN)
           for p in _sources()}
    assert {k: v for k, v in bad.items() if v} == {}


def test_the_reference_imports_nothing_of_the_port():
    for p in sorted((HERE / "reference").glob("*.py")):
        roots = set(_roots(p))
        assert roots <= {"__future__", "typing", "math", "torch", "numpy",
                         "portbench"}, (p, roots)
        text = p.read_text()
        assert "repro_torch" not in text.replace(
            "nothing of the port", "")


def test_no_source_reads_the_jax_benchmarks():
    for p in _sources():
        if p.name == pathlib.Path(__file__).name:
            continue
        text = p.read_text()
        assert '"benchmarks' not in text and "'benchmarks" not in text, p
        assert "src/repro/" not in text, p


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = textwrap.dedent(f"""
        import importlib.abc, sys, time
        BLOCK = {sorted(FORBIDDEN)!r}

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in BLOCK:
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
        import pkgutil, importlib, portbench
        for m in pkgutil.walk_packages(portbench.__path__, "portbench."):
            if not m.name.split(".")[-1].startswith("test_"):
                importlib.import_module(m.name)
        from portbench import cellrun, manifest, testsize
        cfg, mix, cell = testsize.tiny()
        res = cellrun.run(cell, 5, 1.5, False, "cpu", time.perf_counter(),
                          manifest.benchmark(), cfg=cfg, mix=mix,
                          limits=testsize.LIMITS["float32"])
        roots = {{m.split(".")[0] for m in sys.modules}}
        assert not roots & set(BLOCK), roots & set(BLOCK)
        assert "repro_torch" in roots
        print("ok", res["attempted"])
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")


def test_the_reference_runs_without_the_port():
    code = textwrap.dedent(f"""
        import importlib.abc, sys
        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path, target=None):
                if name.split(".")[0] in ("repro_torch", "repro", "jax"):
                    raise ImportError("blocked: " + name)
                return None
        sys.meta_path.insert(0, Block())
        sys.path[:0] = [{str(ROOT)!r}]
        import torch
        from portbench import weights
        from portbench.reference import dense
        cfg = {{"model": dict(n_layers=1, d_model=64, n_heads=2,
                              n_kv_heads=1, d_head=32, d_ff=128,
                              vocab_size=128, ffn_type="gelu",
                              norm_type="layernorm", norm_eps=1e-6,
                              tie_embeddings=True, rope_theta=1e4),
                "mca": dict(enabled=True, alpha=0.2, block=32, n_tiers=4,
                            r_min_blocks=1, capacity_fracs=[1, .5, .375, .25],
                            sites=["v_proj", "o_proj"])}}
        p = weights.make(cfg["model"], torch.float32, 3, "cpu")
        lg = dense.served_logits(p, cfg, 3, torch.arange(1, 20), 32,
                                 torch.tensor([5, 6, 7]))
        assert lg.shape == (3, 128)
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
