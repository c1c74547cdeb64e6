"""The port stands alone: no module of ``src/repro_torch`` (nor
``chip_smoke.py``, nor the port's examples ``examples/torch_*.py``)
imports JAX or the reference package ``repro``.

Checked twice: statically, by walking every import statement, and
dynamically, by importing every module in a fresh interpreter where
``jax`` and ``repro`` cannot be imported at all.
"""
import ast
import pathlib
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _examples():
    return sorted((ROOT / "examples").glob("torch_*.py"))


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"] + _examples()


def _modules():
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(ROOT / "src").with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_never_import_jax_or_reference():
    assert len(_sources()) > 20 and len(_examples()) == 4
    bad = {str(p.relative_to(ROOT)): sorted(set(_imported_roots(p))
                                            & set(FORBIDDEN))
           for p in _sources()}
    assert {k: v for k, v in bad.items() if v} == {}


def test_every_port_module_imports_without_jax():
    code = "\n".join([
        "import importlib, sys",
        "for name in %r: sys.modules[name] = None" % (FORBIDDEN,),
        "sys.path[:0] = [%r, %r, %r]" % (str(ROOT / "src"), str(ROOT),
                                         str(ROOT / "examples")),
        "for m in %r: importlib.import_module(m)" % (
            _modules() + [p.stem for p in _examples()],),
        "import chip_smoke",
        "assert callable(chip_smoke.main)",
        "live = [k for k, v in sys.modules.items() if v is not None",
        "        and k.split('.')[0] in %r]" % (FORBIDDEN,),
        "assert not live, live",
        "print('imported', len(%r))" % (_modules(),),
    ])
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("imported")


def test_census_modules_are_checked():
    """The dry run's counting modules are among those imported above
    with ``jax`` and ``repro`` blocked."""
    assert {"repro_torch.launch.hlo_analysis", "repro_torch.launch.mesh",
            "repro_torch.launch.dryrun"} <= set(_modules())
