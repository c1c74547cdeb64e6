"""Shared helpers of the port's parity tests (tests/test_torch_*.py).

Builds the same model in both packages (reference params converted with
``repro_torch.convert.params_from_jax``) and checks that MCA routing has
room to agree across frameworks: the two compute attention in f32 in a
different order, so a token whose Eq. 9 budget lies on a ladder boundary,
or two tokens whose importances nearly tie, could route differently.  A
test asserts the margins first, so a flip names its cause.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np

from repro.configs import get_config as j_get_config
from repro.models import build_model as j_build_model
from repro.models import reduced as j_reduced
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import schedule
from repro_torch.models import build_model, reduced
from repro_torch.models.config import PORT_ONLY

BOUNDARY_MARGIN = 1e-3        # relative distance of r_cols/block to a rung
TIE_MARGIN = 1e-5             # relative gap between distinct importances


def port_fields(cfg):
    """The port's config as a dict of its fields (``mca`` a dict too), to
    hold beside the reference's: the port's own fields (``PORT_ONLY``)
    must be at the defaults that keep the reference's model, and are
    left out."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["mca"] = dataclasses.asdict(out["mca"])
    assert {k: out.pop(k) for k in PORT_ONLY} == PORT_ONLY
    return out


def model_pair(arch="starcoder2-3b", j_mca=None, t_mca=None, seed=0, **kw):
    """(ref model, ref params, port model, port params) on the CPU, from
    one reduced config; the port's params are the reference's."""
    jkw, tkw = dict(kw), dict(kw)
    if j_mca is not None:
        jkw["mca"], tkw["mca"] = j_mca, t_mca
    jcfg = j_reduced(j_get_config(arch), **jkw)
    tcfg = reduced(get_config(arch), **tkw)
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = build_model(tcfg, device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, tm, tp


def tree_spec(tree, path=""):
    """{leaf path: shape} of a params tree (dicts, lists, torch or numpy
    leaves), independent of the order of dict keys (JAX sorts them)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(tree_spec(v, f"{path}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(tree_spec(v, f"{path}/{i}"))
        return out
    return {path: tuple(tree.shape)}


def spy_mca_project(monkeypatch):
    """Record (importance, seq_len, d, cfg) of every port mca_project call
    made from the attention module."""
    from repro_torch.models import attention
    calls = []
    orig = attention.mca_project

    def spy(key, x, w, importance, seq_len, cfg, site):
        calls.append((importance.detach().double().numpy().ravel(), seq_len,
                      x.shape[-1], cfg))
        return orig(key, x, w, importance, seq_len, cfg, site)

    monkeypatch.setattr(attention, "mca_project", spy)
    return calls


def assert_routing_margins(calls):
    """No token's r_cols/block within BOUNDARY_MARGIN of a sampled rung,
    and distinct non-zero importances apart by more than TIE_MARGIN."""
    assert calls, "no MCA projection ran"
    for imp, seq_len, d, cfg in calls:
        block = cfg.block_for(d)
        ladder = schedule.tier_ladder(d, block, cfg.n_tiers,
                                      cfg.r_min_blocks)
        r = np.clip((seq_len * imp / cfg.alpha) ** 2, 1.0, float(d)) / block
        for rung in ladder[:-1]:
            gap = float(np.min(np.abs(r - rung))) / rung
            assert gap > BOUNDARY_MARGIN, (
                f"an Eq. 9 budget lies {gap:.2e} from ladder rung {rung}: "
                "f32 rounding could route it differently; pick another seed")
        u = np.unique(imp[imp > 0])
        if len(u) > 1:
            rel = np.min(np.diff(u) / u[1:])
            assert rel > TIE_MARGIN, (
                f"two importances differ by {rel:.2e} (relative): capacity "
                "ranking could flip; pick another seed")
