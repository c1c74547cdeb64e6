"""What the output check follows of a dense-family program, and the
numbers it reads.

MCA routes each token to a tier by comparing its importance with the
others' (capacities are shares of the sequence).  The program computes
importances from bf16 activations and the reference from float32 ones,
so tokens whose importances lie within rounding of a tier's cut land in
another tier, and the changed rows change the importances of the layers
after them (at d 1,024 and 8 layers, on the CPU, 2 tokens of 700 had
changed tiers in the first layer and 104 in the eighth, the prompt's
last token among them in 2 of 3 requests).  Both realisations are
sound MCA; they are not the same computation.  So the reference follows
the program where MCA decides: it takes the tier each token was routed
to, and computes everything else itself.  What that skips is checked by
itself: the program's tiers against the routing rule run on the
program's own importances (exact), and the program's importances
against the reference's.

``Recorder`` wraps, for one window,
``repro_torch.core.dispatch.tiered_mca_matmul`` (one call per MCA
projection, layer by layer, ``v_proj`` before ``o_proj``: its ``tier``
and ``importance`` arguments) and the engine's ``prefill_into``.  Per
insertion it keeps the tiers and importances of every projection, copied
to the host once the insertion has synchronised (none where no MCA call
ran), its slot and its bucket.  Once the window has closed,
``snapshot`` copies to the host the K/V cache rows of the sampled
requests that still hold their slot: the prompt's real rows and the one
each decode step wrote.

``readings`` returns, over the sample:

- ``widest_logit_gap``: the widest gap by which a served token's logit
  lies below the reference's best;
- ``kv_gap``: the widest gap of a snapshotted K or V cache row from the
  reference's row at its position, as a share of the larger of that
  row's norm and its layer's median row norm (a row left unwritten or
  written elsewhere reads about 1);
- ``importance_gap``: the widest gap of the program's MCA importances
  from the reference's, as a share of the call's largest (read where
  MCA ran);
- ``routing_mismatches``: tiers unlike the routing rule's on the
  program's own importances;
- ``mca_calls_missing``: MCA projections the configuration asks for
  that an insertion did not run, or ran beyond them.

A control (``quant``) in the program's place routes by its own
importances and is read against the reference following its tiers:
``<quant>`` (the widest gap of its first choices), ``<quant>_kv_gap``
and ``<quant>_importance_gap``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import manifest, patch, weights

_DISPATCH = "repro_torch.core.dispatch"
#: the MCA projections of a dense layer, in the order the program runs them
SITES = ("v_proj", "o_proj")
#: the numbers compared exactly (limit 0)
EXACT = ("routing_mismatches", "mca_calls_missing")


class Recorder:
    def __init__(self, engine):
        self.records: Dict[int, Dict] = {}      # id(prompt) -> insertion
        self.last_in_slot: Dict[int, int] = {}  # slot -> id(prompt)
        self.rows: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self.cache = None
        self._calls: List = []
        self._patches = patch.Patches()
        mod = importlib.import_module(_DISPATCH)
        project_fn = mod.tiered_mca_matmul
        insert_fn = engine.prefill_into

        def project(key, x, w, tier, importance, *args, **kwargs):
            self._calls.append((tier, importance))
            return project_fn(key, x, w, tier, importance, *args, **kwargs)

        def insert(prompt, state, slot, *args, **kwargs):
            self._calls = []
            out = insert_fn(prompt, state, slot, *args, **kwargs)
            calls, self._calls = self._calls, []
            s_pad = out[2]
            if calls:
                tiers = torch.stack([t.to(torch.int32) for t, _ in calls])
                imps = torch.stack([i.float() for _, i in calls])
                tiers, imps = tiers.cpu().numpy(), imps.cpu().numpy()
            else:
                tiers = np.zeros((0, s_pad), np.int32)
                imps = np.zeros((0, s_pad), np.float32)
            self.records[id(prompt)] = {"tiers": tiers, "imps": imps,
                                        "slot": slot, "s_pad": s_pad}
            self.last_in_slot[slot] = id(prompt)
            self.cache = out[0].cache
            return out

        self._patches.set(mod, "tiered_mca_matmul", project)
        self._patches.set(engine, "prefill_into", insert)

    def close(self) -> None:
        self._patches.restore()

    def _holds(self, req) -> bool:
        rec = self.records.get(id(req.prompt))
        return (rec is not None
                and self.last_in_slot.get(rec["slot"]) == id(req.prompt))

    def resident(self, reqs) -> set:
        """The uids of ``reqs`` whose cache rows still hold their slot."""
        return {r.uid for r in reqs if self._holds(r)}

    def snapshot(self, reqs) -> None:
        """Copy to the host the K/V rows of each of ``reqs`` that still
        holds its slot: positions ``s_pad - n`` to ``s_pad + m - 2``."""
        for r in reqs:
            if not self._holds(r):
                continue
            rec = self.records[id(r.prompt)]
            lo = rec["s_pad"] - len(r.prompt)
            hi = rec["s_pad"] + len(r.out) - 1
            layers = self.cache["layers"]
            self.rows[id(r.prompt)] = tuple(
                layers[name][:, rec["slot"], lo:hi].to("cpu", copy=True)
                for name in ("k", "v"))


def mca_calls(cfg: Dict) -> int:
    """The MCA projections one insertion runs under the configuration."""
    mca = cfg["mca"]
    if not mca["enabled"]:
        return 0
    return cfg["model"]["n_layers"] * len(set(SITES) & set(mca["sites"]))


def routing_gaps(n: int, s_pad: int, tiers, imps, record, mca: Dict,
                 device) -> Tuple[int, float]:
    """(tier mismatches of the program's routing against the rule run on
    its own importances, the widest gap of its importances from the
    reference's as a share of the call's largest), over every call."""
    from portbench.reference import _lm
    miss, worst = 0, 0.0
    for (imp_ref, _, d), t_p, i_p in zip(record, tiers, imps):
        i_all = torch.as_tensor(i_p, device=device)
        t_rule, _ = _lm.route(i_all, d, s_pad, mca)
        miss += int((t_rule != torch.as_tensor(t_p, device=device)).sum())
        diff = torch.max(torch.abs(i_all[s_pad - n:] - imp_ref))
        worst = max(worst, float(diff / imp_ref.max()))
    return miss, worst


def logit_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap of ``tokens``' logits below the best, by row."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(1, tokens.long()[:, None])[:, 0]
    return float((best - got).max())


def row_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest |got row - ref row| over the larger of the ref row's
    norm and the median ref row norm (rows: the first dimension)."""
    if got.shape != ref.shape:
        raise ValueError(f"rows {tuple(got.shape)} against the "
                         f"reference's {tuple(ref.shape)}")
    g = got.reshape(got.shape[0], -1).float()
    r = ref.reshape(ref.shape[0], -1).float()
    norm = torch.linalg.vector_norm(r, dim=1)
    den = torch.clamp(norm, min=float(norm.median()))
    return float((torch.linalg.vector_norm(g - r, dim=1) / den).max())


def kv_gap(got: List[Tuple[torch.Tensor, torch.Tensor]],
           ref: List[Tuple[torch.Tensor, torch.Tensor]], device) -> float:
    """The widest ``row_gap`` over the layers' K and V rows."""
    return max(row_gap(g.to(device), r)
               for (gk, gv), (rk, rv) in zip(got, ref)
               for g, r in ((gk, rk), (gv, rv)))


def readings(cfg: Dict, seed: int, reqs: List, device,
             rec: Recorder, controls: Tuple[str, ...] = ()) -> Dict:
    """The numbers over ``reqs`` (``None`` where none was read), each
    control's, and ``per_request`` lists of the program's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = manifest.reference(cfg["family"])
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]
    params = weights.make(cfg["model"], dt, seed, device)
    want = mca_calls(cfg)
    per: Dict[str, List] = {"widest_logit_gap": [], "kv_gap": [],
                            "importance_gap": []}
    miss = missing = 0
    ctl: Dict[str, List] = {}
    for c in controls:
        ctl.update({c: [], f"{c}_kv_gap": [], f"{c}_importance_gap": []})
    with torch.no_grad():
        for r in reqs:
            got = rec.records[id(r.prompt)]
            prompt = torch.as_tensor(r.prompt, device=device)
            served = torch.as_tensor(np.asarray(r.out, np.int64),
                                     device=device)
            n, s_pad = len(r.prompt), got["s_pad"]
            tiers, imps = got["tiers"], got["imps"]
            missing += abs(want - len(tiers))
            follow = None
            if want and len(tiers) == want:
                follow = [torch.as_tensor(t[s_pad - n:], device=device).long()
                          for t in tiers]
            record: List = []
            kv: List = []
            lg = ref.served_logits(params, cfg, seed, prompt, s_pad, served,
                                   follow=follow, record=record, kv=kv)
            per["widest_logit_gap"].append(logit_gap(lg, served))
            if follow is not None:
                m, w = routing_gaps(n, s_pad, tiers, imps, record,
                                    cfg["mca"], device)
                miss += m
                per["importance_gap"].append(w)
            rows = rec.rows.get(id(r.prompt))
            if rows is not None:
                per["kv_gap"].append(kv_gap(list(zip(*rows)), kv, device))
            del lg, kv
            for c in controls:
                own, own_kv = [], []
                cl = ref.served_logits(params, cfg, seed, prompt, s_pad,
                                       served, quant=c, record=own,
                                       kv=own_kv)
                back, back_kv = [], []
                lc = ref.served_logits(
                    params, cfg, seed, prompt, s_pad, served,
                    follow=[t for _, t, _ in own] if own else None,
                    record=back, kv=back_kv)
                ctl[c].append(logit_gap(lc, cl.argmax(-1)))
                ctl[f"{c}_kv_gap"].append(kv_gap(own_kv, back_kv, device))
                if own:
                    ctl[f"{c}_importance_gap"].append(max(
                        float(torch.max(torch.abs(i_c - i_r)) / i_r.max())
                        for (i_c, _, _), (i_r, _, _) in zip(own, back)))
    del params
    out = {k: (max(v) if v else None) for k, v in per.items()}
    out.update(routing_mismatches=miss, mca_calls_missing=missing)
    out.update({k: (max(v) if v else None) for k, v in ctl.items()})
    out["per_request"] = per
    return out
