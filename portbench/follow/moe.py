"""What the output check follows of an MoE-family program, and the
numbers it reads.

The dense family's record (``follow/dense.py``: each insertion's MCA
tiers and importances, its slot and bucket, the K/V rows of a sampled
request still in its slot) and, beside it, the program's expert picks.
The program routes from bf16 activations and the reference from float32
ones, so a token whose k-th and (k+1)-th router probabilities lie within
rounding of each other takes another expert, and the changed output
moves every later layer's routing.  So the reference follows the program
where it decides: it takes the program's top-k experts of every token at
every layer, for the prompt and for each decode step, and computes their
gates, the experts' products and everything else itself.  What that
skips is read by itself: ``pick_gap``.

``Recorder`` wraps, beside the dense recorder's,
``repro_torch.models.ffn.moe_route`` (one call per MoE layer: its
``eid`` [rows, k]) and the model's ``decode``.  An insertion's picks go
to the host at the copy the dense recorder makes once the insertion has
synchronised; a decode step's stay on the device, with the positions
``t`` it was given, until ``snapshot`` copies those of the sampled
requests after the window.  A request in slot ``s`` bucketed to
``s_pad`` fed its j-th served token to the first decode step after its
insertion, and before the slot's next, whose ``t[s]`` is ``s_pad + j``.

``readings`` returns the dense family's numbers, the reference following
the program's tiers and picks, and:

- ``pick_gap``: the widest, over the sample's routed tokens and layers,
  of (the reference's k-th largest router probability - the reference's
  smallest probability among the program's k picks) / that k-th
  largest: 0 where the picks are the reference's top k, near 0 for a
  rounding tie, near 1 for a wrong expert;
- ``moe_calls_missing``: routings recorded for a sampled request beyond
  or short of n_layers x (its insertion + its decode steps).

The float8 control routes by its own picks and is read against the
reference following its tiers and picks: ``fp8_pick_gap`` beside the
dense family's control numbers.
"""
from __future__ import annotations

import gc
import importlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import manifest, weights
from portbench.follow import dense

_FFN = "repro_torch.models.ffn"
#: the numbers compared exactly (limit 0); ``moe_calls_missing`` is
#: compared through the cell's limits file, with limit 0
EXACT = dense.EXACT


class Recorder(dense.Recorder):
    def __init__(self, engine):
        super().__init__(engine)
        self.picks: Dict[int, np.ndarray] = {}   # id(prompt) -> [L, s_pad, k]
        self.seq: Dict[int, int] = {}            # id(prompt) -> insertion no.
        self.inserts: List[Tuple[int, int]] = []     # (slot, id(prompt))
        self.steps: List[Tuple[int, torch.Tensor, List]] = []
        self.decode_picks: Dict[int, Tuple] = {}
        self._routes: List[torch.Tensor] = []
        mod = importlib.import_module(_FFN)
        route_fn = mod.moe_route
        insert_fn = engine.prefill_into         # the dense recorder's
        decode_fn = engine.model.decode

        def route(p, cfg, xf):
            out = route_fn(p, cfg, xf)
            self._routes.append(out[2])
            return out

        def insert(prompt, state, slot, *args, **kwargs):
            self._routes = []
            out = insert_fn(prompt, state, slot, *args, **kwargs)
            eids, self._routes = self._routes, []
            k = eids[0].shape[-1] if eids else 0
            self.picks[id(prompt)] = (
                torch.stack(eids).to(torch.uint8).cpu().numpy()
                if eids else np.zeros((0, out[2], k), np.uint8))
            self.seq[id(prompt)] = len(self.inserts)
            self.inserts.append((slot, id(prompt)))
            return out

        def decode(p, tok, cache, t):
            self._routes = []
            out = decode_fn(p, tok, cache, t)
            self.steps.append((len(self.inserts),
                               torch.as_tensor(t).clone(), self._routes))
            self._routes = []
            return out

        self._patches.set(mod, "moe_route", route)
        self._patches.set(engine, "prefill_into", insert)
        self._patches.set(engine.model, "decode", decode)

    def _steps_of(self, req, ts) -> List[Optional[List[torch.Tensor]]]:
        """The routings of each decode step that fed ``req``'s served
        tokens but the last, in order (None for a step not found);
        ``ts``: each recorded step's positions on the host."""
        rec = self.records[id(req.prompt)]
        slot, s_pad = rec["slot"], rec["s_pad"]
        first = self.seq[id(req.prompt)]
        later = [i for i, (s, _) in enumerate(self.inserts)
                 if s == slot and i > first]
        end = later[0] if later else len(self.inserts)
        found: Dict[int, List[torch.Tensor]] = {}
        for (seq, _, routes), t in zip(self.steps, ts):
            if not first < seq <= end:
                continue
            j = int(t[slot] if t.numel() > 1 else t.reshape(-1)[0]) - s_pad
            if 0 <= j < len(req.out) - 1 and j not in found:
                found[j] = [r[slot] for r in routes]
        return [found.get(j) for j in range(len(req.out) - 1)]

    def snapshot(self, reqs) -> None:
        """The dense recorder's K/V rows, and for each of ``reqs`` its
        decode steps' picks copied to the host (``_stack``); the decode
        record and the cache are dropped after."""
        super().snapshot(reqs)
        ts = [t.cpu().reshape(-1) for _, t, _ in self.steps]
        for r in reqs:
            self.decode_picks[id(r.prompt)] = _stack(self._steps_of(r, ts))
        self.steps = []
        self.cache = None


def _stack(steps) -> Tuple[Optional[np.ndarray], int]:
    """(the steps' picks [steps, L, k] on the host or None, the routings
    the found steps recorded)."""
    routed = sum(len(s) for s in steps if s is not None)
    if any(s is None for s in steps) or len({len(s) for s in steps}) > 1:
        return None, routed
    if not steps:
        return np.zeros((0, 0, 0), np.uint8), 0
    return (torch.stack([torch.stack(s) for s in steps]).to(torch.uint8)
            .cpu().numpy(), routed)


def pick_gap(route_record: List, picks: List[torch.Tensor], k: int
             ) -> float:
    """The widest (k-th largest probability - the smallest among
    ``picks``) / the k-th largest, over every call's rows."""
    worst = 0.0
    for (probs, _), pick in zip(route_record, picks):
        if probs.shape[0] == 0:
            continue
        kth = torch.topk(probs, k, dim=-1).values[:, -1]
        low = probs.gather(1, pick.long()).min(dim=-1).values
        worst = max(worst, float(((kth - low) / kth).max()))
    return worst


def _program_picks(rec: Recorder, req, n_layers: int, device
                   ) -> Tuple[Optional[List[torch.Tensor]], int]:
    """(the program's picks in the reference's call order: per layer the
    prompt's real positions, then the served tokens'; or None where they
    cannot be followed), and the routings missing or in excess."""
    n, m = len(req.prompt), len(req.out)
    pre = rec.picks[id(req.prompt)]
    dec, routed = rec.decode_picks[id(req.prompt)]
    missing = abs(n_layers * m - (len(pre) + routed))
    if len(pre) != n_layers or dec is None or (
            m > 1 and dec.shape[1] != n_layers):
        return None, missing
    out = []
    for i in range(n_layers):
        out.append(torch.as_tensor(pre[i][-n:], device=device).long())
        step = dec[:, i] if m > 1 else np.zeros((0, pre.shape[-1]))
        out.append(torch.as_tensor(step, device=device).long())
    return out, missing


def readings(cfg: Dict, seed: int, reqs: List, device,
             rec: Recorder, controls: Tuple[str, ...] = ()) -> Dict:
    """The numbers over ``reqs`` (``None`` where none was read), each
    control's, and ``per_request`` lists of the program's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the window's engine is freed by its caller, but a patched bound
    # method (the recorder's restored ``prefill_into``) ties it in a
    # cycle: collect it before the reference's weights are drawn
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ref = manifest.reference(cfg["family"])
    m_cfg = cfg["model"]
    k = m_cfg["top_k"]
    dt = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]
    params = weights.make(m_cfg, dt, seed, device)
    want = dense.mca_calls(cfg)
    per: Dict[str, List] = {"widest_logit_gap": [], "kv_gap": [],
                            "importance_gap": [], "pick_gap": []}
    miss = missing = moe_missing = 0
    ctl: Dict[str, List] = {}
    for c in controls:
        ctl.update({c: [], f"{c}_kv_gap": [], f"{c}_importance_gap": [],
                    f"{c}_pick_gap": []})
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
            picks, lost = _program_picks(rec, r, m_cfg["n_layers"], device)
            moe_missing += lost
            record: List = []
            kv: List = []
            routes: List = []
            lg = ref.served_logits(params, cfg, seed, prompt, s_pad, served,
                                   follow=follow, record=record, kv=kv,
                                   picks=picks, route_record=routes)
            per["widest_logit_gap"].append(dense.logit_gap(lg, served))
            if picks is not None:
                per["pick_gap"].append(pick_gap(routes, picks, k))
            if follow is not None:
                mm, w = dense.routing_gaps(n, s_pad, tiers, imps, record,
                                           cfg["mca"], device)
                miss += mm
                per["importance_gap"].append(w)
            rows = rec.rows.get(id(r.prompt))
            if rows is not None:
                per["kv_gap"].append(dense.kv_gap(list(zip(*rows)), kv,
                                                  device))
            del lg, kv, routes
            for c in controls:
                own, own_kv, own_routes = [], [], []
                cl = ref.served_logits(params, cfg, seed, prompt, s_pad,
                                       served, quant=c, record=own,
                                       kv=own_kv, route_record=own_routes)
                own_picks = [pk for _, pk in own_routes]
                back, back_kv, back_routes = [], [], []
                lc = ref.served_logits(
                    params, cfg, seed, prompt, s_pad, served,
                    follow=[t for _, t, _ in own] if own else None,
                    record=back, kv=back_kv, picks=own_picks,
                    route_record=back_routes)
                ctl[c].append(dense.logit_gap(lc, cl.argmax(-1)))
                ctl[f"{c}_kv_gap"].append(dense.kv_gap(own_kv, back_kv,
                                                       device))
                ctl[f"{c}_pick_gap"].append(pick_gap(back_routes,
                                                     own_picks, k))
                if own:
                    ctl[f"{c}_importance_gap"].append(max(
                        float(torch.max(torch.abs(i_c - i_r)) / i_r.max())
                        for (i_c, _, _), (i_r, _, _) in zip(own, back)))
    del params
    out = {key: (max(v) if v else None) for key, v in per.items()}
    out.update(routing_mismatches=miss, mca_calls_missing=missing,
               moe_calls_missing=moe_missing)
    out.update({key: (max(v) if v else None) for key, v in ctl.items()})
    out["per_request"] = per
    return out
