"""The plain reference against ``repro_torch`` at a tiny size, both in
float32 on the CPU: the logits at every served position, with MCA off
and on (the reference draws the same blocks from the same key), and the
reference following the program's recorded routing."""
import types

import numpy as np
import pytest
import torch

from portbench import manifest, serving, testsize
from portbench.follow import dense as fdense
from portbench.reference import _lm


def _program(cfg, mix, seed, n, new):
    """(served tokens, logits at each served position, s_pad, recorder) of
    one request served through the engine (slot 1 of 2)."""
    from repro_torch.models.api import _logits
    dev = torch.device("cpu")
    eng, params = serving.build(cfg, mix, seed, dev)
    rec = fdense.Recorder(eng)
    prompt = np.random.default_rng(seed).integers(
        1, cfg["model"]["vocab_size"], n).astype(np.int32)
    state = eng.init_slot_state()
    state, first, s_pad = eng.prefill_into(prompt, state, 1, new)
    rows = []
    decode = eng.model.decode

    def spy(p, tok, cache, t):
        lg, c = decode(p, tok, cache, t)
        rows.append(lg[1, 0].clone())
        return lg, c

    eng.model.decode = spy
    _, toks, _, _ = eng.decode_burst(state, new - 1)
    rec.close()
    padded = np.pad(prompt, (s_pad - n, 0))[None]
    off = torch.tensor([s_pad - n], dtype=torch.int32)
    key = eng.key if cfg["mca"]["enabled"] else None
    _, hidden, _ = eng.model.prefill(
        params, {"tokens": torch.as_tensor(padded), "pos_offset": off},
        mix["max_len"], key)
    first_row = _logits(params, eng.model.cfg, hidden[:, -1:])[0, 0]
    served = [first] + toks[1, :new - 1].tolist()
    return (prompt, served, torch.stack([first_row] + rows[:new - 1]),
            s_pad, params, rec)


@pytest.mark.parametrize("mca", [False, True])
def test_reference_matches_the_port_in_float32(mca):
    cfg, mix, _ = testsize.tiny("float32")
    cfg["mca"]["enabled"] = mca
    mix = dict(mix, slots=2)
    prompt, served, prog, s_pad, params, rec = _program(cfg, mix, 123, 70, 6)
    ref = manifest.reference(cfg["family"])
    with torch.no_grad():
        lg = ref.served_logits(params, cfg, 123, torch.as_tensor(prompt),
                               s_pad, torch.as_tensor(served))
    v = cfg["model"]["vocab_size"]
    scale = lg[:, :v].abs().max()
    assert float((prog[:, :v] - lg[:, :v]).abs().max() / scale) < 2e-6
    assert prog[:, :v].argmax(-1).tolist() == lg[:, :v].argmax(-1).tolist()
    assert (lg[:, v:] == float("-inf")).all()


def test_mca_changes_what_is_served():
    cfg, mix, _ = testsize.tiny("float32")
    mix = dict(mix, slots=2)
    on = _program(cfg, mix, 123, 70, 6)[2]
    cfg["mca"]["enabled"] = False
    off = _program(cfg, mix, 123, 70, 6)[2]
    assert float((on - off)[:, :512].abs().max()) > 1e-2


def test_the_recorded_routing_is_the_rule_and_the_reference_follows_it():
    cfg, mix, _ = testsize.tiny("float32")
    mix = dict(mix, slots=2)
    # a seed whose prompt fills every tier (at rope theta 1e6 most tiny
    # prompts leave the cheapest one empty)
    prompt, served, prog, s_pad, params, rec = _program(cfg, mix, 9, 90, 5)
    got = rec.records[id(prompt)]
    tiers, imps = got["tiers"], got["imps"]
    assert got["slot"] == 1 and got["s_pad"] == s_pad
    assert tiers.shape == imps.shape == (2 * cfg["model"]["n_layers"], s_pad)
    n = len(prompt)
    ref = manifest.reference(cfg["family"])
    follow = [torch.as_tensor(t[s_pad - n:]).long() for t in tiers]
    record = []
    with torch.no_grad():
        lg = ref.served_logits(params, cfg, 9, torch.as_tensor(prompt),
                               s_pad, torch.as_tensor(served),
                               follow=follow, record=record)
    assert float((prog[:, :512] - lg[:, :512]).abs().max()) < 2e-6
    miss, worst = fdense.routing_gaps(n, s_pad, tiers, imps, record,
                                       cfg["mca"], "cpu")
    assert miss == 0 and worst < 1e-5
    # every tier of the ladder is used, the exact one included
    used = set(np.unique(tiers[:, s_pad - n:]).tolist())
    lad = _lm.ladder(128 // 32, cfg["mca"]["n_tiers"], 1)
    assert used == set(range(len(lad)))


@pytest.mark.parametrize("mca", [False, True])
def test_the_references_kv_rows_are_the_programs_cache_rows(mca):
    """The rows ``snapshot`` copies from the slot are the reference's K
    and V at the same positions: the prompt's real rows, then one a
    decode step."""
    cfg, mix, _ = testsize.tiny("float32")
    cfg["mca"]["enabled"] = mca
    mix = dict(mix, slots=2)
    prompt, served, _, s_pad, params, rec = _program(cfg, mix, 11, 75, 7)
    req = types.SimpleNamespace(uid=0, prompt=prompt, out=served)
    assert rec.resident([req]) == {0}
    rec.snapshot([req])
    k_rows, v_rows = rec.rows[id(prompt)]
    assert k_rows.shape[:2] == (cfg["model"]["n_layers"], 75 + 7 - 1)
    ref = manifest.reference(cfg["family"])
    follow = None
    if mca:
        follow = [torch.as_tensor(t[s_pad - 75:]).long()
                  for t in rec.records[id(prompt)]["tiers"]]
    kv = []
    with torch.no_grad():
        ref.served_logits(params, cfg, 11, torch.as_tensor(prompt), s_pad,
                          torch.as_tensor(served), follow=follow, kv=kv)
    assert fdense.kv_gap(list(zip(k_rows, v_rows)), kv, "cpu") < 1e-5
    # a decode row left unwritten reads its norm over the median's, at
    # most 1
    k_rows[:, -1] = 0
    assert 0.5 < fdense.kv_gap(list(zip(k_rows, v_rows)), kv, "cpu") <= 1.0
