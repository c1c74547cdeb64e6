"""``repro_torch.obs.span`` (and its ``_Span``) against the reference's
``repro.obs.span`` (tests/test_obs.py::TestTracing holds the reference):
the same sequence of spans, on one stepped clock, exports the same
Chrome-trace events (name, category, track, args, ``error`` on an
exception, times), and while tracing is off both hand back one shared
null context and write nothing.
"""
import contextlib
import importlib
import itertools
import time

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro import obs as ref_obs  # noqa: E402
from repro_torch import obs  # noqa: E402

# the modules (each package's ``tracing`` attribute is the context manager)
ref_tracing = importlib.import_module("repro.obs.tracing")
port_tracing = importlib.import_module("repro_torch.obs.tracing")


def _sequence(o):
    """Spans of every form: args, a track, the category as the track, a
    nested pair, an explicit registry, a body that raises, and the
    record/mark forms beside them."""
    with o.span("prefill", cat="serve", track="serve.wave/req0", rows=4):
        with o.span("attend", cat="model", layer=3):
            pass
    with pytest.raises(ValueError):
        with o.span("decode", cat="serve", step=1):
            raise ValueError("boom")
    own = o.Registry()
    with o.span("own", cat="x", registry=own):
        pass
    o.record_span("manual", 10.0, 10.5, cat="t", args={"a": 2})
    o.mark("finish", cat="serve", track="serve.wave/req0")
    with o.span("plain"):
        pass
    return own


def _run(o, monkeypatch):
    clock = itertools.count(100)
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock) * 0.25)
    with o.scoped() as reg, o.tracing():
        own = _sequence(o)
    return (reg.spans(), own.spans(),
            o.export_chrome_trace(None, registry=reg))


def test_span_events_match_reference(monkeypatch):
    """Spans, the explicit registry's span and the exported events are
    the reference's, field for field."""
    mine = _run(obs, monkeypatch)
    theirs = _run(ref_obs, monkeypatch)
    assert mine[0] == theirs[0]
    assert mine[1] == theirs[1] and len(mine[1]) == 1
    assert mine[2] == theirs[2]
    by_name = {s["name"]: s for s in mine[0]}
    assert by_name["decode"]["args"] == {"step": 1, "error": "ValueError"}
    assert by_name["prefill"]["track"] == "serve.wave/req0"
    assert by_name["attend"]["track"] == "model"
    assert by_name["plain"]["track"] == "main"


def test_disabled_span_is_a_shared_null_context():
    """Tracing off: one shared null context, as the reference's, and no
    registry writes."""
    assert not obs.tracing_enabled() and not ref_obs.tracing_enabled()
    for o in (obs, ref_obs):
        with o.scoped() as reg:
            with o.span("x", cat="c", extra=1):
                pass
        assert reg.spans() == []
        assert o.span("a") is o.span("b")
        assert isinstance(o.span("a"), contextlib.nullcontext)
    with obs.tracing():
        assert isinstance(obs.span("on", cat="c", k=1), port_tracing._Span)
    assert port_tracing._Span.__slots__ == ref_tracing._Span.__slots__
