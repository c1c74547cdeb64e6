"""Four small public functions of the reference and their ports:
``core.schedule.effective_alpha``, ``obs.annotate``,
``resilience.tree_finite`` and ``models.common.logits_from_hidden``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import obs as j_obs  # noqa: E402
from repro import resilience as j_res  # noqa: E402
from repro.core import schedule as j_schedule  # noqa: E402
from repro.models import common as j_common  # noqa: E402
from repro_torch import obs, resilience  # noqa: E402
from repro_torch.core import schedule  # noqa: E402
from repro_torch.models import common  # noqa: E402


@pytest.mark.parametrize("alpha,delta", [(0.2, 1.0), (0.3, 0.1),
                                         (1.0, 0.5)])
def test_effective_alpha(alpha, delta):
    assert schedule.effective_alpha(alpha, delta) == \
        j_schedule.effective_alpha(alpha, delta)
    assert schedule.effective_alpha(alpha) == j_schedule.effective_alpha(
        alpha)


def test_annotate_wraps_and_labels():
    """``obs.annotate`` keeps the function's result and name (as the
    reference's decorator does), adds no span without a profiler, and
    labels the call in a ``torch.profiler`` trace."""
    def f(x, y=1):
        return x + y

    g, jg = obs.annotate("mca.f")(f), j_obs.annotate("mca.f")(f)
    assert g(2, y=3) == jg(2, y=3) == 5
    assert g.__name__ == "f"
    assert "annotate" in obs.__all__ and "annotate" in j_obs.__all__
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        g(torch.ones(2))
    assert "mca.f" in {e.name for e in prof.events()}


@pytest.mark.parametrize("case", ["finite", "nan_leaf", "inf_nested",
                                  "ints", "empty"])
def test_tree_finite(case):
    """The same verdict as the reference's on the same tree (numpy leaves
    for the reference, torch tensors for the port)."""
    trees = {
        "finite": {"a": np.ones(3, np.float32), "b": [np.zeros(2), 1.5]},
        "nan_leaf": {"a": np.array([1.0, np.nan], np.float32)},
        "inf_nested": {"x": {"y": [np.ones(2), np.array([np.inf])]}},
        "ints": {"t": np.arange(4, dtype=np.int32), "s": 3},
        "empty": {},
    }
    tree = trees[case]

    def to_torch(t):
        if isinstance(t, dict):
            return {k: to_torch(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_torch(v) for v in t]
        return torch.as_tensor(t) if isinstance(t, np.ndarray) else t

    want = j_res.tree_finite(tree)
    assert resilience.tree_finite(tree) == want
    assert resilience.tree_finite(to_torch(tree)) == want
    assert want == (case in ("finite", "ints", "empty"))
    assert "tree_finite" in resilience.__all__


def test_logits_from_hidden():
    """``x @ table.T`` in f32, within 1e-5 of the reference's largest
    logit, for f32 and bf16 inputs."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    table = rng.standard_normal((96, 64)).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        want = np.asarray(j_common.logits_from_hidden(
            jnp.asarray(table, jdt), jnp.asarray(x, jdt)))
        got = common.logits_from_hidden(torch.as_tensor(table).to(dt),
                                        torch.as_tensor(x).to(dt))
        assert got.dtype == torch.float32 and got.shape == (2, 5, 96)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=1e-5 * np.abs(want).max())
