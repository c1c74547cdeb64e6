"""Train and serve steps.

Port of ``repro/train/step.py`` for one device.  The mesh code
(``jit_train_step``, ``train_step_shardings``, ``serve_step_shardings``,
``abstract_state``) belongs to the distribution slice (ROADMAP.md,
Slice F).  PyTorch runs eagerly, so a step is a plain function.
"""
from __future__ import annotations

from repro_torch.core.amm import fold_in
from repro_torch.models.api import Model, _logits
from repro_torch.optim import adamw


def make_train_step(model: Model, opt_cfg: adamw.AdamWConfig,
                    n_micro: int = 1, seed: int = 0, with_mca: bool = True,
                    donate: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics).

    The MCA key of a step is ``fold_in(seed, count)``, with ``count`` the
    optimizer's step count before the update, read on the host.
    ``donate=True`` writes the update into the caller's params and
    optimizer state (the reference's ``donate_argnums``); the default
    leaves them untouched and returns new ones.
    """

    def loss_fn(p, b, k):
        return model.loss(p, b, k if with_mca else None)

    def train_step(params, opt_state, batch):
        key = fold_in(seed, int(opt_state["count"]))
        (loss, metrics), grads = adamw.accumulate_gradients(
            loss_fn, params, batch, n_micro, key)
        params, opt_state, gnorm = adamw.apply_updates(
            opt_cfg, params, grads, opt_state, donate=donate)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        metrics["total_loss"] = loss
        return params, opt_state, metrics

    return train_step


# ------------------------------------------------------------- serving
def make_prefill_step(model: Model, max_len: int, with_mca: bool = True,
                      seed: int = 0):
    """prefill(params, batch) -> (cache, last-position logits)."""
    def prefill(params, batch):
        key = seed if with_mca else None
        cache, hidden, _ = model.prefill(params, batch, max_len, key)
        return cache, _logits(params, model.cfg, hidden[:, -1:])
    return prefill


def make_decode_step(model: Model):
    def decode(params, tokens, cache, t):
        return model.decode(params, tokens, cache, t)
    return decode
