"""Public wrappers around the ported kernels.

One rule for every wrapper: a CPU tensor takes the kernel's plain PyTorch
version (``kernels/ref.py``, the role interpret mode plays in the
reference), and so does a ``meta`` one (shapes only, no data), a CUDA
tensor launches the CUDA kernel or raises.  There is
no fallback on the card: the kernels mask ragged edges themselves, so the
shapes for which the reference's wrappers fall back (``m``, ``sq`` or
``skv`` not a multiple of the block) run the kernel there.  The
``block_*`` arguments are accepted, as the reference accepts them, and do
not change the result.

Accounting keeps the reference's names: every call counts
``kernels.<op>.kernel_calls`` (CUDA kernel) or ``kernels.<op>.fallback_calls``
(plain version) in the active ``obs`` registry.  PyTorch runs eagerly, so
these count executions, not traced call sites as under ``jax.jit``.  The
kernel launchers also keep a plain integer ``launches`` count each
(``launch_counts()``), which a run reads to show that its main path went
through the kernels.

Device telemetry, while ``obs.devtel`` is enabled: every call, on either
device, also emits ``kernels.<op>.device_launches`` and its work count
(``device_sampled_blocks`` for the MCA matmuls, ``device_rows_written``
for the KV write, ``device_tiles`` for flash and colmax).  The kernel (or
the plain version) fills a ``[1, 8]`` telemetry buffer and one add folds
it into devtel's device-side totals: no host read, so the counts survive
where the host's do not (a replayed CUDA graph).  The counts are the
reference's for the same call: its kernel's count where its Pallas kernel
would take the shape, its fallback's value where it would fall back, in
the caller's ``block_*`` units (``kernels/telemetry.py``).  The KV layer
write keeps the reference's meaning of one launch per cache: it adds 2
launches and 2B rows, while ``launch_counts()`` counts its one launch.

MCA prefill's scoring passes (``attn_lse``, ``attn_colmax_pass``,
``attn_av``) take the chunked passes' signatures, and the chunked passes
of ``models.attention`` are their plain versions; they emit no device
telemetry.

No kernel has a backward yet (the reference's Pallas kernels have none
either).  A CUDA launch writes into a fresh tensor that autograd would
see as a constant, so every wrapper refuses, on either device, to run
while grad mode is on and an input it reads requires a gradient
(:func:`_refuse_grad`): a loss taken through a kernel raises instead of
silently training without the gradient that passes through it.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch import obs
from repro_torch.obs import devtel

from . import attn_colmax as _colmax_mod
from . import cache_update as _cache_mod
from . import flash_attention as _flash_mod
from . import mca_matmul as _mca_mod
from . import ref as _ref
from .telemetry import LANE_COUNT, LANE_LAUNCH

#: the launchers whose ``launches`` counts ``launch_counts()`` reports
_LAUNCHERS = {"mca_matmul_fixed": _mca_mod.mca_matmul_fixed,
              "mca_matmul_ragged": _mca_mod.mca_matmul_ragged,
              "kv_slot_update": _cache_mod.kv_slot_update,
              "flash_attention": _flash_mod.flash_attention,
              "attn_colmax": _colmax_mod.attn_colmax,
              "attn_lse": _flash_mod.attn_lse,
              "attn_av": _flash_mod.attn_av}


#: each op's (fallback_calls, kernel_calls) counter names, indexed by bool
_COUNTERS = {op: (f"kernels.{op}.fallback_calls", f"kernels.{op}.kernel_calls")
             for op in ("mca_matmul", "mca_matmul_ragged", "kv_slot_update",
                        "flash_attention", "attn_colmax", "attn_lse",
                        "attn_av")}


def _plain(x: torch.Tensor) -> bool:
    """Whether a call on ``x`` takes the plain version: on the CPU, and on
    the ``meta`` device, whose tensors hold shapes only (``launch.dryrun``
    counts a step's operations there)."""
    return x.device.type in ("cpu", "meta")


class _CustomCall:
    """The body of one wrapper call: a profiler span (``obs.trace``) and,
    for ``launch.hlo_analysis``, a depth count (:func:`inside_call`), so
    a census counts the call as one ``custom-call`` and not the plain
    version's ops, which the card's kernel does not dispatch."""

    __slots__ = ("span",)
    depth = 0

    def __init__(self, name: str):
        self.span = obs.trace(name)

    def __enter__(self):
        _CustomCall.depth += 1
        self.span.__enter__()

    def __exit__(self, *exc):
        _CustomCall.depth -= 1
        return self.span.__exit__(*exc)


def inside_call() -> bool:
    """Whether a wrapper's kernel (or its plain version) is running."""
    return _CustomCall.depth > 0


def _count(op: str, used_kernel: bool, n: int = 1) -> None:
    obs.get_registry().counter(_COUNTERS[op][used_kernel]).inc(n)


def _emit_tel(op: str, work_metric: str, tel: torch.Tensor) -> None:
    """Fold a call's telemetry buffer into devtel (one device add)."""
    devtel.emit_vec((f"kernels.{op}.device_launches",
                     f"kernels.{op}.{work_metric}"),
                    tel[0, LANE_LAUNCH:LANE_COUNT + 1])


def _refuse_grad(op: str, *inputs: Optional[torch.Tensor]) -> None:
    """Raise if autograd would need a gradient through ``op``."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        raise RuntimeError(
            f"kernels.{op}: an input requires a gradient, but the port has "
            "no backward kernel yet (ROADMAP.md); leave "
            "MCAConfig.use_kernel off when training, or call under "
            "torch.no_grad()")


def mca_matmul(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
               inv_rp: torch.Tensor, *, block: int = 128, block_m: int = 128,
               block_f: int = 128) -> torch.Tensor:
    """Fixed-R Monte-Carlo block-sampled matmul (one precision tier).

    x: [m, d]; w: [d, f]; idx: [R] int32; inv_rp: [R] f32 -> [m, f].
    """
    _refuse_grad("mca_matmul", x, w, inv_rp)
    plain = _plain(x)
    _count("mca_matmul", not plain)
    impl = _ref.ref_mca_matmul_fixed if plain else _mca_mod.mca_matmul_fixed
    tel_on = devtel.enabled()
    with _CustomCall("mca_matmul"):
        out = impl(x, w, idx, inv_rp, block=block, telemetry=tel_on,
                   block_m=block_m, block_f=block_f)
    if tel_on:
        out, tel = out
        _emit_tel("mca_matmul", "device_sampled_blocks", tel)
    return out


def mca_matmul_ragged(x: torch.Tensor, w: torch.Tensor, r_tile: torch.Tensor,
                      idx: torch.Tensor, inv_rp: torch.Tensor, *,
                      block: int = 128, block_m: int = 128,
                      block_f: int = 128) -> torch.Tensor:
    """Per-row-tile-R Monte-Carlo matmul (sorted/ragged precision).

    x: [m, d]; w: [d, f]; r_tile: [m_tiles] int32; idx: [m_tiles, R_max]
    int32; inv_rp: [m_tiles, R_max] f32 -> [m, f].  Row tile t is
    ``m // m_tiles`` rows (``r_tile``'s length pins the tile size, as in
    the reference) and sums its first ``r_tile[t]`` samples.
    """
    m_tiles = r_tile.shape[0]
    if m_tiles == 0 or x.shape[0] % m_tiles:
        raise ValueError(f"x {tuple(x.shape)}: rows are not a multiple of "
                         f"{m_tiles} row tiles")
    _refuse_grad("mca_matmul_ragged", x, w, inv_rp)
    plain = _plain(x)
    _count("mca_matmul_ragged", not plain)
    impl = _ref.ref_mca_matmul_ragged if plain else \
        _mca_mod.mca_matmul_ragged
    tel_on = devtel.enabled()
    with _CustomCall("mca_matmul_ragged"):
        out = impl(x, w, r_tile, idx, inv_rp, block=block, telemetry=tel_on,
                   block_m=block_m, block_f=block_f)
    if tel_on:
        out, tel = out
        _emit_tel("mca_matmul_ragged", "device_sampled_blocks", tel)
    return out


def kv_slot_update(cache: torch.Tensor, new: torch.Tensor,
                   pos: torch.Tensor) -> torch.Tensor:
    """Per-row KV-cache write ``cache[b, pos[b]] = new[b, 0]``, in place.

    cache: [B, S, ...]; new: [B, 1, ...] (same trailing dims); pos: [B]
    int32.  Both paths write the caller's tensor and return it (the
    reference donates its buffer and returns the aliased output).
    """
    _refuse_grad("kv_slot_update", cache, new)
    plain = _plain(cache)
    _count("kv_slot_update", not plain)
    impl = _ref.ref_kv_slot_update if plain else _cache_mod.kv_slot_update
    tel_on = devtel.enabled()
    with _CustomCall("kv_slot_update"):
        out = impl(cache, new, pos, telemetry=tel_on)
    if tel_on:
        out, tel = out
        _emit_tel("kv_slot_update", "device_rows_written", tel)
    return out


def kv_slot_update_layer(k_cache: torch.Tensor, k_new: torch.Tensor,
                         v_cache: torch.Tensor, v_new: torch.Tensor,
                         slot_pos: Optional[torch.Tensor],
                         t: Union[int, torch.Tensor], *, window: int) -> None:
    """A decode layer's cache writes, in place, in one kernel launch::

        slot[b] = t[b] % S if window > 0 else t[b]
        k_cache[b, slot[b]] = k_new[b, 0];  v_cache[b, slot[b]] = v_new[b, 0]
        slot_pos[b, slot[b]] = t[b]          (unless slot_pos is None)

    k_cache, v_cache: [B, S, ...] (row widths may differ); k_new, v_new:
    [B, 1, ...]; slot_pos: [B, S] int32 or None; t: an int, or an int32
    tensor of shape [] or [B].  Rows whose slot falls outside [0, S) are
    left alone.

    Counting: ``kernels.kv_slot_update.kernel_calls`` (or
    ``fallback_calls``) counts one per cache written, two per call, as
    the reference's two ``kv_slot_update`` calls count, and so do the
    device counts (``device_launches`` 2, ``device_rows_written`` 2B);
    the launcher's ``launch_counts()["kv_slot_update"]`` counts device
    launches, one per call.
    """
    _refuse_grad("kv_slot_update", k_cache, k_new, v_cache, v_new)
    plain = _plain(k_cache)
    _count("kv_slot_update", not plain, 2)
    impl = _ref.ref_kv_slot_update_layer if plain else \
        _cache_mod.kv_slot_update_layer
    tel_on = devtel.enabled()
    with _CustomCall("kv_slot_update"):
        tel = impl(k_cache, k_new, v_cache, v_new, slot_pos, t,
                   window=window, telemetry=tel_on)
    if tel_on:
        _emit_tel("kv_slot_update", "device_rows_written", tel)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True, block_q: int = 128,
                    block_k: int = 128):
    """Flash attention forward; returns (out, lse).

    q: [B, Hq, Sq, dh]; k, v: [B, Hkv, Skv, dh]; Hq % Hkv == 0.  out is
    [B, Hq, Sq, dh] in q.dtype, lse [B, Hq, Sq] f32.  Causal masking uses
    the diagonal offset ``skv - sq`` (suffix queries).
    """
    _refuse_grad("flash_attention", q, k, v)
    plain = _plain(q)
    _count("flash_attention", not plain)
    impl = _ref.ref_attention if plain else _flash_mod.flash_attention
    tel_on = devtel.enabled()
    with _CustomCall("flash_attention"):
        out = impl(q, k, v, scale=scale, causal=causal, telemetry=tel_on,
                   block_q=block_q, block_k=block_k)
    if not tel_on:
        return out
    out, lse, tel = out
    _emit_tel("flash_attention", "device_tiles", tel)
    return out, lse


def attn_colmax(q: torch.Tensor, k: torch.Tensor, lse: torch.Tensor, *,
                scale: float, causal: bool = True, block_q: int = 128,
                block_k: int = 128, reduce_heads: bool = True
                ) -> torch.Tensor:
    """Column max of A from (q, k, lse): [B, Hq, Skv] f32, or [B, Skv]
    reduced over heads (``reduce_heads``, the reference's default; the
    bf16 kernel reduces in place, the others after)."""
    _refuse_grad("attn_colmax", q, k, lse)
    plain = _plain(q)
    _count("attn_colmax", not plain)
    impl = _ref.ref_colmax if plain else _colmax_mod.attn_colmax
    fused = reduce_heads and not plain and q.dtype == torch.bfloat16
    tel_on = devtel.enabled()
    with _CustomCall("attn_colmax"):
        cm = impl(q, k, lse, scale=scale, causal=causal, telemetry=tel_on,
                  block_q=block_q, block_k=block_k,
                  **({"reduce_heads": True} if fused else {}))
    if tel_on:
        cm, tel = cm
        _emit_tel("attn_colmax", "device_tiles", tel)
    if reduce_heads and not fused:
        cm = torch.amax(cm, dim=1)        # [B, Skv]
    return cm


# ------------------------------------------------ MCA prefill's scoring passes
# The three take the chunked passes' signatures and results
# (``models.attention.chunked_lse``, ``chunked_colmax``, ``chunked_av``:
# q [B, Sq, Hkv, G, dh], k and v [B, Skv, Hkv, dh]), and those passes are
# their plain versions (on the CPU and on ``meta``).  On the card they run
# the bf16 kernels, which take no sliding window; ``chunk`` shapes only
# the plain version.  No telemetry.

def _scoring_pass(op: str, plain_name: str, kernel, tensors, kw):
    """One call of a scoring pass: the chunked pass ``plain_name`` of
    ``models.attention`` on the CPU or ``meta``, else ``kernel(**kw)``
    without ``window`` and ``chunk``."""
    _refuse_grad(op, *tensors)
    plain = _plain(tensors[0])
    _count(op, not plain)
    with _CustomCall(op):
        if plain:
            from repro_torch.models import attention
            return getattr(attention, plain_name)(*tensors, **kw)
        if kw.pop("window"):
            raise ValueError(f"kernels.{op}: the kernel takes no sliding "
                             "window")
        del kw["chunk"]
        return kernel(**kw)


def _heads(q: torch.Tensor) -> torch.Tensor:
    """q [B, Sq, Hkv, G, dh] as the [B, Hkv * G, Sq, dh] view the kernels
    read (query head h = its KV head * G + g)."""
    b, sq, hkv, g, dh = q.shape
    return q.reshape(b, sq, hkv * g, dh).transpose(1, 2)


def attn_lse(q, k, *, scale, causal, window, chunk, q_offset=0,
             kv_valid=None):
    """Pass 1, ``chunked_lse``: (m, lse), each [B, Hkv, G, Sq] f32."""
    def kernel(**kw):
        m, lse = _flash_mod.attn_lse(_heads(q), k.transpose(1, 2), **kw)
        rows = (q.shape[0], q.shape[2], q.shape[3], q.shape[1])
        return m.view(rows), lse.view(rows)
    return _scoring_pass("attn_lse", "chunked_lse", kernel, (q, k), dict(
        scale=scale, causal=causal, window=window, chunk=chunk,
        q_offset=q_offset, kv_valid=kv_valid))


def attn_colmax_pass(q, k, lse, *, scale, causal, window, chunk, q_offset=0,
                     kv_valid=None, q_valid=None):
    """Pass 2, ``chunked_colmax``: max_i A[i, j] over query rows and heads,
    [B, Skv] f32 (counted as ``attn_colmax``)."""
    def kernel(**kw):
        return _colmax_mod.attn_colmax(
            _heads(q), k.transpose(1, 2), lse.flatten(1, 2),
            reduce_heads=True, **kw)
    return _scoring_pass("attn_colmax", "chunked_colmax", kernel,
                         (q, k, lse), dict(
                             scale=scale, causal=causal, window=window,
                             chunk=chunk, q_offset=q_offset,
                             kv_valid=kv_valid, q_valid=q_valid))


def attn_av(q, k, v, lse, *, scale, causal, window, chunk, q_offset=0,
            kv_valid=None):
    """Pass 3, ``chunked_av``: O = A V given lse, [B, Sq, Hkv, G, dv] in
    v's dtype."""
    def kernel(**kw):
        out = torch.empty(q.shape, dtype=v.dtype, device=q.device)
        _flash_mod.attn_av(_heads(q), k.transpose(1, 2), v.transpose(1, 2),
                           lse.flatten(1, 2), out=_heads(out), **kw)
        return out
    return _scoring_pass("attn_av", "chunked_av", kernel, (q, k, v, lse),
                         dict(scale=scale, causal=causal, window=window,
                              chunk=chunk, q_offset=q_offset,
                              kv_valid=kv_valid))


def launch_counts() -> Dict[str, int]:
    """CUDA launches of each kernel since the last reset."""
    return {name: fn.launches for name, fn in _LAUNCHERS.items()}


def reset_launch_counts() -> None:
    for fn in _LAUNCHERS.values():
        fn.launches = 0
