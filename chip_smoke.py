#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the numbers to mean what PERF.md says)
and the CUDA toolkit; imports nothing of JAX or of the JAX package.
Phases, each of which must pass:

1. device  — the card's name and power limit (``nvidia-smi``).
2. build   — compile every CUDA kernel from ``src/repro_torch/csrc`` in
             parallel (``nvcc -Xptxas -v`` lines printed: registers,
             spills, static shared memory).
3. kernels — each kernel against its plain PyTorch version on the card,
             at the serve path's shapes, in bf16: ``mca_matmul_fixed``
             and ``mca_matmul_ragged`` within 1e-2 of the output's max
             magnitude (the output is rounded to bf16 after an f32 sum
             taken in another order), ``kv_slot_update`` bitwise,
             untouched rows included, both its entry point (one cache) and
             its layer write (K, V and slot_pos in one launch: per-row t,
             a host-int t, a window's wrap, layer 7 of the stacked cache;
             phase 9's rows: olmoe-1b-7b's K and V of 16 x 128 with
             slot_pos, minicpm3-4b's ckv (256) and kr (32) with no
             slot_pos, each with a per-row and a host-int t; phase 11's:
             recurrentgemma-9b's K and V of 1 x 256 into a window of 2,048
             slots with slot_pos [4, 2048], a per-row t, a host-int t and
             t >= 2048, the wrap; phase 12's: whisper-small's K and V of
             12 x 64 into 320 slots and internvl2-1b's of 2 x 64 into 576,
             with slot_pos, each with a per-row and a host-int t); the MCA
             matmul also at phase 9's widths (d = f = 2048 at R = 1, 2,
             4; d = f = 2560 at R = 4; d 256, f 2560 at R = 1), phase 11's
             (d 4096, f 256 and 4096, at R = 1, 2, 4) and phase 12's (d =
             f = 768, K = 6; d 896, K = 7, f 128 and 896; R = 1, 2, 4; at
             m 128 and at the rows phase 12 routes, m 384..2,048);
             ``flash_attention`` out within 2e-2
             of max|out| in bf16 (P is rounded to bf16 for PV) and 2e-4 in
             f32, lse within 1e-3, ``attn_colmax`` within 1e-3, at
             starcoder2-3b (24/2 heads, dh 128, causal, also suffix
             queries and a ragged 200), bert-base (12 heads, dh 64, full),
             causal sq > skv (the rows that see no key must give out 0
             and lse -1e30; the others are compared), dh 32, a GQA group
             of 1, one query, and one f32 shape; an empty side (skv 0:
             out 0, lse -1e30; sq 0: colmax 0).  Every case runs again
             with its telemetry buffer on: the outputs must be bitwise
             those with it off and the buffer the plain version's (the
             reference's counts: 1 launch, or 2 for a layer write; the
             sampled blocks, rows or score tiles), also at m = 200 (the
             reference's fallback counts R) and ``ATTN_TIMED`` in 64 x 64
             tiles.
3b. passes — MCA prefill's three scoring passes through their wrappers
             (``ops.attn_lse``, ``attn_colmax_pass``, ``attn_av``) at
             starcoder2-3b's prefill shapes (1 x 24/2 x S x 128 causal, S
             2,048 and 4,096, without left padding and with S / 2 - 1
             padding keys) against the chunked passes: m and lse within
             1e-5 of max(|value|, 1), colmax 1e-4 relative, out 1e-2 of
             max|out|, rows that see no key -1e30 and 0; then timed as
             phase 7 times a kernel (the chunked pass as the plain
             version).
4. parity  — a reduced starcoder2-3b (f32, 2 layers) served on the card
             gives the same tokens as on the CPU (and again in a second
             card run), hidden states and logits within 1e-4.
5. serve   — starcoder2-3b at full width (30 layers, d_model 3072, bf16,
             random weights from a seed) with MCA on
             (alpha=0.2, block=128, use_kernel=True) through both batchers;
             kernel launch counts are reset just before each batcher runs
             and read just after (flash and the ragged matmul are not on
             this path: their counts print as 0); ``kv_slot_update`` must
             launch exactly once per layer per decode step, and each of
             the three scoring-pass kernels (colmax among them) once per
             layer per prefill, with no chunked pass.
5b. entry  — this slice's path, ``repro_torch.kernels`` at full width on
             layer 0 of that model (4 prompts of 512 tokens): q, k, v from
             the port's own layer code; ``flash_attention`` -> (out, lse)
             held against ``onepass_attention``; ``attn_colmax`` against
             ``chunked_colmax`` on that lse; Eq. 9 budgets in [1, d]; the
             value projection of the budget-sorted tokens through
             ``mca_matmul_ragged`` (128-row tiles, each taking the largest
             budget of its rows) against its plain version.  Counts are
             reset just before and read just after.
6. profile — ``torch.profiler`` over one full-width prefill and one
             8-step decode burst: device busy share, kernel launches, the
             largest device kernels and host ops, the device time of the
             port's two serve-path kernels, the host time of the
             ``kv_slot_update`` span and the ``index_put_``, ``arange`` and
             ``remainder`` host ops.
7. numbers — each kernel's time (CUDA events, 100 launches after warm-up;
             its device time from the profiler; the host time to issue a
             call), its bound, its plain version's and one library call's
             time, per call and on the device (summed over the kernels the
             call launches); ``mca_matmul_fixed`` at every serve-path shape
             (``SERVE_MR`` at f = 256 and 3072) and at ``MCA_TIMED`` also
             with cold weights (``COLD_COPIES`` copies of w in turn), both
             ``RAGGED_CASES``; ``kv_slot_update`` at ``KV_SHAPE`` (entry
             point), its layer write at the serve shape beside three
             ``index_put_`` and the two-call writes of one layer,
             its floor (B = 1, one 16-byte row), and where the host time of
             one call goes (each piece of the issue path timed alone);
             phase 9's shapes: ``FAMILY_MCA_TIMED`` and the MLA layer write
             (ckv and kr of minicpm3-4b's decode, two ``index_put_`` as
             its library yardstick); phase 11's: ``HYBRID_MCA_TIMED`` and
             recurrentgemma-9b's layer write (window 2,048, t wrapped,
             three ``index_put_``); phase 12's: ``ENCDEC_VLM_MCA_TIMED``
             and the layer writes of ``ENCDEC_VLM_KV``.
8. train   — the training path (``repro_torch.launch.train``), after the
             serve engine is gone:
             (a) starcoder2-3b at full width (bf16, random weights from
             seed 0) through the launcher's own objects: SyntheticLM
             batch 8 x seq 256, AdamW lr 3e-4 with cosine_schedule(1, 4),
             MCA on v_proj (alpha 0.2, block 128, use_kernel off), finite
             checks on (so the step does not donate), 4 steps; every
             loss and grad norm finite, grad norms > 0, every parameter
             leaf changed by step 1, train.flops_reduction > 1, tier
             occupancy = layers x tokens x steps; step time p50, peak
             memory, wall time, and one more step under the profiler;
             kernel launches, reset before and read after, all 0;
             (b) a reduced f32 starcoder2-3b (2 layers, MCA off, TF32
             off) takes 3 steps on the card and on the CPU from the same
             params and batches: losses within 1e-5 relative, every
             parameter leaf within 1e-4 of its max magnitude;
             (c) kill inside step 5 of 8 (ckpt_every 2) and resume, on
             the reduced config, with deterministic algorithms off (as
             ``launch.train`` runs) and then on: params
             and per-step losses as an uninterrupted run's (rtol 1e-5,
             atol 1e-6); then one flipped byte in the newest arrays.npz
             and restore_latest_valid falls back past it (directory under
             build/, removed afterwards);
             (d) a train step with use_kernel=True raises the wrappers'
             no-backward error and launches nothing.
9. families — the MoE and MLA families, after the train phase (nothing
             else resident): (a) reduced olmoe-1b-7b and minicpm3-4b as in
             phase 4; (b) olmoe-1b-7b then minicpm3-4b at full width (depth
             not cut, bf16, random weights from seed 0), MCA on (alpha
             0.2, block 128, use_kernel; olmoe's sites v_proj, o_proj and
             expert_ffn, minicpm3's v_proj and o_proj), Engine(batch 4,
             max_len 512): a SlotBatcher serves 6 requests (prompts
             16..200, 16 new tokens), then a ContinuousBatcher 4; every
             request ends ok, kv_slot_update launches once per layer per
             decode step, mca_matmul_fixed launches equal
             ``kernels.mca_matmul.kernel_calls`` and the count the
             routing of those prefills gives, every fallback count is 0,
             flops_reduction > 1; two generations of the same prompts give
             the same tokens; prefill and decode p50, tokens/s, peak
             memory, wall time and one profiled prefill and decode burst.
10. devtel — device telemetry through phase 5's engine, (a) between
             phases 5b and 6, before any profiler runs: phase 5's
             SlotBatcher pass four times, devtel off, on, on, off; with it
             on,
             ``kernels.kv_slot_update.device_launches`` = 2 x 30 layers x
             decode steps (the reference's one launch per cache) and
             ``device_rows_written`` 4 x that, ``kernels.mca_matmul``'s
             device launches = its kernel calls = ``launch_counts()`` =
             the routing's, its ``device_sampled_blocks`` the routing's
             (row tiles x R per launch), ``mca.device_tier_hist.t*``
             summed = the tier occupancy; the host's reads of device
             tensors inside the decode bursts the same on as off; decode
             step and prefill p50 of the four runs; phase 5b's entry
             chain with devtel on (flash and colmax tiles, ragged
             sum(r_tile)); (b) after phase 6: one profiled decode burst
             with devtel on (launches beside phase 6's); each timed
             kernel's device time with its buffer off, on, on, off.
11. ssm-hybrid — the SSM and hybrid families, after phase 9 (nothing else
             resident): (a) reduced mamba2-2.7b (2 layers) and
             recurrentgemma-9b (5 layers, so the pattern has a remainder)
             as in phase 4, on equal-length prompts; (b) mamba2-2.7b (MCA
             off: no attention, no site) then recurrentgemma-9b (MCA on
             v_proj and o_proj as in phase 5) at full width (depth not
             cut, bf16, random weights from seed 0), Engine(batch 4,
             max_len 512): ``generate`` of 4 prompts of 256 tokens, 32
             new, then a ContinuousBatcher of 4 requests of 128 tokens, 16
             new; every request ok; kv_slot_update once per attention
             layer per decode step (recurrentgemma 12, mamba2 0; kernel
             calls twice that), mca_matmul_fixed at the routing's count
             (mamba2: every kernel 0), no fallback, flops_reduction > 1
             with MCA on; a second generation of the same prompts gives
             the same tokens; prefill and decode p50, tokens/s, peak
             memory, wall and one profiled prefill and 8-step burst;
             (c) recurrentgemma-9b's window, MCA off, batch 2 x 2,560
             tokens, max_len 2,624: the banded prefill (every attention
             layer takes it) against the chunked one, last-position
             logits within 2e-2 of max |logit|; the rolling tail (slot p %
             2048 holds p for p = 512..2559); 16 decode steps from t =
             2560 wrap onto slots 512..527 in every attention layer, every
             logit finite; two generations give the same tokens.
12. encdec-vlm — the encoder-decoder and VLM families, after phase 11
             (nothing else resident), through the Model API (the
             reference serves them through ``prefill`` and ``decode``:
             ``Engine`` builds no frames or patches): (a) reduced
             whisper-small and internvl2-1b (f32, 2 layers, 2 encoder
             layers, 32 frames, 8 patches, MCA off), card against CPU:
             the same greedy tokens over 8 decode steps (twice on the
             card), hidden states and logits within 1e-4; (b) both at
             full width (depth not cut, bf16, random weights from seed 0,
             MCA on v_proj and o_proj as in phase 5), 4 rows: whisper
             frames [4, 1500, 768] and 256-token prompts, max_len 320;
             internvl patches [4, 256, 896] and 256 text tokens, max_len
             576; prefill then 32 decode steps, t on the device; every
             logit finite, kv_slot_update once per decoder layer per
             step (12, 24), mca_matmul_fixed at the routing's count (the
             encoder's B x 1,500 tokens and whisper's cross v_proj take
             the plain gather: no capacity is a multiple of 128), no
             fallback, ``forward_hidden``'s flops_reduction > 1; a second
             run gives the same tokens; prefill time, decode step p50
             (each step synchronised), tokens/s, peak memory, one profiled
             prefill and 8-step burst; (c) full width in f32 (MCA and
             TF32 off): prefill S - 1 tokens, decode the last, logits
             within 1e-4 of max |logit| of the forward's last position.
13. path-shapes — every (m, d, f, R, dtype, block) that the main paths
             of phases 4-12 gave ``mca_matmul_fixed`` (recorded at the
             wrapper the MCA dispatch calls) is held against the plain
             version as in phase 3, unless phase 3 held it already.
14. dist — the distribution slice, in subprocesses under ``python -m
             torch.distributed.run`` (this script with ``--dist-part``):
             (a) a world of one over NCCL through ``launch.train``'s mesh
             branch (``run_mesh``), starcoder2-3b at full width and
             depth, batch 8 x 256, MCA on v_proj, 2 steps: losses, grad
             norms and every parameter bitwise equal to the unsharded
             launcher objects' in the same process, step p50 and peak of
             both, and one more unsharded run with deterministic
             algorithms on (its bits and step time); (b) two ranks on
             the one card over gloo (NCCL will not put two ranks on one
             GPU), starcoder2-3b at full width, MCA on v_proj and o_proj
             (use_kernel): ``make_prefill_step`` under the (2, 1) mesh
             on 8 prompts of 256 tokens, 4 a rank: each rank's
             mca_matmul_fixed launches = its local routing's (180), no
             fallback, each local tier_hist = the plain apply_capacity
             rerun on the CPU, the all-reduced one = the sum of both
             ranks'; 8 decode steps (one layer write a layer a step,
             logits finite); MCA off, the ranks' logits against a world
             of one's within 1e-2 of max |logit|; (c) two ranks over
             gloo: olmoe-1b-7b at full width (MCA on v_proj, o_proj,
             expert_ffn), a prefill of 4 x 256 tokens a rank: capacity
             ``moe_capacity`` of the local tokens, aux the mean of the
             ranks' local auxes and the stats their sum, bit for bit;
             starcoder2-3b cut to 4 layers, 2 ZeRO-1 steps of 8 x 256:
             the ranks' parameters bitwise equal after each step, each
             split moment half its rows, losses within 1e-2 relative of
             a world of one's; ``psum_compressed`` on CUDA tensors = the
             sum of the ranks' dequantized payloads, bitwise.  The new
             mca_matmul_fixed shapes are held against the plain version
             as in phase 13.
15. tp — tensor parallelism and FSDP, two ranks on the card over gloo
             (``--dist-part tp-serve|tp-train``): (a) starcoder2-3b at
             full width, MCA as in phase 14 (b), on the (1, 2) mesh:
             ``make_prefill_step`` of phase 14 (b)'s 8 prompts (its two
             ranks' rows are this mesh's two MCA chunks), each rank half
             the heads and one KV head: mca_matmul_fixed 360 launches a
             rank, no fallback, layer 0's tier_hist equal to phase 14
             (b)'s and every routing's difference printed, 8 decode
             steps (240 layer writes a rank), MCA off in f32 with TF32
             off against a world of one within 1e-4 of max |logit|,
             peak a rank; (b) olmoe-1b-7b at full width on (1, 2), 4 x
             256: the sequence split into pieces of 512 tokens with that
             capacity, 128 MCA launches a rank; (c) phase 14 (c)'s
             4-layer model on (2, 1), 2 steps with FSDP and 2 ZeRO-1:
             losses, grad norms and every parameter bitwise equal, and
             FSDP's peak a rank below ZeRO-1's; (d) that model in f32,
             2 steps on (1, 2) against (2, 1) ZeRO-1 with MCA on v_proj
             and against a world of one with MCA off, losses and grad
             norms within 1e-5 relative.  The new mca_matmul_fixed
             shapes are held as in phase 13; phases 3 and 7 hold and
             time them and the one-head layer write.
16. tp-families — tensor parallelism of the other five families, two
             ranks on the card over gloo in one launch
             (``--dist-part tp-families``), family by family: (a)
             minicpm3-4b, mamba2-2.7b, recurrentgemma-9b, whisper-small
             and internvl2-1b at full width (bf16, seed-0 weights, cut to
             8 layers, whisper's encoder too, so that the script stays
             within its time) on (1, 2), MCA on v_proj and o_proj
             (use_kernel):
             ``make_prefill_step`` of 4 x 256 tokens (whisper's frames [4,
             1500, 768], internvl's patches [4, 256, 896]) then 8 greedy
             decode steps: mca_matmul_fixed at each rank's routing (two
             chunks of half the rows), kv_slot_update once per attention
             layer a step, no fallback, every logit finite, the ranks'
             tokens equal, each rank holding about half the elements, its
             cache's shapes printed, every kernel shape listed in
             TP16_MCA_CASES (which phase 3 holds and phase 7 times);
             prefill time, decode step p50, peak a rank; (b) the same
             models cut to 4 layers (4 encoder layers) in f32 with TF32
             off, 4 x 128: MCA off, the (1, 2) ranks' logits within 1e-5
             of max |logit| of a world of one; MCA on (the plain sampled
             product), layer 0's tier_hist on (1, 2) equal to (2, 1)'s,
             the logits between them printed; (c) 2 AdamW steps on (1, 2)
             through ``jit_train_step`` against a world of one, MCA off:
             losses and grad norms within 1e-5 relative.  Rank 0 holds
             every mca_matmul_fixed shape of (a) against the plain
             version, as phase 13.

17. sp — the sequence-parallel residual (the residual between layers
             split by sequence over "model", as the reference places
             it), two ranks on the card over gloo (``--dist-part sp``),
             mesh (1, 2): (a) starcoder2-3b at full width cut to 8
             layers, bf16, remat on, MCA on v_proj (the plain sampled
             product): one loss and backward of 4 x 1,024 tokens (split:
             each rank's checkpointed layer inputs [4, 512, 3072]) after
             a warm-up, then of 4 x 1,023 (the reference's rule keeps it
             whole): the bytes held after the forward differ by 8 x 4 x
             1,024 x 3,072 x 2 B / 2 = 100.7 MB a rank, within 10%; peak
             and step time of both; (b) starcoder2-3b at full width, a
             no-grad ``forward_hidden`` of 4 x 512 with the split, MCA on
             v_proj and o_proj (use_kernel): mca_matmul_fixed at the
             routing's count (two chunks of 1,024 tokens a rank), no
             fallback, hidden states finite; 4 layers in f32 (TF32 and
             MCA off): each rank's hidden states within 1e-4 of max |h|
             of a world of one; in this process (c) (a)'s train step
             with MCA off on one rank: ``FlopCounterMode``'s count on the
             card equal to ``launch.dryrun``'s on meta tensors, the step
             time printed beside the roofline's t_compute; (d)
             ``examples/torch_quickstart.py`` and
             ``examples/torch_serve_mca.py`` each exit 0 within 60 s;
             (e) the two ranks of (a) and (b), after (b), with
             starcoder2-3b cut to 8 layers, bf16: a train step (FSDP,
             MCA off) of 4 x 1,024, a prefill of 4 x 512 with MCA on
             v_proj and o_proj through the kernel, one decode step (the
             layer write), each counted by ``launch.hlo_analysis`` on
             the card; from the end of (b), beside it and (d), a
             process for each rank counts it on ``meta`` tensors in a
             counting world (``launch.mesh.counting_world``), and (c)
             runs after them: the collective census
             (count and bytes per kind and per mesh axes) and the op
             census (ATen ops, dots, sorts, custom calls) equal, the
             card's custom calls its ``kernel_calls`` (no fallback), the
             train step's FLOPs equal; the meta peak
             (``temp_size_in_bytes``) printed beside the card's
             ``max_memory_allocated`` over the step.
18. mesh-2d — the (2, 2) mesh over ("data", "model"), four ranks on the
             card over gloo (``--dist-part mesh-2d``): (a) starcoder2-3b
             at full width (bf16, seed-0 weights), MCA on v_proj and
             o_proj (use_kernel): ``make_prefill_step`` of 2 x 63 tokens,
             one row a data shard, whose 63 tokens the model axis does not
             divide, so the MCA routing is global (the 126 tokens'
             capacities 126, 63, 47, 32): mca_matmul_fixed 180 launches a
             rank, no fallback, the four ranks' tier_hist equal and equal
             to ``apply_capacity`` rerun on the CPU over the gathered
             tiers and importances; 8 greedy decode steps: kv_slot_update
             240 launches a rank, logits finite, the two model ranks of
             each data shard decode the same tokens; prefill time, decode
             step p50, peak a rank; (b) 4 x 256 tokens (two chunks of 256
             a rank: the chunked routing): 360 launches a rank, no
             fallback, the summed tier_hist equal on the four ranks; (c)
             starcoder2-3b cut to 4 layers, f32, TF32 off, MCA on v_proj
             (the plain sampled product): a prefill of 2 x 63 on (2, 2)
             against a world of one with the same key, every layer's
             tier_hist equal and each rank's logits within 1e-4 of max
             |logit| (a routing whose importances lie within 1e-3 of a
             ladder rung, or nearly tie, is printed, and only the layers
             before it are held); 2 AdamW steps of ``jit_train_step``
             (FSDP) on 2 x 63 against a world of one, losses and grad
             norms within 1e-5 relative.  Rank 0 holds every
             mca_matmul_fixed shape of (a) and (b) against the plain
             version, as phase 13; phases 3 and 7 hold and time
             ``MESH2D_MCA_CASES``.

Phase 10 runs between phases 5b and 7; phases 14 to 18 last.
Builds four sources (one ``nvcc`` each, in parallel).  Ends with a
``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power
line and, last, ``{"ok": true, "device": {...}}``.  Exits non-zero (and
prints no result) on any failure or without a card.
"""
from __future__ import annotations

import functools
import json
import math
import pathlib
import subprocess
import sys
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12        # H100 SXM (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12        # dense bf16 tensor-core peak
MCA_CASES = [(64, 3072, 256, 1), (128, 3072, 256, 4), (24, 3072, 3072, 2),
             (128, 3072, 3072, 4), (256, 3072, 3072, 4)]
MCA_TIMED = (128, 3072, 3072, 4)  # o_proj: 128 rows at the 4-block rung
# phase 9's shapes: olmoe-1b-7b v_proj/o_proj (d = f = 2048, K = 16),
# minicpm3-4b o_proj (d = f = 2560, K = 20) and w_uv (d 256, f 2560: K = 2,
# so only R = 1 is sampled)
FAMILY_MCA_CASES = [(128, 2048, 2048, 1), (128, 2048, 2048, 2),
                    (128, 2048, 2048, 4), (128, 2560, 2560, 4),
                    (128, 256, 2560, 1)]
FAMILY_MCA_TIMED = [(128, 2048, 2048, 4), (128, 256, 2560, 1)]
# phase 11's shapes: recurrentgemma-9b's attention layers, v_proj d 4096 ->
# f 256 (one KV head) and o_proj 4096 -> 4096, K = 32 blocks
HYBRID_MCA_CASES = [(128, 4096, f, r) for f in (256, 4096) for r in (1, 2, 4)]
HYBRID_MCA_TIMED = [(128, 4096, 256, 4), (128, 4096, 4096, 4)]
# phase 12's shapes: whisper-small v_proj/o_proj (d = f = 768, K = 6: the
# ladder (1, 2, 4, 6)); internvl2-1b v_proj (d 896, K = 7, odd; f 128,
# one column tile) and o_proj (d = f = 896); at m 128 and at the rows
# phase 12 routes to the tiers of 1, 2 and 4 blocks: 1,024 / 512 / 384 of
# whisper's 4 x 256 decoder tokens, 2,048 / 1,024 / 768 of internvl's
# 4 x (256 + 256) positions (phase 12 fails on a shape not held here)
ENCDEC_VLM_MCA_CASES = [(128, d, f, r) for d, f in ((768, 768), (896, 128),
                                                    (896, 896))
                        for r in (1, 2, 4)] + [
    (m, 768, 768, r) for m, r in ((1024, 1), (512, 2), (384, 4))] + [
    (m, 896, f, r) for f in (128, 896)
    for m, r in ((2048, 1), (1024, 2), (768, 4))]
ENCDEC_VLM_MCA_TIMED = [(128, 768, 768, 4), (128, 896, 128, 4),
                        (128, 896, 896, 4)]
# phase 15's shapes: starcoder2-3b on a model axis of 2, v_proj on a
# rank's 128 output columns (one KV head) and o_proj on its 1,536 input
# columns (12 of the 24 blocks); its layer write of one KV head of 128
TP_MCA_CASES = [(128, 3072, 128, r) for r in (1, 2, 4)] + [
    (128, 1536, 3072, r) for r in (1, 2, 4)]
TP_MCA_TIMED = [(128, 3072, 128, 4), (128, 1536, 3072, 4)]
TP_KV = (272, (1, 128))
# phase 16's shapes: the five families on a model axis of 2, at the rows
# 4 x 256 prompts route to each sampled tier of a rank's two chunks of
# 512 tokens (internvl: 1,024 positions): minicpm3-4b w_uv (d 256, 20
# heads' 1,280 columns) and wo (its 10 input blocks); whisper-small v_proj
# (6 heads' 384 columns) and self and cross o_proj (3 input blocks);
# internvl2-1b v_proj (one KV head's 64 columns) and o_proj (448 input
# columns, 3.5 blocks, on the block grid: 4 blocks with 64 zero columns);
# recurrentgemma-9b v_proj (128 of 256 columns under repeat_kv) and o_proj
# (16 input blocks).  Phase 16 fails on a shape not listed here.
TP16_MCA_CASES = [
    (512, 256, 1280, 1), (512, 1280, 2560, 1), (256, 1280, 2560, 2),
    (512, 768, 384, 1), (256, 768, 384, 2), (512, 384, 768, 1),
    (256, 384, 768, 2), (1024, 896, 64, 1), (512, 896, 64, 2),
    (384, 896, 64, 4), (1024, 512, 896, 1), (512, 512, 896, 2),
    (384, 512, 896, 4), (512, 4096, 128, 1), (256, 4096, 128, 2),
    (512, 2048, 4096, 1), (256, 2048, 4096, 2)]
TP16_MCA_TIMED = [(128, 256, 1280, 1), (128, 1280, 2560, 4),
                  (128, 768, 384, 4), (128, 384, 768, 4), (128, 896, 64, 4),
                  (128, 512, 896, 4), (128, 4096, 128, 4),
                  (128, 2048, 4096, 4)]
# phase 18's shapes: starcoder2-3b on (2, 2), v_proj on a rank's 128
# columns and o_proj on its 1,536 input columns, at the caps of the
# global routing of 2 x 63 tokens (126, 63, 47) and of a chunk of 256
# tokens (256, 128, 96; TP_MCA_CASES holds 128)
MESH2D_MCA_CASES = [(m, d, f, r) for d, f in ((3072, 128), (1536, 3072))
                    for m, r in ((126, 1), (63, 2), (47, 4), (256, 1),
                                 (96, 4))]
# phase 16's layer writes: a rank's self K/V heads (whisper 6 of 12,
# internvl 1 of 2); minicpm3-4b's latent rows and recurrentgemma-9b's one
# KV head are phase 9's and phase 11's, whole on every rank
TP16_KV = [("whisper-small TP 2 (6 heads)", 320, (6, 64)),
           ("internvl2-1b TP 2 (one KV head)", 576, (1, 64))]
# (m, R) of every sampled tier of the serve path: a prefill bucket of n
# tokens (16..256) fills the 1-, 2- and 4-block tiers up to n, n/2, 3n/8
SERVE_MR = [(6, 4), (8, 2), (12, 4), (16, 1), (16, 2), (24, 4), (32, 1),
            (32, 2), (48, 4), (64, 1), (64, 2), (96, 4), (128, 1), (128, 2),
            (256, 1)]
MCA_KERNEL = "mca_"               # in the name of the bf16 matmul kernel
FLASH_KERNEL = "rows_bf16_kernel"  # the bf16 row-owner kernel (flash mode)
COLD_COPIES = 24                  # 24 x 3.1 MB of sampled w > the 50 MB L2
# (m, d, f, r_tile, R_max): 128-row tiles of a 512-token bucket
RAGGED_CASES = [(512, 3072, 3072, (4, 2, 1, 0), 4),      # o_proj
                (512, 3072, 256, (4, 2, 1, 0), 4)]       # v_proj
# (b, hq, hkv, sq, skv, dh, causal, dtype)
ATTN_CASES = [(4, 24, 2, 512, 512, 128, True, "bfloat16"),   # starcoder2-3b
              (1, 24, 2, 256, 512, 128, True, "bfloat16"),   # suffix queries
              (4, 12, 12, 512, 512, 64, False, "bfloat16"),  # bert-base
              (1, 24, 2, 200, 200, 128, True, "bfloat16"),   # ragged edges
              (1, 4, 2, 192, 64, 128, True, "bfloat16"),     # sq > skv
              (2, 2, 2, 64, 192, 32, True, "bfloat16"),      # dh 32
              (2, 8, 8, 384, 384, 128, True, "bfloat16"),    # GQA group 1
              (1, 2, 1, 1, 5, 64, True, "bfloat16"),         # one query
              (2, 24, 2, 256, 256, 128, True, "float32")]
ATTN_TIMED = ATTN_CASES[0]
# telemetry: one more fixed shape, m = 200 (the reference falls back on it
# and counts R); ATTN_TIMED is also counted in 64 x 64 tiles
TEL_MCA_CASES = [(200, 3072, 256, 2)]
TEL_CHECKED = []                  # (what, [launches, count]) of phase 3
MCA_HELD = set()                  # (m, d, f, R) phase 3 held: bf16, block 128
SERVE_KERNELS = ("mca_matmul_fixed", "kv_slot_update")
ENTRY_KERNELS = ("flash_attention", "attn_colmax", "mca_matmul_ragged")
#: MCA prefill's scoring passes on the serve path (bf16 GQA, no window);
#: attn_colmax's launcher serves both paths
PASS_KERNELS = ("attn_lse", "attn_colmax", "attn_av")
#: what only the entry-point path launches
ENTRY_ONLY = ("flash_attention", "mca_matmul_ragged")
#: the passes' wrappers (ops), named in the kernels line, and the launcher
#: each counts under
PASS_WRAPPERS = {"attn_lse": "attn_lse", "attn_colmax_pass": "attn_colmax",
                 "attn_av": "attn_av"}


def _passes_together(launches) -> bool:
    """The three scoring-pass kernels launch together, or none does."""
    return len({launches[k] for k in PASS_KERNELS}) == 1
KV_SHAPE = (4, 512, 256)          # one layer's K (or V) cache, flattened
KV_STACK = (30, 4, 512, 2, 128)   # layer-stacked cache of the serve path
OLMOE_KV_TAIL = (16, 128)         # olmoe-1b-7b: a K or V row of 4 KB
MLA_TAILS = ((256,), (32,))       # minicpm3-4b: ckv and kr rows, no slot_pos
HYBRID_KV = (2048, (1, 256))      # recurrentgemma-9b: window slots, K/V row
# phase 12's self-attention caches: (model, max_len, K/V row)
ENCDEC_VLM_KV = [("whisper-small", 320, (12, 64)),    # rows of 1,536 bytes
                 ("internvl2-1b", 576, (2, 64))]      # rows of 256 bytes


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, n: int = 100, warmup: int = 10) -> float:
    """Mean device time of ``fn()`` over ``n`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def host_us(fn, n: int = 100, warmup: int = 10) -> float:
    """Mean host time of issuing ``fn()`` over ``n`` calls without waiting
    for the card: what one call costs the CPU.  Back-to-back calls take
    the larger of this and the device time."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return issued / n * 1e6


# ------------------------------------------------------------- phase 2
def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {len(_build.SOURCES)} kernels in "
        f"{time.perf_counter() - t0:.1f}s ({_build.BUILD_DIR})")
    for name, report in sorted(_build.ptxas_report.items()):
        for line in report.splitlines():
            if "ptxas" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")


# ------------------------------------------------------------- phase 3
def _mca_inputs(m, d, f, r, seed, dtype=None, block=128):
    import torch
    from repro_torch.core import amm
    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, d), generator=g, device="cuda").to(dtype)
    w = (torch.randn((d, f), generator=g, device="cuda")
         / d ** 0.5).to(dtype)
    idx, inv_rp = amm.draw_block_samples(g, amm.block_probs(w, block), r)
    return x, w, idx, inv_rp


class _MCAShapes:
    """While installed, records (m, d, f, R, dtype, block) of every call
    the MCA dispatch makes to ``repro_torch.kernels.mca_matmul`` (the
    wrapper that launches mca_matmul_fixed) and passes the call on
    unchanged; ``phase_path_shapes`` holds what it saw."""

    def __enter__(self):
        import repro_torch.kernels as kernels
        self._pkg, self._inner = kernels, kernels.mca_matmul
        self.seen = set()

        def recorded(x, w, idx, inv_rp, *, block=128, **kw):
            self.seen.add((x.shape[0], x.shape[1], w.shape[1], idx.shape[0],
                           str(x.dtype).split(".")[-1], block))
            return self._inner(x, w, idx, inv_rp, block=block, **kw)
        kernels.mca_matmul = recorded
        return self

    def __exit__(self, *exc):
        self._pkg.mca_matmul = self._inner


def phase_path_shapes(seen):
    """Phase 13: every (m, d, f, R, dtype, block) the main paths of
    phases 4-12 gave mca_matmul_fixed, held against the plain version
    as phase 3 holds its cases; a shape phase 3 held is not run again.
    Returns the max abs error of the shapes run here."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.mca_matmul import mca_matmul_fixed
    todo = sorted(sh for sh in seen if sh[4:] != ("bfloat16", 128)
                  or sh[:4] not in MCA_HELD)
    worst = 0.0
    for m, d, f, r, dt, block in todo:
        dtype = getattr(torch, dt)
        x, w, idx, inv_rp = _mca_inputs(m, d, f, r, seed=m + f + r,
                                        dtype=dtype, block=block)
        want = ref.ref_mca_matmul_fixed(x, w, idx, inv_rp, block).float()
        got = mca_matmul_fixed(x, w, idx, inv_rp, block=block)
        torch.cuda.synchronize()
        rel = 1e-2 if dtype == torch.bfloat16 else 1e-4
        worst = max(worst, _held(
            f"[path-shapes] mca_matmul_fixed m={m} d={d} f={f} R={r} {dt} "
            f"block {block}", got, want, rel * float(want.abs().max())))
    log(f"[path-shapes] mca_matmul_fixed ran at {len(seen)} shapes on the "
        f"main paths: {len(seen) - len(todo)} held in phase 3, {len(todo)} "
        f"held here, max|err| {worst:.3e}")
    if not seen:
        raise AssertionError("no mca_matmul_fixed call was recorded")
    return worst


def _tel_held(what, off, on, want):
    """Telemetry on against off: every output bitwise equal (``on`` ends
    with the buffer), and the buffer equal to the plain version's (the
    reference's counts for the call)."""
    import torch
    offs = off if isinstance(off, tuple) else (off,)
    for a, b in zip(offs, on[:-1]):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: an output with telemetry on "
                                 "differs from it off")
    if not torch.equal(on[-1], want):
        raise AssertionError(f"{what}: telemetry {on[-1].tolist()} != the "
                             f"reference's counts {want.tolist()}")
    TEL_CHECKED.append((what, on[-1][0, :2].tolist()))


def phase_kernels():
    """Each kernel vs its plain version, and with its telemetry buffer on
    against off; returns max abs errors."""
    import torch
    from repro_torch.kernels import cache_update, ref
    from repro_torch.kernels.mca_matmul import mca_matmul_fixed
    errs = {"mca_matmul_fixed": 0.0, "kv_slot_update": 0.0}
    cases = [(c, "sampled") for c in MCA_CASES + FAMILY_MCA_CASES
             + HYBRID_MCA_CASES + ENCDEC_VLM_MCA_CASES + TP_MCA_CASES
             + TP16_MCA_CASES + MESH2D_MCA_CASES] + [
        ((128, 3072, 3072, 24), "exact")] + [
        (c, "telemetry") for c in TEL_MCA_CASES]
    for (m, d, f, r), mode in cases:
        x, w, idx, inv_rp = _mca_inputs(m, d, f, r, seed=m + f + r)
        if mode == "exact":
            idx = torch.arange(d // 128, dtype=torch.int32, device="cuda")
            inv_rp = torch.ones(d // 128, dtype=torch.float32, device="cuda")
            want = x.float() @ w.float()
        else:
            want = ref.ref_mca_matmul_fixed(x, w, idx, inv_rp, 128).float()
        got = mca_matmul_fixed(x, w, idx, inv_rp, block=128)
        torch.cuda.synchronize()
        err = _held(f"[kernels] mca_matmul_fixed {mode} m={m} d={d} f={f} "
                    f"R={r}", got, want, 1e-2 * float(want.abs().max()))
        if mode == "sampled":
            errs["mca_matmul_fixed"] = max(errs["mca_matmul_fixed"], err)
            MCA_HELD.add((m, d, f, r))
        _tel_held(f"mca_matmul_fixed m={m} d={d} f={f} R={r}", got,
                  mca_matmul_fixed(x, w, idx, inv_rp, block=128,
                                   telemetry=True),
                  ref.ref_mca_matmul_fixed(x, w, idx, inv_rp, 128,
                                           telemetry=True)[1])

    # f32 variant (CUDA tensors of an f32 model take it), small shape
    x, w, idx, inv_rp = _mca_inputs(48, 256, 128, 2, seed=1,
                                    dtype=torch.float32)
    want = ref.ref_mca_matmul_fixed(x, w, idx, inv_rp, 128)
    got = mca_matmul_fixed(x, w, idx, inv_rp, block=128)
    _held("[kernels] mca_matmul_fixed f32 m=48 d=256 f=128 R=2", got, want,
          1e-4 * float(want.abs().max()))
    _tel_held("mca_matmul_fixed f32 m=48", got,
              mca_matmul_fixed(x, w, idx, inv_rp, block=128, telemetry=True),
              ref.ref_mca_matmul_fixed(x, w, idx, inv_rp, 128,
                                       telemetry=True)[1])

    g = torch.Generator(device="cuda").manual_seed(7)
    b, s, f = KV_SHAPE
    cache = torch.randn(KV_SHAPE, generator=g, device="cuda").bfloat16()
    new = torch.randn((b, 1, f), generator=g, device="cuda").bfloat16()
    pos = torch.randint(0, s, (b,), generator=g, device="cuda",
                        dtype=torch.int32)
    got = cache_update.kv_slot_update(cache.clone(), new, pos)
    want = ref.ref_kv_slot_update(cache.clone(), new, pos)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError("kv_slot_update [4,512,256] != plain version")
    _tel_held("kv_slot_update [4,512,256]", got,
              cache_update.kv_slot_update(cache.clone(), new, pos,
                                          telemetry=True),
              ref.ref_kv_slot_update(cache.clone(), new, pos,
                                     telemetry=True)[1])
    stack = torch.randn(KV_STACK, generator=g, device="cuda").bfloat16()
    new5 = torch.randn((KV_STACK[1], 1) + KV_STACK[3:], generator=g,
                       device="cuda").bfloat16()
    got_s, want_s = stack.clone(), stack.clone()
    cache_update.kv_slot_update(got_s[7], new5, pos)
    ref.ref_kv_slot_update(want_s[7], new5, pos)
    torch.cuda.synchronize()
    if not torch.equal(got_s, want_s):
        raise AssertionError("kv_slot_update on layer 7 of a stacked cache "
                             "!= plain version")
    log("[kernels] kv_slot_update [4,512,256] and layer 7 of "
        "[30,4,512,2,128]: bitwise equal to the plain version")
    _check_layer_write(g)
    errs["mca_matmul_ragged"] = _check_ragged()
    errs.update(_check_attention())
    log(f"[kernels] telemetry on against off: bitwise equal outputs, and "
        f"the reference's counts, in {len(TEL_CHECKED)} calls: "
        + "; ".join(f"{what} {n}" for what, n in TEL_CHECKED))
    return errs


def _layer_inputs(g, lead=(), b=KV_STACK[1], s=KV_STACK[2],
                  tail=KV_STACK[3:], t_lo=0, t_hi=None, v_tail=None):
    """K and V caches of ``lead + (b, s) + tail`` bf16 (V's rows
    ``v_tail`` wide when given), their new rows, slot_pos
    (``lead + (b, s)`` int32) and a per-row t in [t_lo, t_hi)."""
    import torch

    def rand(shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    v_tail = tail if v_tail is None else v_tail
    k, v = rand(lead + (b, s) + tail), rand(lead + (b, s) + v_tail)
    kn, vn = rand((b, 1) + tail), rand((b, 1) + v_tail)
    spos = torch.randint(-1, s, lead + (b, s), generator=g, device="cuda",
                         dtype=torch.int32)
    t = torch.randint(t_lo, s if t_hi is None else t_hi, (b,), generator=g,
                      device="cuda", dtype=torch.int32)
    return k, v, kn, vn, spos, t


def _check_layer_write(g):
    """The layer write (K, V and slot_pos in one launch) against its plain
    version, bitwise, whole tensors compared (untouched rows included): the
    serve shape with per-row t, a host-int t, a window's wrap (t >= S), and
    layer 7 of the layer-stacked cache."""
    import torch
    from repro_torch.kernels import cache_update, ref
    b, s = KV_STACK[1], KV_STACK[2]
    cases = [("[4,512,2,128] per-row t", (), 0, 0, None, False),
             ("[4,512,2,128] host-int t", (), 0, 0, None, True),
             ("[4,512,2,128] window 512, t in [512, 2048)", (), 512, s,
              4 * s, False),
             ("layer 7 of [30,4,512,2,128]", KV_STACK[:1], 0, 0, None, False)]
    for what, lead, window, t_lo, t_hi, host_int in cases:
        k, v, kn, vn, spos, t = _layer_inputs(g, lead, t_lo=t_lo, t_hi=t_hi)
        if host_int:
            t = s // 3
        got, want = [k.clone(), v.clone(), spos.clone()], [k, v, spos]
        on = [x.clone() for x in got]
        gl = [x[7] for x in got] if lead else got
        wl = [x[7] for x in want] if lead else want
        ol = [x[7] for x in on] if lead else on
        cache_update.kv_slot_update_layer(gl[0], kn, gl[1], vn, gl[2], t,
                                          window=window)
        tel = cache_update.kv_slot_update_layer(ol[0], kn, ol[1], vn, ol[2],
                                                t, window=window,
                                                telemetry=True)
        want_tel = ref.ref_kv_slot_update_layer(wl[0], kn, wl[1], vn, wl[2],
                                                t, window=window,
                                                telemetry=True)
        torch.cuda.synchronize()
        for name, a, w in zip(("K", "V", "slot_pos"), got, want):
            if not torch.equal(a, w):
                raise AssertionError(f"kv_slot_update_layer {what}: {name} "
                                     "!= plain version")
        _tel_held(f"kv_slot_update_layer {what}", tuple(got),
                  tuple(on) + (tel,), want_tel)
    log("[kernels] kv_slot_update_layer (K, V, slot_pos in one launch) at "
        f"{'; '.join(c[0] for c in cases)}: bitwise equal to the plain "
        "version, untouched rows included")
    _check_family_layer_writes(g)


def _check_family_layer_writes(g):
    """Phase 9's and phase 12's layer writes, bitwise against the plain
    version, whole tensors compared: olmoe-1b-7b's K and V rows (16 x
    128) with slot_pos, minicpm3-4b's latent rows (ckv 256 and kr 32
    wide, 512 and 64 bytes) with no slot_pos, whisper-small's self K and
    V rows (12 x 64) into 320 slots and internvl2-1b's (2 x 64) into 576,
    with slot_pos; each with a per-row t and a host-int t."""
    import torch
    from repro_torch.kernels import cache_update, ref
    cases = [("olmoe K, V [4,512,16,128] + slot_pos", KV_STACK[2],
              OLMOE_KV_TAIL, None, True),
             ("MLA ckv [4,512,256], kr [4,512,32], no slot_pos", KV_STACK[2],
              MLA_TAILS[0], MLA_TAILS[1], False)] + [
        (f"{arch} K, V [4,{slots},{tail[0]},{tail[1]}] + slot_pos", slots,
         tail, None, True) for arch, slots, tail in ENCDEC_VLM_KV] + [
        ("starcoder2-3b TP 2, one KV head: K, V [4,272,1,128] + slot_pos",
         TP_KV[0], TP_KV[1], None, True)] + [
        (f"{what}: K, V [4,{slots},{tail[0]},{tail[1]}] + slot_pos", slots,
         tail, None, True) for what, slots, tail in TP16_KV]
    for what, s, tail, v_tail, with_spos in cases:
        for host_int in (False, True):
            k, v, kn, vn, spos, t = _layer_inputs(g, s=s, tail=tail,
                                                  v_tail=v_tail)
            if host_int:
                t = s // 3
            if not with_spos:
                spos = None
            got = [k.clone(), v.clone()] + ([spos.clone()] if with_spos
                                            else [])
            on = [x.clone() for x in got]
            want = [k, v] + ([spos] if with_spos else [])
            cache_update.kv_slot_update_layer(
                got[0], kn, got[1], vn, got[2] if with_spos else None, t,
                window=0)
            tel = cache_update.kv_slot_update_layer(
                on[0], kn, on[1], vn, on[2] if with_spos else None, t,
                window=0, telemetry=True)
            want_tel = ref.ref_kv_slot_update_layer(
                want[0], kn, want[1], vn, want[2] if with_spos else None, t,
                window=0, telemetry=True)
            torch.cuda.synchronize()
            kind = f"{what} {'host-int' if host_int else 'per-row'} t"
            for name, a, w in zip(("K", "V", "slot_pos"), got, want):
                if not torch.equal(a, w):
                    raise AssertionError(
                        f"kv_slot_update_layer {kind}: {name} "
                        "!= plain version")
            _tel_held(f"kv_slot_update_layer {kind}", tuple(got),
                      tuple(on) + (tel,), want_tel)
    log("[kernels] kv_slot_update_layer at "
        f"{'; '.join(c[0] for c in cases)}, per-row and host-int t: bitwise "
        "equal to the plain version, untouched rows included")
    _check_hybrid_layer_writes(g)


def _check_hybrid_layer_writes(g):
    """Phase 11's layer write, bitwise against the plain version, whole
    tensors compared: recurrentgemma-9b's K and V rows (1 x 256) into a
    rolling window of 2,048 slots with slot_pos [4, 2048], for a per-row
    t, a host-int t and t >= 2048 (the wrap onto the oldest slots)."""
    import torch
    from repro_torch.kernels import cache_update, ref
    slots, tail = HYBRID_KV
    cases = [("per-row t", 0, None, False), ("host-int t", 0, None, True),
             ("t in [2048, 8192), the wrap", slots, 4 * slots, False)]
    for what, t_lo, t_hi, host_int in cases:
        k, v, kn, vn, spos, t = _layer_inputs(g, s=slots, tail=tail,
                                              t_lo=t_lo, t_hi=t_hi)
        if host_int:
            t = slots // 3
        got, want = [k.clone(), v.clone(), spos.clone()], [k, v, spos]
        on = [x.clone() for x in got]
        cache_update.kv_slot_update_layer(*_kv_args(got, kn, vn), t,
                                          window=slots)
        tel = cache_update.kv_slot_update_layer(*_kv_args(on, kn, vn), t,
                                                window=slots, telemetry=True)
        want_tel = ref.ref_kv_slot_update_layer(*_kv_args(want, kn, vn), t,
                                                window=slots, telemetry=True)
        torch.cuda.synchronize()
        for name, a, w in zip(("K", "V", "slot_pos"), got, want):
            if not torch.equal(a, w):
                raise AssertionError(f"kv_slot_update_layer hybrid {what}: "
                                     f"{name} != plain version")
        _tel_held(f"kv_slot_update_layer hybrid [4,2048,1,256] {what}",
                  tuple(got), tuple(on) + (tel,), want_tel)
    log("[kernels] kv_slot_update_layer recurrentgemma-9b K, V "
        "[4,2048,1,256] + slot_pos [4,2048], window 2048, at "
        f"{'; '.join(c[0] for c in cases)}: bitwise equal to the plain "
        "version, untouched rows included")


def _kv_args(kvs, kn, vn):
    """(K cache, new K, V cache, new V, slot_pos) of a layer write."""
    return kvs[0], kn, kvs[1], vn, kvs[2]


def _held(what, got, want, tol):
    """max |got - want|; raises unless finite and within ``tol``."""
    import torch
    err = float((got.float() - want.float()).abs().max())
    log(f"{what}: max|err|={err:.3e} tol={tol:.3e}")
    if not (bool(torch.isfinite(got).all()) and err <= tol):
        raise AssertionError(f"{what}: err {err} > tol {tol} or non-finite")
    return err


def _ragged_inputs(m, d, f, r_tile, r_max, seed):
    """bf16 x, w; per-tile sample lists drawn from w's block
    probabilities, weights 1 / (r_tile[t] * p)."""
    import torch
    from repro_torch.core import amm
    x, w, _, _ = _mca_inputs(m, d, f, 1, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    probs = amm.block_probs(w, 128)
    idx, _ = amm.draw_block_samples(g, probs, len(r_tile) * r_max)
    idx = idx.reshape(len(r_tile), r_max).contiguous()
    rt = torch.tensor(r_tile, dtype=torch.int32, device="cuda")
    inv_rp = (1.0 / (rt.clamp(min=1)[:, None] * probs[idx.long()])).float()
    return x, w, rt, idx, inv_rp.contiguous()


def _check_ragged():
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.mca_matmul import mca_matmul_ragged
    err = 0.0
    for m, d, f, r_tile, r_max in RAGGED_CASES:
        x, w, rt, idx, inv_rp = _ragged_inputs(m, d, f, r_tile, r_max,
                                               seed=m + f)
        got = mca_matmul_ragged(x, w, rt, idx, inv_rp, block=128)
        want = ref.ref_mca_matmul_ragged(x, w, rt, idx, inv_rp, 128)
        torch.cuda.synchronize()
        _tel_held(f"mca_matmul_ragged m={m} f={f} r_tile={r_tile}", got,
                  mca_matmul_ragged(x, w, rt, idx, inv_rp, block=128,
                                    telemetry=True),
                  ref.ref_mca_matmul_ragged(x, w, rt, idx, inv_rp, 128,
                                            telemetry=True)[1])
        err = max(err, _held(
            f"[kernels] mca_matmul_ragged m={m} d={d} f={f} r_tile={r_tile}",
            got,
            want, 1e-2 * float(want.float().abs().max())))
        if bool(got[(m // len(r_tile)) * 3:].any()):
            raise AssertionError("mca_matmul_ragged: r_tile 0 rows not 0")
    # exact: every block once per tile, unit weights -> the dense product
    x, w, _, _ = _mca_inputs(512, 3072, 3072, 1, seed=9)
    full = torch.full((4,), 24, dtype=torch.int32, device="cuda")
    idx = torch.arange(24, dtype=torch.int32, device="cuda").repeat(4, 1)
    got = mca_matmul_ragged(x, w, full, idx.contiguous(),
                            torch.ones((4, 24), device="cuda"), block=128)
    want = x.float() @ w.float()
    _held("[kernels] mca_matmul_ragged exact m=512 R=24 vs dense", got, want,
          1e-2 * float(want.abs().max()))
    return err


def _attn_inputs(b, hq, hkv, sq, skv, dh, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype)
            for shape in ((b, hq, sq, dh), (b, hkv, skv, dh),
                          (b, hkv, skv, dh))]


def _check_attention():
    """flash_attention and attn_colmax against the plain versions; returns
    the largest bf16 errors (flash out, colmax)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.attn_colmax import attn_colmax
    from repro_torch.kernels.flash_attention import flash_attention
    errs = {"flash_attention": 0.0, "attn_colmax": 0.0}
    for b, hq, hkv, sq, skv, dh, causal, dtn in ATTN_CASES:
        dt = getattr(torch, dtn)
        q, k, v = _attn_inputs(b, hq, hkv, sq, skv, dh, dt, seed=sq + dh)
        scale = dh ** -0.5
        out, lse = flash_attention(q, k, v, scale=scale, causal=causal)
        cm = attn_colmax(q, k, lse, scale=scale, causal=causal)
        want_out, want_lse = ref.ref_attention(q, k, v, scale=scale,
                                               causal=causal)
        want_cm = ref.ref_colmax(q, k, lse, scale=scale, causal=causal)
        torch.cuda.synchronize()
        shape = (f"[{b},{hq}/{hkv},{sq}x{skv},{dh}] "
                 f"{'causal' if causal else 'full'} {dtn}")
        for blk in (128, 64) if (b, hq, hkv, sq, skv, dh, causal, dtn) == \
                ATTN_TIMED else (128,):
            _check_attention_telemetry(shape, q, k, v, out, lse, cm, scale,
                                       causal, blk)
        rel = 2e-2 if dt == torch.bfloat16 else 2e-4
        # causal rows i < sq - skv see no key: out 0, lse -1e30 (the plain
        # version averages V there, ROADMAP Queue 3)
        seen = max(0, sq - skv) if causal else 0
        if seen:
            if out[:, :, :seen].any() or \
                    not (lse[:, :, :seen] == -1e30).all():
                raise AssertionError(f"flash_attention {shape}: rows that "
                                     "see no key are not out 0, lse -1e30")
            log(f"[kernels] flash_attention {shape}: the {seen} rows that "
                "see no key give out 0, lse -1e30")
        out, want_out = out[:, :, seen:], want_out[:, :, seen:]
        e_out = _held(f"[kernels] flash_attention out {shape}", out, want_out,
                      rel * float(want_out.float().abs().max()))
        _held(f"[kernels] flash_attention lse {shape}", lse[:, :, seen:],
              want_lse[:, :, seen:], 1e-3)
        e_cm = _held(f"[kernels] attn_colmax {shape}", cm, want_cm, 1e-3)
        if dt == torch.bfloat16:
            errs["flash_attention"] = max(errs["flash_attention"], e_out)
            errs["attn_colmax"] = max(errs["attn_colmax"], e_cm)
    # an empty side: skv = 0 (flash: no row sees a key) and sq = 0 (colmax 0)
    q, k, v = _attn_inputs(2, 4, 2, 96, 0, 128, torch.bfloat16, seed=12)
    out, lse = flash_attention(q, k, v, scale=128 ** -0.5, causal=True)
    q0, k0, _ = _attn_inputs(2, 4, 2, 0, 96, 128, torch.bfloat16, seed=13)
    cm = attn_colmax(q0, k0, torch.empty((2, 4, 0), device="cuda"),
                     scale=128 ** -0.5, causal=True)
    torch.cuda.synchronize()
    if out.any() or not (lse == -1e30).all() or cm.shape != (2, 4, 96) \
            or cm.any():
        raise AssertionError("flash_attention with skv 0 is not out 0, lse "
                             "-1e30, or attn_colmax with sq 0 is not 0")
    log("[kernels] bf16 flash_attention [2,4/2,96x0,128]: out 0, lse -1e30; "
        "attn_colmax [2,4/2,0x96,128]: 0")
    tel_f = flash_attention(q, k, v, scale=128 ** -0.5, causal=True,
                            telemetry=True)[2]
    tel_c = attn_colmax(q0, k0, torch.empty((2, 4, 0), device="cuda"),
                        scale=128 ** -0.5, causal=True, telemetry=True)[1]
    if tel_f[0, :2].tolist() != [1, 0] or tel_c[0, :2].tolist() != [1, 0]:
        raise AssertionError("an empty side's telemetry is not 1 launch, "
                             "0 tiles")
    return errs


def _check_attention_telemetry(shape, q, k, v, out, lse, cm, scale, causal,
                               blk):
    """flash and colmax with their telemetry buffers on, at the caller's
    (blk, blk) tiles: bitwise the same outputs, and the reference's tiles
    (the plain version's buffer)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.attn_colmax import attn_colmax
    from repro_torch.kernels.flash_attention import flash_attention
    kw = dict(scale=scale, causal=causal, block_q=blk, block_k=blk)
    want = ref.ref_attention(q, k, v, telemetry=True, **kw)[2]
    _tel_held(f"flash_attention {shape} tiles {blk}", (out, lse),
              flash_attention(q, k, v, telemetry=True, **kw), want)
    _tel_held(f"attn_colmax {shape} tiles {blk}", cm,
              attn_colmax(q, k, lse, telemetry=True, **kw), want)


# ------------------------------------------------------------ phase 3b
#: MCA prefill's scoring passes at starcoder2-3b's prefill shapes, 1 x
#: 24/2 x S x 128 causal: (S, left padding), without padding and with a
#: bucket's most (a prompt of S / 2 + 1 tokens)
PASS_CASES = [(2048, 0), (2048, 1023), (4096, 0), (4096, 2047)]
PASS_TIMED = (4096, 0)


def _pass_work(name, s, pad):
    """(bytes, FLOPs) a scoring pass needs at (S, pad): the causal part of
    QK^T (and of P V) over the valid keys, each input byte read and each
    output byte written once."""
    n = s - pad
    qk = 2 * 24 * n * (n + 1) // 2 * 128
    q_b, kv_b, rows = s * 24 * 128 * 2, s * 2 * 128 * 2, 24 * s * 4
    if name == "attn_lse":
        return q_b + kv_b + s + 2 * rows, qk
    if name == "attn_colmax_pass":
        return q_b + kv_b + 2 * s + rows + 4 * s, qk
    return 2 * q_b + 2 * kv_b + s + rows, 2 * qk


def phase_passes():
    """Phase 3b: the three scoring-pass wrappers on the card
    (``ops.attn_lse``, ``attn_colmax_pass``, ``attn_av``) at
    ``PASS_CASES``, each against its plain version, the chunked pass of
    ``models.attention``, at the card test's tolerances (m and lse 1e-5 of
    max(|value|, 1); colmax 1e-4 relative plus 1e-7; out 1e-2 of max
    |out|; rows that see no key exactly m = lse = -1e30, out 0, and
    padding columns 0), then timed at each: per call (CUDA events), device
    (profiler, every item a call launches), host to issue, the chunked
    pass per call, the bound.  Returns (max errors, numbers at
    ``PASS_TIMED`` with every shape's under ``shapes``)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    errs = {"attn_lse": 0.0, "attn_colmax_pass": 0.0, "attn_av": 0.0}
    nums = {n: {"shapes": []} for n in errs}
    for s, pad in PASS_CASES:
        g = torch.Generator(device="cuda").manual_seed(s + pad)
        q, k, v = (torch.randn(shape, generator=g, device="cuda").bfloat16()
                   for shape in ((1, s, 2, 12, 128), (1, s, 2, 128),
                                 (1, s, 2, 128)))
        kv_valid = torch.arange(s, device="cuda")[None] >= pad
        kw = dict(scale=128 ** -0.5, causal=True, window=0,
                  chunk=attention.pick_chunk(s, 512), q_offset=0,
                  kv_valid=kv_valid)
        ops.reset_launch_counts()
        m, lse = ops.attn_lse(q, k, **kw)
        cm = ops.attn_colmax_pass(q, k, lse, q_valid=kv_valid, **kw)
        out = ops.attn_av(q, k, v, lse, **kw)
        torch.cuda.synchronize()
        launched = {n: c for n, c in ops.launch_counts().items() if c}
        if launched != {"attn_lse": 1, "attn_colmax": 1, "attn_av": 1}:
            raise AssertionError(f"scoring passes S {s} pad {pad}: launches "
                                 f"{launched}, not one kernel each")
        want_m, want_lse = attention.chunked_lse(q, k, **kw)
        want_cm = attention.chunked_colmax(q, k, lse, q_valid=kv_valid, **kw)
        want_out = attention.chunked_av(q, k, v, lse, **kw)
        shape = f"[1,24/2,{s},128] causal, {pad} padding keys"
        for got, want, what in ((m, want_m, "m"), (lse, want_lse, "lse")):
            tol = 1e-5 * want.abs().clamp(min=1)
            if not bool(((got - want).abs() <= tol).all()):
                raise AssertionError(f"attn_lse {what} {shape}: beyond "
                                     "1e-5 of max(|value|, 1)")
        errs["attn_lse"] = max(errs["attn_lse"],
                               float((lse - want_lse).abs().max()))
        if not bool(((cm - want_cm).abs()
                     <= 1e-4 * want_cm.abs() + 1e-7).all()):
            raise AssertionError(f"attn_colmax_pass {shape}: beyond 1e-4 "
                                 "relative")
        errs["attn_colmax_pass"] = max(errs["attn_colmax_pass"],
                                       float((cm - want_cm).abs().max()))
        errs["attn_av"] = max(errs["attn_av"], _held(
            f"[passes] attn_av {shape}", out, want_out,
            1e-2 * float(want_out.float().abs().max())))
        if pad and not (bool((m[..., :pad] == -1e30).all())
                        and bool((lse[..., :pad] == -1e30).all())
                        and not bool(out[:, :pad].any())
                        and not bool(cm[:, :pad].any())):
            raise AssertionError(f"scoring passes {shape}: the rows that see "
                                 "no key, or the padding columns, are not "
                                 "-1e30 and 0")
        log(f"[passes] {shape}: m and lse within 1e-5, colmax within 1e-4 "
            f"relative of the chunked passes; max|err| lse "
            f"{float((lse - want_lse).abs().max()):.3e}, colmax "
            f"{float((cm - want_cm).abs().max()):.3e}")
        calls = {
            "attn_lse": (lambda: ops.attn_lse(q, k, **kw),
                         lambda: attention.chunked_lse(q, k, **kw)),
            "attn_colmax_pass": (
                lambda: ops.attn_colmax_pass(q, k, lse, q_valid=kv_valid,
                                             **kw),
                lambda: attention.chunked_colmax(q, k, lse,
                                                 q_valid=kv_valid, **kw)),
            "attn_av": (lambda: ops.attn_av(q, k, v, lse, **kw),
                        lambda: attention.chunked_av(q, k, v, lse, **kw)),
        }
        for name, (kern, plain) in calls.items():
            ms = cuda_time_ms(kern)
            dev_us, dev_names = _device_all_us(kern)
            host = host_us(kern)
            plain_ms = cuda_time_ms(plain, n=10, warmup=2)
            bound, by = _bound_ms(*_pass_work(name, s, pad))
            row = dict(s=s, pad=pad, ms=ms, device_us=dev_us, host_us=host,
                       plain_ms=plain_ms, bound_ms=bound, bound_by=by)
            nums[name]["shapes"].append(row)
            if (s, pad) == PASS_TIMED:
                nums[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                  bound_by=by, library_ms=None,
                                  device_us=dev_us, host_us=host)
            log(f"[passes] {name} {shape}: kernel {ms * 1e3:.2f} us per "
                f"call (device {_us(dev_us)} over {len(dev_names)} "
                f"kernels, host {host:.2f} us to issue), chunked pass "
                f"{plain_ms * 1e3:.2f} us, bound {bound * 1e3:.2f} us "
                f"({by})")
        del q, k, v, m, lse, cm, out, want_m, want_lse, want_cm, want_out
        torch.cuda.empty_cache()
    return errs, nums


# ------------------------------------------------------------- phase 4
def _card_vs_cpu(arch, tag, n_layers=2, ragged=True):
    """A reduced ``arch`` (f32, ``n_layers`` layers, vocab 128, MCA off,
    TF32 off) served on the card and on the CPU from the same params: the
    same greedy tokens (and the same again in a second card run), and the
    forward's hidden states and logits within 1e-4.  The prompts are
    ragged (one left-padded) unless ``ragged`` is off: the SSM and hybrid
    families serve equal-length prompts only."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduced
    from repro_torch.models.api import _logits
    from repro_torch.serve import Engine
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reduced(get_config(arch), n_layers=n_layers, vocab_size=128)
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(0)
    gpu = build_model(cfg, device="cuda")
    gparams = _to_device(params, "cuda")
    prompts = np.random.default_rng(0).integers(1, 128, (2, 12))
    lens = None
    if ragged:
        lens = np.asarray([12, 7])
        prompts[1, :5] = 0
    toks, hid, logits = [], [], []
    for model, p in ((cpu, params), (gpu, gparams), (gpu, gparams)):
        eng = Engine(model, p, batch_size=2, max_len=32)
        toks.append(eng.generate(prompts, 8, prompt_lens=lens))
        h, _, _ = model.forward_hidden(p, {"tokens": torch.as_tensor(
            prompts[:1], device=model.device)})
        hid.append(h.float().cpu().numpy())
        logits.append(_logits(p, cfg, h)[..., :128].cpu().numpy())
    diff = float(np.abs(hid[0] - hid[1]).max())
    ldiff = float(np.abs(logits[0] - logits[1]).max())
    log(f"{tag} {arch} reduced f32 ({n_layers} layers) tokens "
        f"cpu={toks[0].tolist()} "
        f"gpu={toks[1].tolist()} hidden max|diff|={diff:.3e} logits "
        f"max|diff|={ldiff:.3e}; second card run "
        f"{'identical' if np.array_equal(toks[1], toks[2]) else 'DIFFERS'}")
    if not (np.array_equal(toks[0], toks[1])
            and np.array_equal(toks[1], toks[2])
            and diff <= 1e-4 and ldiff <= 1e-4):
        raise AssertionError(f"reduced {arch} on the card != on the CPU")
    return {"hidden_diff": diff, "logits_diff": ldiff}


def phase_parity():
    """Reduced starcoder2-3b (f32): the card serves what the CPU serves."""
    _card_vs_cpu("starcoder2-3b", "[parity]")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


# ------------------------------------------------------------- phase 5
def _kernel_counts(snap):
    c = snap["counters"]
    return {op: (c.get(f"kernels.{op}.kernel_calls", 0),
                 c.get(f"kernels.{op}.fallback_calls", 0))
            for op in ("mca_matmul", "kv_slot_update")}


def _check_path(name, snap, launches, decode_steps, n_layers):
    counts = _kernel_counts(snap)
    log(f"[serve] {name}: launches {launches}, "
        f"(kernel_calls, fallback_calls) {counts}, "
        f"decode steps {decode_steps}")
    for op, (k, fb) in counts.items():
        if k <= 0 or fb != 0:
            raise AssertionError(f"{name}: {op} kernel_calls={k} "
                                 f"fallback_calls={fb}")
    for kern in SERVE_KERNELS:
        n = launches[kern]
        if n <= 0:
            raise AssertionError(f"{name}: {kern} never launched")
    # one layer write (K, V and slot_pos) per layer per decode step
    want = n_layers * decode_steps
    if launches["kv_slot_update"] != want:
        raise AssertionError(f"{name}: kv_slot_update launched "
                             f"{launches['kv_slot_update']} != {n_layers} x "
                             f"{decode_steps} decode steps = {want}")


def _check_passes(name, snap, launches, n_layers):
    """MCA prefill's three scoring passes ran as kernels on every prefill
    of a GQA model: one kernel call and one launch each per layer per
    prefill, and no chunked pass."""
    c = snap["counters"]
    prefills = snap["histograms"]["serve.prefill_seconds"]["count"]
    want = n_layers * prefills
    passes = {op: (c.get(f"kernels.{op}.kernel_calls", 0), launches[op])
              for op in PASS_KERNELS}
    chunked = c.get("attn.chunked_passes", 0)
    log(f"[serve] {name}: scoring passes (kernel_calls, launches) {passes} "
        f"over {prefills} prefills, attn.chunked_passes {chunked}")
    if chunked or any(v != (want, want) for v in passes.values()):
        raise AssertionError(f"{name}: scoring passes {passes} != "
                             f"{n_layers} x {prefills} prefills = {want} "
                             f"each, or {chunked} chunked passes")


def _check_requests(name, reqs, vocab, max_new):
    for r in reqs:
        if r.status != "ok" or len(r.out) != max_new \
                or max(r.out) >= vocab or min(r.out) < 0:
            raise AssertionError(f"{name}: request {r.uid} status "
                                 f"{r.status} out {r.out}")


def phase_serve():
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.policy import MCAConfig
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import (ContinuousBatcher, Engine, Request,
                                   SlotBatcher)
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, use_kernel=True)
    cfg = get_config("starcoder2-3b", mca=mca)
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    log(f"[serve] starcoder2-3b: {n_params / 1e9:.3f} B params "
        f"({cfg.dtype}) made on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    engine = Engine(model, params, batch_size=4, max_len=512,
                    mca_enabled=True)
    rng = np.random.default_rng(0)
    max_new = 32
    launches = {}
    torch.cuda.reset_peak_memory_stats()

    # --- per-slot batcher: 8 requests, prompts 16..200 tokens
    reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab_size,
                                               int(rng.integers(16, 201))),
                    max_new=max_new) for i in range(8)]
    with obs.scoped() as reg:
        sb = SlotBatcher(engine, check_every=8)
        for r in reqs:
            sb.submit(r)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        sb.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["slot"] = ops.launch_counts()
        snap = reg.snapshot()
    _check_requests("SlotBatcher", reqs, cfg.vocab_size, max_new)
    hists = snap["histograms"]
    steps = hists["serve.decode_step_seconds"]["count"] * 8
    _check_path("SlotBatcher", snap, launches["slot"], steps, cfg.n_layers)
    _check_passes("SlotBatcher", snap, launches["slot"], cfg.n_layers)
    c = snap["counters"]
    occ = sum(v for k, v in c.items() if k.startswith("serve.tier_occupancy"))
    want_occ = cfg.n_layers * 2 * c["serve.prefill_tokens"]
    red = snap["gauges"]["serve.flops_reduction"]
    log(f"[serve] SlotBatcher: tier occupancy "
        f"{[c.get(f'serve.tier_occupancy.t{i}', 0) for i in range(4)]} "
        f"sum {occ} (want {want_occ}), flops_reduction {red:.3f}")
    if occ != want_occ or not red >= 1.0:
        raise AssertionError("SlotBatcher MCA accounting does not add up")
    serve_nums = {
        "prefill_p50_s": hists["serve.prefill_seconds"]["p50"],
        "decode_step_p50_s": hists["serve.decode_step_seconds"]["p50"],
        "tokens_per_s": c["serve.generated_tokens"] / wall,
        "prefill_tokens": c["serve.prefill_tokens"],
        "generated_tokens": c["serve.generated_tokens"],
        "wall_s": wall,
    }

    # --- wave batcher: 4 requests of 32 tokens
    wreqs = [Request(uid=100 + i, prompt=rng.integers(1, cfg.vocab_size, 32),
                     max_new=max_new) for i in range(4)]
    with obs.scoped() as reg:
        cb = ContinuousBatcher(engine)
        for r in wreqs:
            cb.submit(r)
        ops.reset_launch_counts()
        cb.run()
        torch.cuda.synchronize()
        launches["wave"] = ops.launch_counts()
        wsnap = reg.snapshot()
    _check_requests("ContinuousBatcher", wreqs, cfg.vocab_size, max_new)
    _check_path("ContinuousBatcher", wsnap, launches["wave"], max_new - 1,
                cfg.n_layers)
    _check_passes("ContinuousBatcher", wsnap, launches["wave"], cfg.n_layers)
    serve_nums["wave_prefill_s"] = \
        wsnap["histograms"]["serve.prefill_seconds"]["p50"]
    serve_nums["wave_decode_step_p50_s"] = \
        wsnap["histograms"]["serve.decode_step_seconds"]["p50"]
    serve_nums["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log("[serve] " + json.dumps(serve_nums))
    total = {k: launches["slot"][k] + launches["wave"][k]
             for k in launches["slot"]}
    log(f"[serve] launches of the kernels off the serve path: "
        f"{ {k: total[k] for k in ENTRY_ONLY} }")
    per = {"mca_matmul_fixed": "per prefill: 30 layers x 2 sites x 3 "
                               "sampled tiers = 180",
           "kv_slot_update": "per decode step: 30 layers x 1 layer "
                             "write (K, V, slot_pos) = 30"}
    per.update({k: "per prefill: 30 layers x 1 = 30 (phase 5's two "
                   "batchers)" for k in PASS_WRAPPERS})
    return total, per, serve_nums, engine


# ------------------------------------------------------------ phase 5b
def phase_entry(engine, tel=False):
    """This slice's path: ``repro_torch.kernels`` at full width on layer 0
    of the served model.  Returns the launch counts of the run.  With
    ``tel`` (phase 10) devtel is on for the three calls, and their device
    counts must be the reference's: 1 launch each, flash's and colmax's
    128 x 128 score tiles, the ragged matmul's sum(r_tile)."""
    import contextlib
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.kernels import telemetry
    from repro_torch.obs import devtel
    from repro_torch.core import amm, schedule
    from repro_torch.kernels import ref
    from repro_torch.models import attention as attn
    from repro_torch.models.common import apply_norm, apply_rope, \
        embed_tokens
    params, cfg = engine.params, engine.model.cfg
    b, s, block = 4, 512, 128
    hq, hkv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    g = hq // hkv
    tokens = torch.as_tensor(np.random.default_rng(2).integers(
        1, cfg.vocab_size, (b, s)), device="cuda")
    p0 = params["layers"][0]["mixer"]
    h = apply_norm(params["layers"][0]["ln1"], cfg,
                   embed_tokens(params["embed"], tokens))
    pos = torch.arange(s, device="cuda")[None]
    q = apply_rope((h @ p0["wq"]).reshape(b, s, hq, dh), pos,
                   cfg.rope_theta, cfg.rotary_pct)
    k = apply_rope((h @ p0["wk"]).reshape(b, s, hkv, dh), pos,
                   cfg.rope_theta, cfg.rotary_pct)
    v = (h @ p0["wv"]).reshape(b, s, hkv, dh)

    def heads(t):                           # [B, S, H, dh] -> [B, H, S, dh]
        return t.permute(0, 2, 1, 3).contiguous()

    qh, kh, vh = heads(q), heads(k), heads(v)
    scale = dh ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(5)
    probs = amm.block_probs(p0["wv"], block)
    k_blocks = d // block
    torch.cuda.synchronize()

    tag = "[devtel] entry" if tel else "[entry]"
    scope = devtel.enabled_scope if tel else contextlib.nullcontext
    base = devtel.totals()
    kernels.reset_launch_counts()
    with scope():
        out, lse = kernels.flash_attention(qh, kh, vh, scale=scale,
                                           causal=True)
        cm = kernels.attn_colmax(qh, kh, lse, scale=scale, causal=True)
    r_cols = schedule.r_cols_from_attention(cm, s, alpha=cfg.mca.alpha, d=d)
    # value projection of the tokens sorted by their block budget: each
    # 128-row tile takes the largest budget of its rows
    r_blk = schedule.r_blocks_from_cols(r_cols, block).reshape(-1)
    order = torch.argsort(r_blk, descending=True, stable=True)
    xs = h.reshape(b * s, d)[order].contiguous()
    r_tile = r_blk[order].reshape(-1, block).amax(dim=1).clamp(
        max=k_blocks).to(torch.int32).contiguous()
    idx, _ = amm.draw_block_samples(gen, probs, r_tile.numel() * k_blocks)
    idx = idx.reshape(-1, k_blocks).contiguous()
    inv_rp = (1.0 / (r_tile[:, None] * probs[idx.long()])).float().contiguous()
    with scope():
        yv = kernels.mca_matmul_ragged(xs, p0["wv"], r_tile, idx, inv_rp,
                                       block=block)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"{tag} launches {launches}")
    if tel:
        got = devtel.since(base)
        tiles = telemetry.attn_tiles(b, hq, s, s, 128, 128, True)
        want = {"kernels.flash_attention.device_launches": 1.0,
                "kernels.flash_attention.device_tiles": float(tiles),
                "kernels.attn_colmax.device_launches": 1.0,
                "kernels.attn_colmax.device_tiles": float(tiles),
                "kernels.mca_matmul_ragged.device_launches": 1.0,
                "kernels.mca_matmul_ragged.device_sampled_blocks":
                    float(sum(r_tile.tolist()))}
        log(f"{tag} device counts {got}")
        if got != want:
            raise AssertionError(f"entry path device counts {got} != the "
                                 f"reference's {want}")
    for name in ENTRY_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"entry path: {name} never launched")

    chunk = attn.pick_chunk(s, cfg.attn_chunk)
    qg = q.reshape(b, s, hkv, g, dh)
    o_m, _, lse_m = attn.onepass_attention(qg, k, v, scale=scale,
                                           causal=True, window=0, chunk=chunk)
    o_m = o_m.reshape(b, s, hq, dh).permute(0, 2, 1, 3)
    _held("[entry] flash_attention out vs onepass_attention", out, o_m,
          2e-2 * float(o_m.float().abs().max()))
    _held("[entry] flash_attention lse vs onepass_attention", lse,
          lse_m.reshape(b, hq, s), 1e-3)
    cm_m = attn.chunked_colmax(qg, k, lse.reshape(b, hkv, g, s), scale=scale,
                               causal=True, window=0, chunk=chunk)
    _held("[entry] attn_colmax vs chunked_colmax", cm, cm_m, 1e-3)
    if not bool(((r_cols >= 1.0) & (r_cols <= d)).all()):
        raise AssertionError("Eq. 9 budgets outside [1, d]")
    want = ref.ref_mca_matmul_ragged(xs, p0["wv"], r_tile, idx, inv_rp,
                                     block)
    _held("[entry] mca_matmul_ragged v_proj vs plain", yv, want,
          1e-2 * float(want.float().abs().max()))
    rt = r_tile.tolist()
    log(f"[entry] v_proj r_tile {rt}: {sum(rt)} of {len(rt) * k_blocks} "
        f"sampled blocks; colmax range [{float(cm.min()):.3e}, "
        f"{float(cm.max()):.3e}]")
    return {k: launches[k] for k in ENTRY_KERNELS}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------- phases 6-7
def _profile(fn):
    """Run ``fn`` once under ``torch.profiler``: (wall s, key averages)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return wall, prof.key_averages()


def _device_items(avgs):
    """Device-side items of a profile: kernels, copies and sets, without
    the ``record_function`` ranges the profiler mirrors onto the device
    timeline (those keys also name a host range)."""
    host = {e.key for e in avgs if not str(e.device_type).endswith("CUDA")}
    return [e for e in avgs if str(e.device_type).endswith("CUDA")
            and e.key not in host]


def _traced(fns, n: int = 20):
    """Device items of one trace of ``n`` calls of each of ``fns`` in turn.
    A trace that records no device item is taken again, up to three
    times: the profiler now and then drops a window.  [] if all three did
    (the caller then reports the device time as not measured)."""
    def run():
        for fn in fns:
            for _ in range(n):
                fn()
    for _ in range(3):
        _, avgs = _profile(run)
        items = _device_items(avgs)
        if items:
            return items
    log("[numbers] the profiler recorded no device time in three traces")
    return []


def _per_call(items, n: int = 20):
    """Device µs per call over ``items`` (None if there are none): each
    item's mean time per recorded launch times its launches per call.
    The profiler may drop some launches of a window; a mean over the ones
    it kept does not move with that."""
    if not items:
        return None
    return sum(e.self_device_time_total / e.count * max(1, round(e.count / n))
               for e in items)


def _device_us(fn, kernel: str, n: int = 20):
    """Mean device time of the kernel whose name contains ``kernel`` over
    ``n`` calls of ``fn``, from the profiler's trace (None if not seen)."""
    return _per_call([e for e in _traced([fn], n) if kernel in e.key], n)


def _device_all_us(fn, n: int = 20):
    """Mean device time per call of ``fn`` summed over every device kernel
    it launches, and those kernels' names, from the profiler's trace."""
    dev = _traced([fn], n)
    return _per_call(dev, n), sorted({e.key for e in dev})


def _device_pair_us(fn, kernel: str, lib_fn, n: int = 20):
    """One trace of ``fn`` (its kernel's name contains ``kernel``) and then
    ``lib_fn``: the kernel's device µs per call, and that of every device
    item ``lib_fn`` launches."""
    dev = _traced([fn, lib_fn], n)
    return (_per_call([e for e in dev if kernel in e.key], n),
            _per_call([e for e in dev if kernel not in e.key], n))


def _us(x) -> str:
    return "not measured" if x is None else f"{x:.2f} us"


def _profile_summary(tag, name, wall, avgs):
    """Log and return one profiled window: wall, device busy time and
    share, kernel launches, the largest device and host items."""
    dev = _device_items(avgs)
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    top_dev = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    host = [e for e in avgs if not str(e.device_type).endswith("CUDA")]
    top_host = sorted(host, key=lambda e: -e.self_cpu_time_total)[:5]
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy * 1e3,
           "device_busy_share": busy / wall,
           "kernel_launches": sum(e.count for e in dev),
           "top_device": [(e.key[:60], e.self_device_time_total / 1e3,
                           e.count) for e in top_dev],
           "top_host": [(e.key[:60], e.self_cpu_time_total / 1e3, e.count)
                        for e in top_host]}
    log(f"{tag} {name}: wall {wall * 1e3:.1f} ms under the profiler, "
        f"device busy {busy * 1e3:.1f} ms ({100 * busy / wall:.1f}%), "
        f"{out['kernel_launches']} kernel launches")
    for key, ms, count in out["top_device"]:
        log(f"{tag}   device {ms:8.3f} ms  x{count:<5d} {key}")
    for key, ms, count in out["top_host"]:
        log(f"{tag}   host   {ms:8.3f} ms  x{count:<5d} {key}")
    return out


def phase_profile(engine, tag="[profile]"):
    """Where one full-width prefill (256-token bucket) and one decode
    burst (8 steps, 4 live slots) spend their time: device busy share,
    kernel launches, and the largest device and host items.  Returns the
    figures of both."""
    import numpy as np
    rng = np.random.default_rng(1)
    cfg = engine.model.cfg
    state = engine.init_slot_state()
    prompts = [rng.integers(1, cfg.vocab_size, 200) for _ in range(4)]
    for slot, prompt in enumerate(prompts):          # fill, and warm up
        state, _, _ = engine.prefill_into(prompt, state, slot, 32)
    out = {}
    box = [state]

    def prefill():
        box[0], _, _ = engine.prefill_into(prompts[0], box[0], 0, 32)

    def burst():
        box[0], _, _, _ = engine.decode_burst(box[0], 8)

    for name, fn in (("prefill_256", prefill), ("decode_burst_8", burst)):
        wall, avgs = _profile(fn)
        out[name] = _profile_summary(tag, name, wall, avgs)
        dev = _device_items(avgs)
        host = [e for e in avgs if not str(e.device_type).endswith("CUDA")]
        for kern in (MCA_KERNEL, "kv_slot_update_kernel"):
            hits = [e for e in dev if kern in e.key]
            log(f"{tag}   port kernel {kern!r}: "
                f"{sum(e.self_device_time_total for e in hits) / 1e3:.3f} "
                f"ms of device time in {sum(e.count for e in hits)} "
                "launches")
        # the kv_slot_update wrapper's span (host time, launch included)
        # and the host ops the layer's cache writes used to issue
        span = [e for e in host if e.key == "kv_slot_update"]
        out[name]["kv_span_host_ms"] = sum(e.cpu_time_total
                                           for e in span) / 1e3
        out[name]["kv_span_calls"] = sum(e.count for e in span)
        log(f"{tag}   span 'kv_slot_update': "
            f"{out[name]['kv_span_host_ms']:.3f} ms of host time over "
            f"{out[name]['kv_span_calls']} calls")
        for op in ("aten::index_put_", "aten::arange", "aten::remainder"):
            hits = [e for e in host if e.key == op]
            log(f"{tag}   host op {op}: {sum(e.count for e in hits)} "
                f"calls, {sum(e.cpu_time_total for e in hits) / 1e3:.3f} ms")
    log(f"{tag} " + json.dumps(
        {k: {kk: v[kk] for kk in ("wall_ms", "device_busy_ms",
                                  "device_busy_share", "kernel_launches",
                                  "kv_span_host_ms", "kv_span_calls")}
         for k, v in out.items()}))
    return out


def _bound_ms(n_bytes, flops):
    return max(n_bytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3, (
        "bytes" if n_bytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S
        else "operations")


def _visible_pairs(sq, skv, causal):
    """(query, key) pairs a mask lets through: the work this call needs."""
    if not causal:
        return sq * skv
    return sum(min(skv, max(0, i + skv - sq + 1)) for i in range(sq))


def _sdpa(q, k, v, scale, causal):
    """One PyTorch call computing the same attention (the yardstick only;
    its causal mask is top-left aligned, so sq == skv)."""
    import torch.nn.functional as F
    try:
        F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                       scale=scale, enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale, enable_gqa=True)
    except TypeError:                  # older PyTorch: KV repeated first
        g = q.shape[1] // k.shape[1]
        kr, vr = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        return lambda: F.scaled_dot_product_attention(
            q, kr, vr, is_causal=causal, scale=scale)


def _numbers_attention(out):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.attn_colmax import attn_colmax
    from repro_torch.kernels.flash_attention import flash_attention
    b, hq, hkv, sq, skv, dh, causal, dtn = ATTN_TIMED
    q, k, v = _attn_inputs(b, hq, hkv, sq, skv, dh, getattr(torch, dtn),
                           seed=200)
    scale = dh ** -0.5
    pairs = _visible_pairs(sq, skv, causal)
    qo, kv_ = b * hq * sq * dh * 2, b * hkv * skv * dh * 2
    shape = f"[{b},{hq}/{hkv},{sq}x{skv},{dh}] {dtn}"
    bound, by = _bound_ms(2 * qo + 2 * kv_ + 4 * b * hq * sq,
                          4 * b * hq * pairs * dh)
    ms = cuda_time_ms(lambda: flash_attention(q, k, v, scale=scale,
                                              causal=causal))
    plain = cuda_time_ms(lambda: ref.ref_attention(q, k, v, scale=scale,
                                                   causal=causal))
    sdpa = _sdpa(q, k, v, scale, causal)
    lib = cuda_time_ms(sdpa)
    lib_dev_us, lib_names = _device_all_us(sdpa)
    dev_us = _device_us(lambda: flash_attention(q, k, v, scale=scale,
                                                causal=causal),
                        FLASH_KERNEL)
    host = host_us(lambda: flash_attention(q, k, v, scale=scale,
                                           causal=causal))
    log(f"[numbers] flash_attention {shape} causal: kernel {ms * 1e3:.2f} "
        f"us per call (device {_us(dev_us)}, host {host:.2f} us to "
        f"issue), plain {plain * 1e3:.2f} us, "
        f"scaled_dot_product_attention {lib * 1e3:.2f} us per call (device "
        f"{_us(lib_dev_us)}), bound {bound * 1e3:.2f} us ({by})")
    log(f"[numbers] scaled_dot_product_attention device kernels: {lib_names}")
    out["flash_attention"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                  bound_by=by, library_ms=lib,
                                  library_device_us=lib_dev_us)
    _, lse = flash_attention(q, k, v, scale=scale, causal=causal)
    bound, by = _bound_ms(qo + kv_ + 4 * b * hq * sq + 4 * b * hq * skv,
                          2 * b * hq * pairs * dh)
    ms = cuda_time_ms(lambda: attn_colmax(q, k, lse, scale=scale,
                                          causal=causal))
    plain = cuda_time_ms(lambda: ref.ref_colmax(q, k, lse, scale=scale,
                                                causal=causal))
    dev_us = _device_us(lambda: attn_colmax(q, k, lse, scale=scale,
                                            causal=causal),
                        "colmax_bf16_kernel")
    host = host_us(lambda: attn_colmax(q, k, lse, scale=scale,
                                       causal=causal))
    log(f"[numbers] attn_colmax {shape} causal: kernel {ms * 1e3:.2f} us "
        f"per call (device {_us(dev_us)}, host {host:.2f} us to issue), "
        f"plain {plain * 1e3:.2f} us, "
        f"no single PyTorch call, bound {bound * 1e3:.2f} us ({by})")
    out["attn_colmax"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                              bound_by=by, library_ms=None)


def _numbers_ragged(out):
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.mca_matmul import mca_matmul_ragged
    for case in RAGGED_CASES:
        m, d, f, r_tile, r_max = case
        x, w, rt, idx, inv_rp = _ragged_inputs(m, d, f, r_tile, r_max,
                                               seed=300 + f)
        b, n_t = 128, len(r_tile)
        bm, nb = m // n_t, d // b
        live = [set(row[:r]) for row, r in zip(idx.tolist(), r_tile)]
        used = set().union(*live)
        n_bytes = (2 * (sum(bm * len(u) * b for u in live) + len(used) * b * f
                        + m * f) + 4 * n_t + 8 * sum(r_tile))
        bound, by = _bound_ms(n_bytes,
                              sum(2 * bm * len(u) * b * f for u in live))

        def call():
            return mca_matmul_ragged(x, w, rt, idx, inv_rp, block=b)

        ms = cuda_time_ms(call)
        plain = cuda_time_ms(lambda: ref.ref_mca_matmul_ragged(
            x, w, rt, idx, inv_rp, b))
        # yardstick: one bmm on per-tile blocks gathered in advance, weights
        # zeroed past r_tile
        il = idx.long()
        wgt = torch.where(torch.arange(r_max, device="cuda")[None]
                          < rt[:, None], inv_rp, 0.0)
        tiles = torch.arange(n_t, device="cuda")[:, None]
        xg = x.reshape(n_t, bm, nb, b)[tiles, :, il].permute(
            0, 2, 1, 3).reshape(n_t, bm, r_max * b).contiguous()
        wg = (w.reshape(nb, b, f)[il] * wgt[..., None, None].to(w.dtype)
              ).reshape(n_t, r_max * b, f).contiguous()
        lib = cuda_time_ms(lambda: torch.bmm(xg, wg))
        dev_us, lib_dev = _device_pair_us(call, MCA_KERNEL,
                                          lambda: torch.bmm(xg, wg))
        host = host_us(call)
        log(f"[numbers] mca_matmul_ragged m={m} d={d} f={f} bm={bm} "
            f"r_tile={r_tile} (unique blocks per tile "
            f"{[len(u) for u in live]}): kernel {ms * 1e3:.2f} us per call "
            f"(device {_us(dev_us)}, host {host:.2f} us to issue), plain "
            f"{plain * 1e3:.2f} us, torch.bmm on gathered {lib * 1e3:.2f} us "
            f"(device {_us(lib_dev)}), bound {bound * 1e3:.2f} us ({by})")
        if case == RAGGED_CASES[0]:
            out["mca_matmul_ragged"] = dict(
                ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib, library_device_us=lib_dev)


def _numbers_fixed(case, plain_too):
    """One mca_matmul_fixed shape: per-call, device and host time, bound,
    and torch.matmul on the pre-gathered blocks (per call and device)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.mca_matmul import mca_matmul_fixed
    m, d, f, r = case
    b = 128
    x, w, idx, inv_rp = _mca_inputs(m, d, f, r, seed=100 + m + f + r)
    uniq = int(torch.unique(idx).numel())
    n_bytes = 2 * (m * uniq * b + uniq * b * f + m * f) + 8 * r
    bound, by = _bound_ms(n_bytes, 2 * m * uniq * b * f)

    def call():
        return mca_matmul_fixed(x, w, idx, inv_rp, block=b)

    ms = cuda_time_ms(call)
    plain = cuda_time_ms(lambda: ref.ref_mca_matmul_fixed(
        x, w, idx, inv_rp, b)) if plain_too else None
    il = idx.long()
    xg = x.reshape(m, d // b, b)[:, il].reshape(m, r * b).contiguous()
    wg = (w.reshape(d // b, b, f)[il] * inv_rp[:, None, None].to(w.dtype)
          ).reshape(r * b, f).contiguous()
    lib = cuda_time_ms(lambda: torch.matmul(xg, wg))
    dev_us, lib_dev = _device_pair_us(call, MCA_KERNEL,
                                      lambda: torch.matmul(xg, wg))
    host = host_us(call)
    plain_s = f"plain {plain * 1e3:.2f} us, " if plain_too else ""
    log(f"[numbers] mca_matmul_fixed m={m} d={d} f={f} R={r} "
        f"(unique blocks {uniq}): kernel {ms * 1e3:.2f} us per call "
        f"(device {_us(dev_us)}, host {host:.2f} us to issue), {plain_s}"
        f"torch.matmul on gathered {lib * 1e3:.2f} us (device "
        f"{_us(lib_dev)}), bound {bound * 1e3:.2f} us ({by})")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib, library_device_us=lib_dev)


def _numbers_fixed_cold(case):
    """mca_matmul_fixed with its weights cold: each call takes the next of
    COLD_COPIES copies of w, whose sampled blocks together exceed the 50 MB
    L2, as the serve path meets each layer's weight once per prefill."""
    from repro_torch.kernels.mca_matmul import mca_matmul_fixed
    m, d, f, r = case
    x, w, idx, inv_rp = _mca_inputs(m, d, f, r, seed=100 + m + f + r)
    ws = [w.clone() for _ in range(COLD_COPIES)]
    turn = [0]

    def call():
        turn[0] = (turn[0] + 1) % COLD_COPIES
        return mca_matmul_fixed(x, ws[turn[0]], idx, inv_rp, block=128)

    ms = cuda_time_ms(call)
    dev_us = _device_us(call, MCA_KERNEL, n=2 * COLD_COPIES)
    sampled_mb = COLD_COPIES * r * 128 * f * 2 / 1e6
    log(f"[numbers] mca_matmul_fixed m={m} d={d} f={f} R={r} cold weights "
        f"({COLD_COPIES} copies of w in turn, {sampled_mb:.1f} MB of "
        f"sampled blocks): kernel {ms * 1e3:.2f} us per call (device "
        f"{_us(dev_us)})")


def _numbers_kv_entry():
    """The reference's entry point (one cache) at ``KV_SHAPE``: kernel,
    plain version and ``index_put_``."""
    import torch
    from repro_torch.kernels import cache_update, ref
    g = torch.Generator(device="cuda").manual_seed(3)
    bsz, s, f = KV_SHAPE
    cache = torch.randn(KV_SHAPE, generator=g, device="cuda").bfloat16()
    new = torch.randn((bsz, 1, f), generator=g, device="cuda").bfloat16()
    pos = torch.randint(0, s, (bsz,), generator=g, device="cuda",
                        dtype=torch.int32)
    rows_idx = torch.arange(bsz, device="cuda")
    pos_l = pos.long()
    bound, by = _bound_ms(2 * bsz * f * 2 + 4 * bsz, 0)

    def call():
        return cache_update.kv_slot_update(cache, new, pos)

    def lib_call():
        return cache.index_put_((rows_idx, pos_l), new[:, 0])

    ms = cuda_time_ms(call)
    plain = cuda_time_ms(lambda: ref.ref_kv_slot_update(cache, new, pos))
    lib = cuda_time_ms(lib_call)
    dev_us, lib_dev = _device_pair_us(call, "kv_slot_update_kernel",
                                      lib_call)
    host = host_us(call)
    log(f"[numbers] kv_slot_update {list(KV_SHAPE)} bf16 (reference entry "
        f"point): kernel {ms * 1e3:.2f} us per call (device {_us(dev_us)}, "
        f"host {host:.2f} us to issue), plain {plain * 1e3:.2f} us, "
        f"index_put_ {lib * 1e3:.2f} us (device {_us(lib_dev)}), bound "
        f"{bound * 1e3:.4f} us ({by})")
    return host


def _host_breakdown(entry_host):
    """Where the host time of one kv_slot_update call goes: each piece of
    the issue path timed alone (host_us, 100 calls), the former launcher's
    pieces (``current_stream`` object, ``record_function`` without a
    profiler, a registry counter fetched with ``setdefault``, the
    f-string name, tuple shape compares, ``new[0]``) beside this one's."""
    import threading
    import torch
    from repro_torch import obs
    from repro_torch.kernels import cache_update
    from repro_torch.kernels.ops import kv_slot_update_layer as ops_layer
    from repro_torch.obs.registry import Counter
    g = torch.Generator(device="cuda").manual_seed(4)
    k, v, kn, vn, spos, t = _layer_inputs(g)
    cache, new = k.reshape(KV_SHAPE), kn.reshape(KV_SHAPE[0], 1, -1)
    lock = threading.Lock()
    lib = cache_update._lib()
    b, s = KV_SHAPE[:2]
    row = kn[0].numel() * kn.element_size()
    args = (k.data_ptr(), kn.data_ptr(), row, v.data_ptr(), vn.data_ptr(),
            row, spos.data_ptr(), t.data_ptr(), 1, 0, b, s, 0, None,
            torch._C._cuda_getCurrentRawStream(0))
    empty = _layer_inputs(g, b=0)
    op, which = "kv_slot_update", "kernel_calls"

    def former_counter():
        with lock:
            obs.get_registry()._counters.setdefault(
                f"kernels.{op}.{which}", Counter()).inc()

    def former_checks():
        return (cache.is_cuda and new.device == cache.device,
                new.shape != (b, 1) + tuple(cache.shape[2:]),
                new[0].numel() * new.element_size())

    def with_record_function():
        with torch.profiler.record_function("kv_slot_update"):
            pass

    def with_obs_trace():
        with obs.trace("kv_slot_update"):
            pass

    pieces = [
        ("former: torch.cuda.current_stream(dev).cuda_stream",
         lambda: torch.cuda.current_stream(cache.device).cuda_stream),
        ("former: record_function enter/exit, no profiler",
         with_record_function),
        ("former: registry counter (f-string, lock, setdefault)",
         former_counter),
        ("former: device/shape checks and new[0].numel()", former_checks),
        ("now: torch._C._cuda_getCurrentRawStream(0)",
         lambda: torch._C._cuda_getCurrentRawStream(0)),
        ("now: obs.trace enter/exit, no profiler", with_obs_trace),
        ("now: registry counter .inc(2)",
         lambda: obs.get_registry().counter(
             "kernels.kv_slot_update.kernel_calls").inc(2)),
        ("now: layer write checks (B = 0: no launch)",
         lambda: cache_update.kv_slot_update_layer(
             empty[0], empty[2], empty[1], empty[3], empty[4], empty[5],
             window=0)),
        ("now: the ctypes call alone (launch + cudaGetLastError)",
         lambda: lib.kv_slot_update_layer(*args)),
        ("now: the ctypes call with B = 0 (argument conversion only)",
         lambda: lib.kv_slot_update_layer(*args[:10], 0, *args[11:])),
        ("one tensor method: x.is_contiguous()", k.is_contiguous),
        ("one tensor method: x.get_device()", k.get_device),
        ("one tensor method: x.data_ptr()", k.data_ptr),
        ("one tensor method: x.stride(0)", lambda: t.stride(0)),
        ("one tensor method: x.shape != tuple",
         lambda: kn.shape != (b, 1, 2, 128)),
        ("one tensor method: x.dtype != torch.int32",
         lambda: t.dtype != torch.int32),
        ("nothing: an empty Python call", lambda: None),
    ]
    with obs.scoped():
        res = {what: host_us(fn) for what, fn in pieces}
    for what, us in res.items():
        log(f"[numbers] host breakdown: {what}: {us:.2f} us")
    # the wrapper's span under the profiler, beside the launch it holds
    _, avgs = _profile(lambda: [ops_layer(k, kn, v, vn, spos, t, window=0)
                                for _ in range(20)])
    for e in avgs:
        if e.key in ("kv_slot_update", "cudaLaunchKernel") and \
                not str(e.device_type).endswith("CUDA"):
            log(f"[numbers] host breakdown, 20 wrapper calls profiled: "
                f"{e.key} x{e.count}: {e.cpu_time_total / e.count:.2f} us "
                "each")
    log(f"[numbers] host breakdown: whole reference-entry launcher "
        f"{entry_host:.2f} us")
    return res


def _numbers_kv(out):
    """The layer write at the serve shape (B = 4, K and V rows of 2 x 128
    bf16, slot_pos [4, 512], per-row t): kernel per call, device and host
    time, its bound, the plain version, three ``index_put_`` (K, V,
    slot_pos) as the library yardstick, the wrapper's host time beside the
    two-call design's host calls for the same writes, and the kernel's floor
    (B = 1, one 16-byte row, through the reference's entry point)."""
    import torch
    from repro_torch import obs
    from repro_torch.kernels import cache_update, ops, ref
    entry_host = _numbers_kv_entry()
    _host_breakdown(entry_host)
    g = torch.Generator(device="cuda").manual_seed(6)
    k, v, kn, vn, spos, t = _layer_inputs(g)
    b, s = KV_STACK[1], KV_STACK[2]
    row = kn[0].numel() * kn.element_size()
    # each input read once (new K and V rows, t), each output written once
    # (the K and V rows, one slot_pos entry per row)
    bound, by = _bound_ms(4 * b * row + 4 * b + 4 * b, 0)

    def call():
        cache_update.kv_slot_update_layer(k, kn, v, vn, spos, t, window=0)

    rows_idx = torch.arange(b, device="cuda")
    t_l = t.long()

    def lib_call():
        k.index_put_((rows_idx, t_l), kn[:, 0])
        v.index_put_((rows_idx, t_l), vn[:, 0])
        spos.index_put_((rows_idx, t_l), t)

    def wrapper_call():
        ops.kv_slot_update_layer(k, kn, v, vn, spos, t, window=0)

    def two_call_writes():
        # the former gqa_decode writes of one layer, through the
        # reference-entry wrapper: two kernel calls, arange, cast, index_put_
        slot = t.contiguous()
        ops.kv_slot_update(k, kn.contiguous(), slot)
        ops.kv_slot_update(v, vn.contiguous(), slot)
        spos[torch.arange(b, device="cuda"), slot.long()] = t

    ms = cuda_time_ms(call)
    plain = cuda_time_ms(lambda: ref.ref_kv_slot_update_layer(
        k, kn, v, vn, spos, t, window=0))
    lib = cuda_time_ms(lib_call)
    dev_us, lib_dev = _device_pair_us(call, "kv_slot_update_kernel",
                                      lib_call)
    host = host_us(call)
    with obs.scoped():
        wrap_host = host_us(wrapper_call)
        two_call_host = host_us(two_call_writes)
        two_call_ms = cuda_time_ms(two_call_writes)
        two_call_dev, two_call_names = _device_all_us(two_call_writes)
    log(f"[numbers] kv_slot_update_layer K, V [4,512,2,128] bf16 + slot_pos "
        f"[4,512] (serve shape): kernel {ms * 1e3:.2f} us per call (device "
        f"{_us(dev_us)}, host {host:.2f} us to issue; through ops "
        f"{wrap_host:.2f} us), plain {plain * 1e3:.2f} us, 3 x index_put_ "
        f"{lib * 1e3:.2f} us per call (device {_us(lib_dev)}), bound "
        f"{bound * 1e3:.4f} us ({by})")
    log(f"[numbers] the two-call writes of one layer (2 x "
        f"ops.kv_slot_update + arange + cast + index_put_): "
        f"{two_call_ms * 1e3:.2f} us per call, host {two_call_host:.2f} us "
        f"to issue, device {_us(two_call_dev)} over "
        f"{[n[:60] for n in two_call_names]}")
    c1, _, n1, _, _, p1 = _layer_inputs(g, b=1, s=8, tail=(8,))

    def floor_call():
        cache_update.kv_slot_update(c1, n1, p1)

    floor_ms = cuda_time_ms(floor_call)
    floor_dev = _device_us(floor_call, "kv_slot_update_kernel")
    log(f"[numbers] kv_slot_update floor (B = 1, one 16-byte bf16 row): "
        f"{floor_ms * 1e3:.2f} us per call (device {_us(floor_dev)}), bound "
        f"{_bound_ms(16 + 16 + 4, 0)[0] * 1e3:.5f} us")
    out["kv_slot_update"] = dict(ms=ms, plain_ms=plain, bound_ms=bound,
                                 bound_by=by, library_ms=lib,
                                 library_device_us=lib_dev)


def _numbers_mla_write():
    """The MLA layer write at minicpm3-4b's decode shape (B = 4, ckv rows
    of 256 and kr rows of 32 bf16, 512 slots, no slot_pos, per-row t):
    kernel per call, device and host time, its bound, the plain version
    and two ``index_put_`` (ckv, kr) as the library yardstick."""
    import torch
    from repro_torch.kernels import cache_update, ref
    g = torch.Generator(device="cuda").manual_seed(8)
    ckv, kr, c1, k1, _, t = _layer_inputs(g, tail=MLA_TAILS[0],
                                          v_tail=MLA_TAILS[1])
    b = ckv.shape[0]
    row = (c1[0].numel() + k1[0].numel()) * c1.element_size()
    bound, by = _bound_ms(2 * b * row + 4 * b, 0)

    def call():
        cache_update.kv_slot_update_layer(ckv, c1, kr, k1, None, t, window=0)

    rows_idx = torch.arange(b, device="cuda")
    t_l = t.long()

    def lib_call():
        ckv.index_put_((rows_idx, t_l), c1[:, 0])
        kr.index_put_((rows_idx, t_l), k1[:, 0])

    ms = cuda_time_ms(call)
    plain = cuda_time_ms(lambda: ref.ref_kv_slot_update_layer(
        ckv, c1, kr, k1, None, t, window=0))
    lib = cuda_time_ms(lib_call)
    dev_us, lib_dev = _device_pair_us(call, "kv_slot_update_kernel",
                                      lib_call)
    host = host_us(call)
    log(f"[numbers] kv_slot_update_layer MLA ckv [4,512,256] + kr "
        f"[4,512,32] bf16, no slot_pos (minicpm3-4b decode): kernel "
        f"{ms * 1e3:.2f} us per call (device {_us(dev_us)}, host "
        f"{host:.2f} us to issue), plain {plain * 1e3:.2f} us, 2 x "
        f"index_put_ {lib * 1e3:.2f} us per call (device {_us(lib_dev)}), "
        f"bound {bound * 1e3:.4f} us ({by})")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib, device_us=dev_us, host_us=host,
                library_device_us=lib_dev)


def _numbers_gqa_write(what, slots, tail, window, seed):
    """The layer write at a model's decode shape (B = 4, K and V rows of
    ``tail`` bf16 into ``slots`` slots with slot_pos [4, slots], per-row
    t; with a window, t past it so the slot wraps): kernel per call,
    device and host time, its bound, the plain version and three
    ``index_put_`` (K, V, slot_pos at t % slots) as the library
    yardstick."""
    import torch
    from repro_torch.kernels import cache_update, ref
    g = torch.Generator(device="cuda").manual_seed(seed)
    k, v, kn, vn, spos, t = _layer_inputs(
        g, s=slots, tail=tail, t_lo=slots if window else 0,
        t_hi=4 * slots if window else None)
    b = k.shape[0]
    row = kn[0].numel() * kn.element_size()
    bound, by = _bound_ms(4 * b * row + 4 * b + 4 * b, 0)

    def call():
        cache_update.kv_slot_update_layer(k, kn, v, vn, spos, t,
                                          window=window)

    rows_idx = torch.arange(b, device="cuda")
    slot = (t % slots).long()

    def lib_call():
        k.index_put_((rows_idx, slot), kn[:, 0])
        v.index_put_((rows_idx, slot), vn[:, 0])
        spos.index_put_((rows_idx, slot), t)

    ms = cuda_time_ms(call)
    plain = cuda_time_ms(lambda: ref.ref_kv_slot_update_layer(
        k, kn, v, vn, spos, t, window=window))
    lib = cuda_time_ms(lib_call)
    dev_us, lib_dev = _device_pair_us(call, "kv_slot_update_kernel",
                                      lib_call)
    host = host_us(call)
    log(f"[numbers] kv_slot_update_layer {what} K, V "
        f"[{b},{slots},{tail[0]},{tail[1]}] bf16 + slot_pos [{b},{slots}]"
        f"{f', window {window}, t wrapped' if window else ''}: "
        f"kernel {ms * 1e3:.2f} us per call (device {_us(dev_us)}, host "
        f"{host:.2f} us to issue), plain {plain * 1e3:.2f} us, 3 x "
        f"index_put_ {lib * 1e3:.2f} us per call (device {_us(lib_dev)}), "
        f"bound {bound * 1e3:.4f} us ({by})")
    return dict(ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib, device_us=dev_us, host_us=host,
                library_device_us=lib_dev)


def phase_numbers():
    out = {"families": {}}
    for case in FAMILY_MCA_TIMED + HYBRID_MCA_TIMED:
        out["families"][f"mca_matmul_fixed {case}"] = _numbers_fixed(
            case, plain_too=True)
    out["families"]["kv_slot_update_layer MLA"] = _numbers_mla_write()
    out["families"]["kv_slot_update_layer hybrid"] = _numbers_gqa_write(
        "recurrentgemma-9b", *HYBRID_KV, window=HYBRID_KV[0], seed=12)
    for case in ENCDEC_VLM_MCA_TIMED:
        out["families"][f"mca_matmul_fixed {case}"] = _numbers_fixed(
            case, plain_too=True)
    for i, (arch, slots, tail) in enumerate(ENCDEC_VLM_KV):
        out["families"][f"kv_slot_update_layer {arch}"] = _numbers_gqa_write(
            arch, slots, tail, window=0, seed=20 + i)
    for case in TP_MCA_TIMED:
        out["families"][f"mca_matmul_fixed {case}"] = _numbers_fixed(
            case, plain_too=True)
    out["families"]["kv_slot_update_layer TP"] = _numbers_gqa_write(
        "starcoder2-3b TP 2 (one KV head)", *TP_KV, window=0, seed=30)
    for case in TP16_MCA_TIMED:
        out["families"][f"mca_matmul_fixed {case}"] = _numbers_fixed(
            case, plain_too=True)
    for i, (what, slots, tail) in enumerate(TP16_KV):
        out["families"][f"kv_slot_update_layer {what}"] = _numbers_gqa_write(
            what, slots, tail, window=0, seed=40 + i)
    for case in MESH2D_MCA_CASES:
        out["families"][f"mca_matmul_fixed {case}"] = _numbers_fixed(
            case, plain_too=True)
    shapes = list(MCA_CASES)
    for m, r in SERVE_MR:
        for f in (256, 3072):
            if (m, 3072, f, r) not in shapes:
                shapes.append((m, 3072, f, r))
    for case in shapes:
        nums = _numbers_fixed(case, plain_too=case in MCA_CASES)
        if case == MCA_TIMED:
            out["mca_matmul_fixed"] = nums
    _numbers_fixed_cold(MCA_TIMED)
    _numbers_kv(out)
    _numbers_ragged(out)
    _numbers_attention(out)
    return out


# ------------------------------------------------------------- phase 8
TRAIN_ARGS = ["--arch", "starcoder2-3b", "--steps", "4", "--mca",
              "--alpha", "0.2"]      # the launcher's batch 8, seq 256
RESUME_DIR = ROOT / "build" / "train_resume"


def _reduced_train(n_layers=2, **kw):
    from repro_torch.configs import get_config
    from repro_torch.models import reduced
    return reduced(get_config("starcoder2-3b"), n_layers=n_layers, **kw)


def _train_full_width():
    """(a) starcoder2-3b at full width through ``launch.train``'s own
    objects: 4 steps, MCA on v_proj, finite checks on (so no donation)."""
    import gc
    import torch
    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.optim.adamw import named_leaves
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    args = train.parse_args(TRAIN_ARGS)
    with obs.scoped() as reg:
        trainer = train.build(args)
        cfg = trainer.model.cfg
        n_params = sum(p.numel() for _, p in named_leaves(trainer.params))
        torch.cuda.synchronize()
        log(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {n_params / 1e9:.3f} B params ({cfg.dtype}), "
            f"batch {args.batch} x seq {args.seq}, MCA {cfg.mca.sites} "
            f"alpha {cfg.mca.alpha} block {cfg.mca.block} use_kernel "
            f"{cfg.mca.use_kernel}; set up in {time.perf_counter() - t0:.1f}s")
        inner, gnorms, changed = trainer.train_step, [], []

        def step(params, opt_state, batch):
            out = inner(params, opt_state, batch)
            gnorms.append(out[2]["grad_norm"])
            if not changed:         # step 1: the step is out of place
                pairs = list(zip(named_leaves(params), named_leaves(out[0])))
                changed.extend(name for (name, a), (_, b) in pairs
                               if not torch.equal(a, b))
                if len(changed) != len(pairs):
                    raise AssertionError(
                        f"step 1 left {len(pairs) - len(changed)} of "
                        f"{len(pairs)} parameter leaves unchanged")
            return out

        trainer.train_step = step
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        out = trainer.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t1
        launches = ops.launch_counts()
        snap = reg.snapshot()
    wall = time.perf_counter() - t0
    prof = _profile_train_step(trainer, inner)
    hist = out["history"]
    losses = [h["loss"] for h in hist]
    norms = [float(g) for g in gnorms]
    c = snap["counters"]
    occ = [c.get(f"train.tier_occupancy.t{i}", 0) for i in range(4)]
    red = snap["gauges"]["train.flops_reduction"]
    step_s = snap["histograms"]["train.step_seconds"]
    nums = {"steps": out["steps"], "losses": losses, "grad_norms": norms,
            "flops_reduction": red, "tier_occupancy": occ,
            "step_p50_s": step_s["p50"], "step_s": [h["dt"] for h in hist],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "run_s": run_s, "wall_s": wall, "params": n_params,
            "profiled_step": prof}
    log("[train] full width: " + json.dumps(nums))
    log(f"[train] every one of the {len(changed)} parameter leaves changed "
        f"in step 1; statuses {[h['status'] for h in hist]}")
    log(f"[train] kernel launches {launches}: all 0 - the launcher leaves "
        "MCAConfig.use_kernel off (as the reference's does) and no kernel "
        "has a backward, so training runs the plain PyTorch passes")
    want_occ = cfg.n_layers * args.batch * args.seq * out["steps"]
    if (out["steps"] != 4 or any(h["status"] != "ok" for h in hist)
            or not all(map(math.isfinite, losses + norms))
            or min(norms) <= 0 or not red > 1.0 or sum(occ) != want_occ
            or any(launches.values())):
        raise AssertionError(f"full-width training failed its checks "
                             f"(tier occupancy {sum(occ)} != {want_occ}?)")
    del trainer, inner, step
    return nums


def _profile_train_step(trainer, step):
    """One more full-width step (the fifth batch) under the profiler:
    wall, device busy time and share, launches, largest device items."""
    import torch
    batch = {k: torch.as_tensor(v, device=trainer.model.device)
             for k, v in trainer.data.batch(4).items()}
    wall, avgs = _profile(lambda: step(trainer.params, trainer.opt_state,
                                       batch))
    dev = _device_items(avgs)
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:6]
    out = {"wall_s": wall, "device_busy_s": busy,
           "device_busy_share": busy / wall,
           "kernel_launches": sum(e.count for e in dev),
           "top_device": [(e.key[:60], e.self_device_time_total / 1e3,
                           e.count) for e in top]}
    log(f"[train] one step under the profiler: wall {wall:.3f} s, device "
        f"busy {busy:.3f} s ({100 * busy / wall:.1f}%), "
        f"{out['kernel_launches']} kernel launches")
    for key, ms, count in out["top_device"]:
        log(f"[train]   device {ms:9.3f} ms  x{count:<6d} {key}")
    return out


def _train_steps(model, params, data, n, lr=3e-4):
    """``n`` make_train_step steps (MCA off) from ``params``; returns
    (losses, final params)."""
    import torch
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    opt = adamw.AdamWConfig(lr=lr, schedule=adamw.cosine_schedule(1, n))
    step = make_train_step(model, opt, with_mca=False)
    state = adamw.init_state(params)
    losses = []
    for i in range(n):
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in data.batch(i).items()}
        params, state, m = step(params, state, batch)
        losses.append(float(m["total_loss"]))
    return losses, params


def _train_parity():
    """(b) a reduced f32 starcoder2-3b trains on the card as on the CPU."""
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import named_leaves
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = _reduced_train()
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(0)
    data = SyntheticLM(cfg.vocab_size, 64, 4, seed=0)
    lc, pc = _train_steps(cpu, params, data, 3)
    lg, pg = _train_steps(build_model(cfg, device="cuda"),
                          _to_device(params, "cuda"), data, 3)
    loss_rel = max(abs(a - b) / abs(a) for a, b in zip(lc, lg))
    worst, worst_name = 0.0, ""
    for (name, a), (_, b) in zip(named_leaves(pc), named_leaves(pg)):
        rel = float((a - b.cpu()).abs().max() / a.abs().max())
        if rel > worst:
            worst, worst_name = rel, name
    log(f"[train] parity (reduced f32, 2 layers, MCA off, 3 steps): losses "
        f"cpu {lc} card {lg}, max rel diff {loss_rel:.2e} (limit 1e-5); "
        f"params max|diff|/max|p| {worst:.2e} at {worst_name} (limit 1e-4)")
    if not loss_rel <= 1e-5 or not worst <= 1e-4:
        raise AssertionError("training on the card != on the CPU")
    return {"loss_rel": loss_rel, "param_rel": worst}


def _resume_run(ckpt_dir, total, fault=None):
    from repro_torch import resilience
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig, make_train_step
    cfg = _reduced_train()
    model = build_model(cfg, device="cuda")
    opt = adamw.AdamWConfig(lr=1e-3)
    tcfg = TrainerConfig(total_steps=total, ckpt_dir=str(ckpt_dir),
                         ckpt_every=2, log_every=100, watchdog_s=600)
    tr = Trainer(model, opt, SyntheticLM(cfg.vocab_size, 64, 4, seed=0),
                 make_train_step(model, opt), tcfg)
    if fault is None:
        return tr, tr.run()
    with resilience.chaos(fault):
        try:
            tr.run()
        except resilience.FaultInjected:
            return tr, None
    raise AssertionError("the injected fault did not stop the run")


def _train_resume():
    """(c) kill inside step 5 of 8 and resume; then a corrupt newest
    checkpoint is walked past.  Reduced f32 config (2 layers): the
    full-width state is 36 GB, too much to write to disk in a smoke run.
    Deterministic algorithms are on for this part, so replay is exact."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.optim.adamw import named_leaves
    from repro_torch.resilience import Fault
    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    nondet = _resume_nondeterministic()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _resume_run(RESUME_DIR / "run", 8,
                    Fault("train.step", mode="raise", after=4))
        tr, out = _resume_run(RESUME_DIR / "run", 8)
        start = tr.start_step
        ref_tr, ref = _resume_run(RESUME_DIR / "ref", 8)
        ref2_tr, _ = _resume_run(RESUME_DIR / "ref2", 8)
    finally:
        torch.use_deterministic_algorithms(False)
    ref_params = ref_tr.params
    d_res = _max_diff(tr.params, ref_params)
    d_rep = _max_diff(ref2_tr.params, ref_params)
    resumed = {h["step"]: h["loss"] for h in out["history"]}
    loss_rel = max(abs(resumed[h["step"]] - h["loss"]) / abs(h["loss"])
                   for h in ref["history"] if h["step"] in resumed)
    ok_params = all(
        np.allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-5, atol=1e-6)
        for (_, a), (_, b) in zip(named_leaves(tr.params),
                                  named_leaves(ref_params)))
    log(f"[train] resume: killed in step 5 of 8, restarted at step {start}, "
        f"finished {out['steps']} steps; params max|diff| against an "
        f"uninterrupted run {d_res:.3e} (rtol 1e-5, atol 1e-6), loss per "
        f"step max rel diff {loss_rel:.2e} (1e-5); two uninterrupted runs "
        f"differ by {d_rep:.3e}")
    if start not in (2, 4) or out["steps"] != 8 - start or not ok_params \
            or not loss_rel <= 1e-5:
        raise AssertionError("kill-and-resume does not match an "
                             "uninterrupted run")
    newest = ckpt.latest_step(str(RESUME_DIR / "run"))
    path = RESUME_DIR / "run" / f"step_{newest:08d}" / "arrays.npz"
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0x01                  # flip one byte
    path.write_bytes(bytes(raw))
    like = {"params": tr.params, "opt": tr.opt_state}
    step, state = ckpt.restore_latest_valid(str(RESUME_DIR / "run"), like)
    dev = {t.device.type for _, t in named_leaves(state["params"])}
    log(f"[train] one byte of step {newest}'s arrays.npz flipped: "
        f"restore_latest_valid fell back to step {step}, params on {dev}")
    if step is None or step >= newest or dev != {"cuda"}:
        raise AssertionError("restore_latest_valid did not fall back past "
                             "the corrupt checkpoint")
    shutil.rmtree(RESUME_DIR)
    return {"restart_step": start, "param_max_diff": d_res,
            "replay_max_diff": d_rep, "loss_rel": loss_rel,
            "nondeterministic": nondet}


def _resume_nondeterministic():
    """(c) first, the same kill-and-resume with deterministic algorithms
    off, as ``launch.train`` runs: held to the reference's tolerance
    (rtol 1e-5, atol 1e-6)."""
    import numpy as np
    import torch
    from repro_torch.optim.adamw import named_leaves
    from repro_torch.resilience import Fault
    torch.use_deterministic_algorithms(False)
    _resume_run(RESUME_DIR / "nd_run", 8,
                Fault("train.step", mode="raise", after=4))
    tr, out = _resume_run(RESUME_DIR / "nd_run", 8)
    ref_tr, ref = _resume_run(RESUME_DIR / "nd_ref", 8)
    pairs = list(zip(named_leaves(tr.params), named_leaves(ref_tr.params)))
    held = sum(np.allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-5,
                           atol=1e-6) for (_, a), (_, b) in pairs)
    worst = max(float(((a - b).abs() / (1e-6 + 1e-5 * b.abs())).max())
                for (_, a), (_, b) in pairs)
    d = _max_diff(tr.params, ref_tr.params)
    log(f"[train] resume with deterministic algorithms off: params max|diff|"
        f" {d:.3e}; {held} of {len(pairs)} leaves within rtol 1e-5, atol "
        f"1e-6 (worst |diff| / (atol + rtol |ref|) {worst:.3g})")
    if held != len(pairs):
        raise AssertionError("kill-and-resume with deterministic algorithms "
                             "off does not match an uninterrupted run")
    return {"param_max_diff": d, "leaves_held": int(held),
            "leaves": len(pairs), "worst_ratio": worst}


def _max_diff(a, b):
    from repro_torch.optim.adamw import named_leaves
    return max(float((x - y).abs().max()) for (_, x), (_, y) in
               zip(named_leaves(a), named_leaves(b)))


def _train_refusal():
    """(d) a train step through a kernel (use_kernel=True) raises."""
    import torch
    from repro_torch.core.policy import MCAConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, use_kernel=True,
                    sites=("v_proj",))
    cfg = _reduced_train(n_layers=1, vocab_size=128, d_model=256, n_heads=2,
                         n_kv_heads=1, d_head=128, mca=mca)
    model = build_model(cfg, device="cuda")
    params = model.init(0)
    step = make_train_step(model, adamw.AdamWConfig())
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             SyntheticLM(128, 16, 2, seed=0).batch(0).items()}
    ops.reset_launch_counts()
    try:
        step(params, adamw.init_state(params), batch)
    except RuntimeError as e:
        if "no backward kernel" not in str(e):
            raise
        log(f"[train] use_kernel=True step refused: {e}")
    else:
        raise AssertionError("a train step through the MCA kernel did not "
                             "raise")
    if any(ops.launch_counts().values()):
        raise AssertionError(f"launched {ops.launch_counts()}")


def phase_train():
    """Phase 8: the training path on the card, parts (a)-(d)."""
    t0 = time.perf_counter()
    nums = _train_full_width()
    nums["parity"] = _train_parity()
    nums["resume"] = _train_resume()
    _train_refusal()
    nums["phase_s"] = time.perf_counter() - t0
    return nums


# ------------------------------------------------------------- phase 9
# (arch, MCA sites) served at full width, one after the other
FAMILIES = [("olmoe-1b-7b", ("v_proj", "o_proj", "expert_ffn")),
            ("minicpm3-4b", ("v_proj", "o_proj"))]
FAMILY_REQUESTS = 6               # SlotBatcher requests, prompts 16..200
FAMILY_WAVE = 4                   # ContinuousBatcher requests of 32 tokens
FAMILY_NEW = 16                   # new tokens per request


def _mca_launches(mca, d, n):
    """(launches, sampled blocks) of mca_matmul_fixed for one MCA
    projection of n tokens at input width d: a launch for every sampled
    tier whose capacity the dispatch sends to the kernel (``cap % min(128,
    cap) == 0``, block >= 128), counted from the routing's own ladder and
    capacities; each counts, in the reference's units, ``cap // min(128,
    cap)`` row tiles x the tier's R blocks."""
    from repro_torch.core import schedule
    from repro_torch.core.policy import _caps_for
    block = mca.block_for(d)
    ladder = schedule.tier_ladder(d, block, mca.n_tiers, mca.r_min_blocks)
    caps = _caps_for(n, len(ladder), mca.capacity_fracs)
    n_launch = n_blocks = 0
    for t in range(len(ladder) - 1):
        cap = caps[t]
        if block >= 128 and cap % min(128, cap) == 0:
            n_launch += 1
            n_blocks += cap // min(128, cap) * ladder[t]
    return n_launch, n_blocks


def _expected_mca(cfg, prefill_tokens):
    """(launches, sampled blocks) of mca_matmul_fixed for the prefills
    that routed these token counts: v_proj and o_proj of every attention
    layer (``_mca_launches``)."""
    from repro_torch.models import stack
    if cfg.attn_type == "mla":
        dims = (cfg.mla_kv_lora, cfg.n_heads * cfg.mla_v_dim)
    else:
        dims = (cfg.d_model, cfg.n_heads * cfg.d_head)
    n_launch = n_blocks = 0
    for n in prefill_tokens:
        for d in dims:
            la, bl = _mca_launches(cfg.mca, d, n)
            n_launch += la
            n_blocks += bl
    n_attn = sum(k.startswith("attn") for k in stack.layer_kinds(cfg))
    return n_attn * n_launch, n_attn * n_blocks


def _serve_family(arch, sites):
    """(b) ``arch`` at full width (bf16, random weights from seed 0, depth
    not cut) with MCA on its sites through both batchers."""
    import gc
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.policy import MCAConfig
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import (ContinuousBatcher, Engine, Request,
                                   SlotBatcher)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, use_kernel=True,
                    sites=sites)
    cfg = get_config(arch, mca=mca)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    log(f"[families] {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B params ({cfg.dtype}) made on the card in "
        f"{time.perf_counter() - t_phase:.1f}s; MCA sites {sites}")
    engine = Engine(model, params, batch_size=4, max_len=512,
                    mca_enabled=True)
    routed = []                  # tokens of every prefill, in order
    inner = engine._prefill

    def prefill(batch_in, mca_on):
        routed.append(int(batch_in["tokens"].numel()))
        return inner(batch_in, mca_on)

    engine._prefill = prefill
    rng = np.random.default_rng(9)
    launches = {}
    nums = {"params": n_params}
    for name in ("slot", "wave"):
        if name == "slot":
            reqs = [Request(uid=i, prompt=rng.integers(
                1, cfg.vocab_size, int(rng.integers(16, 201))),
                max_new=FAMILY_NEW) for i in range(FAMILY_REQUESTS)]
            batcher = SlotBatcher(engine, check_every=8)
        else:
            reqs = [Request(uid=100 + i, prompt=rng.integers(
                1, cfg.vocab_size, 32), max_new=FAMILY_NEW)
                for i in range(FAMILY_WAVE)]
            batcher = ContinuousBatcher(engine)
        del routed[:]
        with obs.scoped() as reg:
            for r in reqs:
                batcher.submit(r)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            batcher.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[name] = ops.launch_counts()
            snap = reg.snapshot()
        what = f"{arch} {type(batcher).__name__}"
        _check_requests(what, reqs, cfg.vocab_size, FAMILY_NEW)
        hists, c = snap["histograms"], snap["counters"]
        # a burst is 8 decode steps; the one wave decodes FAMILY_NEW - 1
        steps = (hists["serve.decode_step_seconds"]["count"] * 8
                 if name == "slot" else FAMILY_NEW - 1)
        _check_path(what, snap, launches[name], steps, cfg.n_layers)
        got = launches[name]["mca_matmul_fixed"]
        calls = c.get("kernels.mca_matmul.kernel_calls", 0)
        want = _expected_mca(cfg, routed)[0]
        occ = sum(v for k, v in c.items()
                  if k.startswith("serve.tier_occupancy"))
        want_occ = cfg.n_layers * 2 * c["serve.prefill_tokens"]
        red = snap["gauges"]["serve.flops_reduction"]
        log(f"[families] {what}: prefills of {routed} tokens, "
            f"mca_matmul_fixed launches {got} (kernel_calls {calls}, from "
            f"the routing {want}), kv_slot_update "
            f"{launches[name]['kv_slot_update']} = {cfg.n_layers} layers x "
            f"{steps} decode steps, tier "
            f"occupancy {occ} (want {want_occ}), flops_reduction {red:.3f}")
        if not (got == calls == want and got > 0 and occ == want_occ
                and red > 1.0):
            raise AssertionError(f"{what}: MCA launches or accounting do "
                                 "not add up")
        nums[name] = {
            "prefill_p50_s": hists["serve.prefill_seconds"]["p50"],
            "decode_step_p50_s": hists["serve.decode_step_seconds"]["p50"],
            "tokens_per_s": c["serve.generated_tokens"] / wall,
            "prefill_tokens": c["serve.prefill_tokens"],
            "generated_tokens": c["serve.generated_tokens"],
            "decode_steps": steps, "wall_s": wall,
            "flops_reduction": red}
    engine._prefill = inner
    nums["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # the combine and every other step are deterministic: two greedy
    # generations of the same prompts (MCA on, same key) agree
    prompts = rng.integers(1, cfg.vocab_size, (4, 64))
    outs = [engine.generate(prompts, 8) for _ in range(2)]
    if not np.array_equal(outs[0], outs[1]):
        raise AssertionError(f"{arch}: two runs gave different tokens")
    prof = phase_profile(engine, tag=f"[families] {arch} profile")
    nums["profile"] = {k: {kk: v[kk] for kk in (
        "wall_ms", "device_busy_ms", "device_busy_share", "kernel_launches")}
        for k, v in prof.items()}
    total = {k: launches["slot"][k] + launches["wave"][k]
             for k in launches["slot"]}
    del engine, params, model
    nums["phase_s"] = time.perf_counter() - t_phase
    log(f"[families] {arch}: " + json.dumps(nums)
        + "; two runs of the same prompts gave the same tokens")
    return total, nums


def phase_families():
    """Phase 9: the MoE and MLA families, with nothing else resident:
    (a) reduced olmoe-1b-7b and minicpm3-4b, card against CPU; (b) both at
    full width with MCA on, one after the other."""
    t0 = time.perf_counter()
    out = {"parity": {arch: _card_vs_cpu(arch, "[families]")
                      for arch, _ in FAMILIES}}
    launches = {}
    for arch, sites in FAMILIES:
        total, out[arch] = _serve_family(arch, sites)
        for k, v in total.items():
            launches[k] = launches.get(k, 0) + v
    out["phase_s"] = time.perf_counter() - t0
    return launches, out


# ------------------------------------------------------------ phase 11
# (arch, MCA sites) of the SSM and hybrid families, one after the other
SSM_HYBRID = [("mamba2-2.7b", ()), ("recurrentgemma-9b", ("v_proj", "o_proj"))]
SSM_HYBRID_GEN = (4, 256, 32)      # generate: prompts, prompt tokens, new
SSM_HYBRID_WAVE = (4, 128, 16)     # ContinuousBatcher: requests, tokens, new
WINDOW_RUN = (2, 2560, 2624, 16)   # batch, prompt, max_len, decode steps
ALL_KERNELS = SERVE_KERNELS + ENTRY_KERNELS + ("attn_lse", "attn_av")


def _check_family_counts(what, cfg, snap, launches, steps, routed):
    """Launches of a family's run: one layer write per attention layer
    per decode step (the reference's two kernel calls), mca_matmul_fixed
    at the routing's count, no fallback; a model with no attention layer
    (or MCA off) launches only what its layers need."""
    from repro_torch.models import stack
    c = snap["counters"]
    n_attn = sum(k.startswith("attn") for k in stack.layer_kinds(cfg))
    kv_calls = c.get("kernels.kv_slot_update.kernel_calls", 0)
    mca_calls = c.get("kernels.mca_matmul.kernel_calls", 0)
    fallbacks = {k: v for k, v in c.items() if k.endswith("fallback_calls")}
    want_mca = _expected_mca(cfg, routed)[0] if cfg.mca.enabled else 0
    red = snap["gauges"].get("serve.flops_reduction", 1.0)
    log(f"[ssm-hybrid] {what}: {n_attn} attention layers, {steps} decode "
        f"steps, prefills of {routed} tokens; launches {launches}; "
        f"kv_slot_update kernel_calls {kv_calls}, mca_matmul kernel_calls "
        f"{mca_calls} (routing {want_mca}), fallbacks {fallbacks}, "
        f"flops_reduction {red:.3f}")
    ok = (launches["kv_slot_update"] == n_attn * steps
          and kv_calls == 2 * n_attn * steps
          and launches["mca_matmul_fixed"] == mca_calls == want_mca
          and not any(fallbacks.values())
          and all(launches[k] == 0 for k in ENTRY_ONLY)
          and _passes_together(launches))
    if cfg.mca.enabled:
        ok = ok and want_mca > 0 and red > 1.0
    else:
        ok = ok and red == 1.0
    if not ok:
        raise AssertionError(f"{what}: kernel launches or MCA accounting do "
                             "not add up")


def _profile_wave(engine, prompts, tag):
    """One profiled prefill of ``prompts`` (the wave path: Model.prefill
    and the last position's logits) and one 8-step decode burst from it."""
    import torch
    batch_in = {"tokens": engine._ids(prompts)}
    box = {}

    def prefill():
        box["cache"], box["logits"], _ = engine._prefill(
            batch_in, engine.mca_enabled)

    def burst():
        for _ in range(8):
            box["tok"], box["cache"], box["t"], box["bad"] = \
                engine._decode_step(box["tok"], box["cache"], box["t"],
                                    box["bad"])

    prefill()                                      # warm up
    out = {"prefill": _profile_summary(tag, "prefill", *_profile(prefill))}
    box["tok"] = engine._argmax(box["logits"])
    box["t"] = torch.full((), prompts.shape[1], dtype=torch.int32,
                          device="cuda")
    box["bad"] = torch.zeros((), dtype=torch.bool, device="cuda")
    burst()                                        # warm up
    out["decode_burst_8"] = _profile_summary(tag, "decode_burst_8",
                                             *_profile(burst))
    if bool(box["bad"]):
        raise AssertionError(f"{tag}: non-finite logits in the profiled "
                             "burst")
    return {k: {kk: v[kk] for kk in ("wall_ms", "device_busy_ms",
                                     "device_busy_share", "kernel_launches",
                                     "top_device")}
            for k, v in out.items()}


def _serve_ssm_hybrid(arch, sites):
    """(b) ``arch`` at full width (bf16, random weights from seed 0, depth
    not cut), MCA on its sites (none: MCA off): Engine.generate, then a
    ContinuousBatcher, with the launch checks; two generations of the same
    prompts give the same tokens; a profiled prefill and burst.  Returns
    (launches, numbers, the engine)."""
    import gc
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.policy import MCAConfig
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serve import ContinuousBatcher, Engine, Request
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    mca = MCAConfig(enabled=bool(sites), alpha=0.2, block=128,
                    use_kernel=True, sites=sites or ("v_proj", "o_proj"))
    cfg = get_config(arch, mca=mca)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    log(f"[ssm-hybrid] {arch}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {n_params / 1e9:.3f} B params ({cfg.dtype}) made "
        f"on the card in {time.perf_counter() - t_phase:.1f}s; MCA sites "
        f"{sites or 'none (MCA off)'}")
    engine = Engine(model, params, batch_size=4, max_len=512,
                    mca_enabled=bool(sites))
    routed = []
    inner = engine._prefill

    def prefill(batch_in, mca_on):
        routed.append(int(batch_in["tokens"].numel()))
        return inner(batch_in, mca_on)

    engine._prefill = prefill
    rng = np.random.default_rng(11)
    launches, nums = {}, {"params": n_params}
    b, s, new = SSM_HYBRID_GEN
    prompts = rng.integers(1, cfg.vocab_size, (b, s))
    with obs.scoped() as reg:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        gen = engine.generate(prompts, new)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["generate"] = ops.launch_counts()
        snap = reg.snapshot()
    if gen.shape != (b, new) or gen.min() < 0 or gen.max() >= cfg.vocab_size:
        raise AssertionError(f"{arch}: generate gave {gen.shape} tokens "
                             f"in [{gen.min()}, {gen.max()}]")
    _check_family_counts(f"{arch} generate", cfg, snap,
                         launches["generate"], new - 1, routed)
    h, c = snap["histograms"], snap["counters"]
    nums["generate"] = {
        "prefill_s": h["serve.prefill_seconds"]["p50"],
        "decode_step_p50_s": h["serve.decode_step_seconds"]["p50"],
        "tokens_per_s": c["serve.generated_tokens"] / wall, "wall_s": wall,
        "flops_reduction": snap["gauges"]["serve.flops_reduction"]}
    n_req, s_w, new_w = SSM_HYBRID_WAVE
    reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab_size, s_w),
                    max_new=new_w) for i in range(n_req)]
    del routed[:]
    with obs.scoped() as reg:
        cb = ContinuousBatcher(engine)
        for r in reqs:
            cb.submit(r)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        cb.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["wave"] = ops.launch_counts()
        snap = reg.snapshot()
    _check_requests(f"{arch} ContinuousBatcher", reqs, cfg.vocab_size, new_w)
    _check_family_counts(f"{arch} ContinuousBatcher", cfg, snap,
                         launches["wave"], new_w - 1, routed)
    h, c = snap["histograms"], snap["counters"]
    nums["wave"] = {
        "prefill_s": h["serve.prefill_seconds"]["p50"],
        "decode_step_p50_s": h["serve.decode_step_seconds"]["p50"],
        "tokens_per_s": c["serve.generated_tokens"] / wall, "wall_s": wall,
        "flops_reduction": snap["gauges"]["serve.flops_reduction"]}
    engine._prefill = inner
    nums["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    # greedy decode with the same key is deterministic: a second
    # generation of the same prompts gives the first one's tokens
    again = engine.generate(prompts, 8)
    if not np.array_equal(again, gen[:, :8]):
        raise AssertionError(f"{arch}: two generations of the same prompts "
                             "gave different tokens")
    nums["profile"] = _profile_wave(engine, prompts,
                                    f"[ssm-hybrid] {arch} profile")
    nums["phase_s"] = time.perf_counter() - t_phase
    total = {k: launches["generate"][k] + launches["wave"][k]
             for k in launches["generate"]}
    log(f"[ssm-hybrid] {arch}: " + json.dumps(nums)
        + "; two generations of the same prompts gave the same tokens")
    return total, nums, engine


class _CountBanded:
    """Counts the calls of ``models.attention.banded_onepass`` (one per
    attention layer that takes the banded branch) while installed."""

    def __enter__(self):
        from repro_torch.models import attention
        self.calls = 0
        self._orig = orig = attention.banded_onepass

        def counted(*a, **k):
            self.calls += 1
            return orig(*a, **k)

        attention.banded_onepass = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention
        attention.banded_onepass = self._orig


def _prefill_logits(model, params, batch_in, max_len):
    """(cache, last-position logits over the vocab) of one prefill."""
    from repro_torch.models.api import _logits
    cache, hid, _ = model.prefill(params, batch_in, max_len)
    return cache, _logits(params, model.cfg,
                          hid[:, -1:])[..., :model.cfg.vocab_size]


def _banded_f32(cfg, batch_in, max_len):
    """(c1) The banded path's arithmetic at full width: recurrentgemma-9b
    in f32 (TF32 off), depth cut to one pattern (rec, rec, attn: one
    attention layer, window 2,048), the banded prefill against the
    chunked one, last-position logits within 1e-4 of max |logit| (the
    same f32 function summed in another order)."""
    import gc
    import torch
    from repro_torch.models import build_model
    c = cfg.replace(dtype="float32", n_layers=len(cfg.block_pattern))
    chunked = build_model(c)
    params = chunked.init(torch.Generator(device="cuda").manual_seed(1))
    _, want = _prefill_logits(chunked, params, batch_in, max_len)
    with _CountBanded() as runs:
        _, got = _prefill_logits(build_model(c.replace(banded_local=True)),
                                 params, batch_in, max_len)
    err = _held("[ssm-hybrid] window f32, full width, 3 layers: banded "
                "prefill last-position logits vs chunked", got, want,
                1e-4 * float(want.abs().max()))
    if runs.calls != 1:
        raise AssertionError(f"f32: {runs.calls} banded layers, want 1")
    del params, got, want
    gc.collect()
    torch.cuda.empty_cache()
    return err


def _window_run(engine):
    """(c) recurrentgemma-9b at full width, MCA off, through its rolling
    2,048-slot window, prompts of 2 x 2,560 tokens: (c1) the banded path
    in f32 at one pattern's depth; (c2) in bf16 at full depth, the banded
    prefill (every attention layer takes it) against the chunked one,
    last-position logits within 2e-2 of max |logit| or, where the
    model's own bf16 rounding noise is larger, within twice that noise
    (the chunked path with chunk 256 against 512: the same function
    rounded at other points); the prefill's tail branch (slot p % 2048
    holds p for p = 512..2559); 16 decode steps from t = 2560 that wrap
    onto slots 512..527 in every attention layer (12 layer writes a step,
    every logit finite); two generations of the same prompts with the
    same tokens."""
    import gc
    import numpy as np
    import torch
    from repro_torch.core.policy import MCAConfig
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, stack
    from repro_torch.serve import Engine
    t0 = time.perf_counter()
    b, s, max_len, steps = WINDOW_RUN
    params = engine.params
    cfg = engine.model.cfg.replace(mca=MCAConfig())          # MCA off
    slots = cfg.window
    n_attn = stack.layer_kinds(cfg).count("attn_ffn")
    toks = np.random.default_rng(13).integers(1, cfg.vocab_size, (b, s))
    batch_in = {"tokens": torch.as_tensor(toks, device="cuda")}
    err_f32 = _banded_f32(cfg, batch_in, max_len)
    banded = build_model(cfg.replace(banded_local=True))
    _, want = _prefill_logits(build_model(cfg), params, batch_in, max_len)
    _, other = _prefill_logits(
        build_model(cfg.replace(attn_chunk=cfg.attn_chunk // 2)), params,
        batch_in, max_len)
    noise = float((other - want).abs().max())
    del other
    gc.collect()
    with _CountBanded() as runs:
        cache, got = _prefill_logits(banded, params, batch_in, max_len)
    tol = max(2e-2 * float(want.abs().max()), 2 * noise)
    log(f"[ssm-hybrid] window bf16: the chunked prefill with chunk "
        f"{cfg.attn_chunk // 2} against {cfg.attn_chunk} differs by "
        f"{noise:.3e} in the last-position logits (max |logit| "
        f"{float(want.abs().max()):.3e}): the model's bf16 rounding noise")
    err = _held("[ssm-hybrid] window bf16: banded prefill last-position "
                "logits vs chunked", got, want, tol)
    if runs.calls != n_attn:
        raise AssertionError(f"the banded prefill took the banded path in "
                             f"{runs.calls} of {n_attn} attention layers")
    spos = cache["layers"]["slot_pos"]                  # [n_attn, B, slots]
    first = s - slots                                   # oldest position
    ar = torch.arange(slots, device="cuda", dtype=torch.int32)
    tail = first + (ar - first) % slots                  # slot p % slots: p
    if not bool((spos == tail).all()):
        raise AssertionError(f"the prefill's rolling tail: slot_pos is not "
                             f"p at slot p % {slots} for p = {first}.."
                             f"{s - 1}")
    tok = torch.argmax(got, dim=-1).to(torch.int32)
    ops.reset_launch_counts()
    for i in range(steps):
        logits, cache = banded.decode(params, tok, cache, torch.tensor(
            s + i, dtype=torch.int32, device="cuda"))
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"non-finite logits at decode step {i}")
        tok = torch.argmax(logits[..., :cfg.vocab_size], dim=-1).to(
            torch.int32)
    torch.cuda.synchronize()
    kv = ops.launch_counts()["kv_slot_update"]
    wrapped = tail.clone()
    new_t = torch.arange(s, s + steps, device="cuda", dtype=torch.int32)
    wrapped[new_t % slots] = new_t      # the oldest slots take t = s, ...
    if kv != n_attn * steps or not bool((spos == wrapped).all()):
        raise AssertionError(f"decode past the window: {kv} layer writes "
                             f"(want {n_attn * steps}), or slot_pos of "
                             f"slots {s % slots}.. is not {s}..{s + steps - 1}"
                             " in every attention layer")
    log(f"[ssm-hybrid] window: {n_attn} attention layers took the banded "
        f"path; slot_pos after the prefill = p at slot p % {slots} for p = "
        f"{first}..{s - 1}; {steps} decode steps from t = {s}: {kv} layer "
        f"writes, slots {s % slots}..{(s + steps - 1) % slots} now hold "
        f"{s}..{s + steps - 1} (they held {first}..{first + steps - 1}) in "
        "every attention layer, every logit finite")
    del cache
    gc.collect()
    eng = Engine(banded, params, batch_size=b, max_len=max_len)
    outs = [eng.generate(toks, steps + 1) for _ in range(2)]
    if not np.array_equal(outs[0], outs[1]):
        raise AssertionError("window: two generations of the same prompts "
                             "gave different tokens")
    nums = {"logits_err_f32": err_f32, "logits_err": err,
            "logits_tol": tol, "noise_floor": noise,
            "max_logit": float(want.abs().max()), "layer_writes": kv,
            "seconds": time.perf_counter() - t0}
    log(f"[ssm-hybrid] window: two generations of the same prompts gave "
        f"the same tokens; {json.dumps(nums)}")
    return nums


def phase_ssm_hybrid():
    """Phase 11: the SSM and hybrid families, after phase 9 with nothing
    else resident: (a) reduced mamba2-2.7b (2 layers) and recurrentgemma-9b
    (5 layers: a remainder), card against CPU on equal-length prompts;
    (b) both at full width, one after the other; (c) recurrentgemma-9b's
    window at full width."""
    t0 = time.perf_counter()
    out = {"parity": {
        "mamba2-2.7b": _card_vs_cpu("mamba2-2.7b", "[ssm-hybrid]",
                                    ragged=False),
        "recurrentgemma-9b": _card_vs_cpu("recurrentgemma-9b",
                                          "[ssm-hybrid]", n_layers=5,
                                          ragged=False)}}
    launches = {k: 0 for k in ALL_KERNELS}
    for arch, sites in SSM_HYBRID:
        total, out[arch], engine = _serve_ssm_hybrid(arch, sites)
        for k, v in total.items():
            launches[k] += v
        if arch == "recurrentgemma-9b":
            out["window"] = _window_run(engine)
        del engine
    out["phase_s"] = time.perf_counter() - t0
    log(f"[ssm-hybrid] phase 11 passed in {out['phase_s']:.1f}s")
    return launches, out


# ------------------------------------------------------------ phase 12
# (arch, prompt tokens, max_len) at full width; batch 4, 32 decode steps
ENCDEC_VLM = [("whisper-small", 256, 320), ("internvl2-1b", 256, 576)]
ENCDEC_VLM_B, ENCDEC_VLM_STEPS = 4, 32
ENCDEC_VLM_DVF = (2, 128)          # (c): batch, tokens (the last decoded)


def _encdec_vlm_batch(cfg, b, s, seed, device):
    """Tokens [b, s] and the family's stub features from ``seed``: frames
    [b, encoder_len, d] or patches [b, n_patch_tokens, d]; and the first
    decode position (s, or s + the patches, which positions count)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (b, s))
    name, n = (("frames", cfg.encoder_len) if cfg.is_encoder_decoder
               else ("patches", cfg.n_patch_tokens))
    feats = rng.standard_normal((b, n, cfg.d_model), dtype=np.float32)
    batch = {"tokens": torch.as_tensor(toks, device=device),
             name: torch.as_tensor(feats, device=device)}
    return batch, s if cfg.is_encoder_decoder else s + n


def _first_token(model, params, batch, max_len, key=None):
    """``Model.prefill`` and the greedy token after it: (cache, token
    [B, 1] int32, its logits, the prefill's stats)."""
    import torch
    from repro_torch.models.api import _logits
    cfg = model.cfg
    cache, hid, stats = model.prefill(params, batch, max_len, key)
    logits = _logits(params, cfg, hid[:, -1:])
    tok = torch.argmax(logits[..., :cfg.vocab_size], -1).to(torch.int32)
    return cache, tok, logits, stats


def _decode_greedy(model, params, tok, cache, t0, steps, clock=None):
    """``steps`` greedy ``Model.decode`` steps from ``tok`` at position
    ``t0``, t on the device: (the new tokens, the last logits, a device
    flag of any non-finite logit, each step's time by ``clock``)."""
    import torch
    vocab = model.cfg.vocab_size
    out, step_s, bad = [], [], torch.zeros((), dtype=torch.bool,
                                           device=model.device)
    t = torch.full((), t0, dtype=torch.int32, device=model.device)
    logits = None
    for _ in range(steps):
        t_a = clock() if clock else 0.0
        logits, cache = model.decode(params, tok, cache, t)
        tok = torch.argmax(logits[..., :vocab], -1).to(torch.int32)
        step_s.append((clock() if clock else 0.0) - t_a)
        bad |= ~torch.isfinite(logits).all()
        out.append(tok)
        t = t + 1
    return out, logits, bad, step_s


def _greedy(model, params, batch, t0, steps, max_len, key=None,
            times=None):
    """``Model.prefill`` then ``steps`` greedy ``Model.decode`` steps from
    position ``t0``, t on the device.  Returns (tokens [B, steps + 1] on
    the host, the last logits, the prefill's stats, whether any logit was
    non-finite).  With ``times`` (a dict) each call is synchronised and
    timed: ``prefill_s`` and the list ``step_s``."""
    import torch
    on_card = model.device.type == "cuda"

    def clock():
        if on_card and times is not None:
            torch.cuda.synchronize()
        return time.perf_counter()

    with torch.no_grad():
        t_a = clock()
        cache, tok, logits, stats = _first_token(model, params, batch,
                                                 max_len, key)
        t_b = clock()
        out, last, bad, step_s = _decode_greedy(model, params, tok, cache,
                                                t0, steps, clock)
        bad |= ~torch.isfinite(logits).all()
    if times is not None:
        times.update(prefill_s=t_b - t_a, step_s=step_s)
    return (torch.cat([tok] + out, 1).cpu().numpy(),
            logits if last is None else last, stats, bool(bad))


def _encdec_vlm_card_vs_cpu(arch):
    """(a) reduced ``arch`` (f32, 2 layers, 2 encoder layers, 32 frames or
    8 patches, vocab 128, MCA off, TF32 off) through prefill and 8 decode
    steps on the card and on the CPU from the same params: the same
    greedy tokens (and again in a second card run), the forward's hidden
    states and logits within 1e-4."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduced
    from repro_torch.models.api import _logits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = reduced(get_config(arch), n_layers=2, vocab_size=128)
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(0)
    gpu = build_model(cfg, device="cuda")
    gparams = _to_device(params, "cuda")
    toks, hid, logits = [], [], []
    for model, p in ((cpu, params), (gpu, gparams), (gpu, gparams)):
        batch, t0 = _encdec_vlm_batch(cfg, 2, 12, 0, model.device)
        toks.append(_greedy(model, p, batch, t0, 8, t0 + 16)[0])
        with torch.no_grad():
            h, _, _ = model.forward_hidden(p, batch)
        hid.append(h.float().cpu().numpy())
        logits.append(_logits(p, cfg, h)[..., :128].cpu().numpy())
    diff = float(np.abs(hid[0] - hid[1]).max())
    ldiff = float(np.abs(logits[0] - logits[1]).max())
    log(f"[encdec-vlm] {arch} reduced f32 (2 layers"
        f"{', 2 encoder layers' if cfg.is_encoder_decoder else ''}) tokens "
        f"cpu={toks[0].tolist()} gpu={toks[1].tolist()} hidden "
        f"max|diff|={diff:.3e} logits max|diff|={ldiff:.3e}; second card "
        f"run {'identical' if np.array_equal(toks[1], toks[2]) else 'DIFFERS'}")
    if not (np.array_equal(toks[0], toks[1])
            and np.array_equal(toks[1], toks[2])
            and diff <= 1e-4 and ldiff <= 1e-4):
        raise AssertionError(f"reduced {arch} on the card != on the CPU")
    return {"hidden_diff": diff, "logits_diff": ldiff}


def _encdec_vlm_expected_mca(cfg, b, s):
    """(encoder, decoder) launches of mca_matmul_fixed in one prefill, from
    the routing: whisper's encoder v_proj and o_proj and its cross v_proj
    route B x encoder_len tokens, its self v_proj, self o_proj and cross
    o_proj B x S; the VLM's v_proj and o_proj route B x (P + S)."""
    mca = cfg.mca
    d_v, d_o = cfg.d_model, cfg.n_heads * cfg.d_head
    if not cfg.is_encoder_decoder:
        return 0, _expected_mca(cfg, [b * (s + cfg.n_patch_tokens)])[0]
    n_enc, n_dec = b * cfg.encoder_len, b * s
    enc = cfg.n_encoder_layers * (_mca_launches(mca, d_v, n_enc)[0]
                                  + _mca_launches(mca, d_o, n_enc)[0])
    dec = cfg.n_layers * (_mca_launches(mca, d_v, n_dec)[0]
                          + 2 * _mca_launches(mca, d_o, n_dec)[0]
                          + _mca_launches(mca, d_v, n_enc)[0])
    return enc, dec


def _profile_encdec_vlm(model, params, batch, t0, max_len, tag):
    """One profiled prefill and one profiled 8-step decode burst."""
    import torch
    box = {}

    def prefill():
        box["cache"], box["tok"], _, _ = _first_token(model, params, batch,
                                                      max_len, 0)

    def burst():
        _decode_greedy(model, params, box["tok"], box["cache"], t0, 8)

    out = {}
    with torch.no_grad():
        for name, fn in (("prefill", prefill), ("decode_burst_8", burst)):
            fn()                                             # warm up
            out[name] = _profile_summary(tag, name, *_profile(fn))
    return {k: {kk: v[kk] for kk in ("wall_ms", "device_busy_ms",
                                     "device_busy_share", "kernel_launches",
                                     "top_device")}
            for k, v in out.items()}


def _serve_encdec_vlm(arch, s, max_len):
    """(b) ``arch`` at full width (bf16, random weights from seed 0, depth
    not cut), MCA on v_proj and o_proj (alpha 0.2, block 128, use_kernel),
    through ``build_model`` -> ``prefill`` -> 32 ``decode`` steps of 4
    rows: every logit finite, one layer write per decoder layer per step,
    mca_matmul_fixed at the routing's count, no fallback,
    ``flops_reduction`` > 1 from ``forward_hidden`` (the encoder
    included), a second run with the same tokens; prefill time, decode
    step p50, tokens/s, peak memory and one profiled prefill and burst."""
    import gc
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.policy import MCAConfig, flops_reduction
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, use_kernel=True,
                    sites=("v_proj", "o_proj"))
    cfg = get_config(arch, mca=mca)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    n_params = sum(t.numel() for t in _leaves(params))
    b, steps = ENCDEC_VLM_B, ENCDEC_VLM_STEPS
    batch, t0 = _encdec_vlm_batch(cfg, b, s, 12, "cuda")
    torch.cuda.synchronize()
    log(f"[encdec-vlm] {arch}: {cfg.n_layers} decoder layers"
        f"{f' + {cfg.n_encoder_layers} encoder' if cfg.is_encoder_decoder else ''}"
        f", d_model {cfg.d_model}, {n_params / 1e9:.3f} B params "
        f"({cfg.dtype}) made on the card in "
        f"{time.perf_counter() - t_phase:.1f}s; inputs "
        f"{ {k: list(v.shape) for k, v in batch.items()} }, decode from t = "
        f"{t0}, max_len {max_len}")
    times = {}
    with obs.scoped() as reg:
        ops.reset_launch_counts()
        toks, _, _, bad = _greedy(model, params, batch, t0, steps, max_len,
                                  key=0, times=times)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        c = reg.snapshot()["counters"]
    enc_want, dec_want = _encdec_vlm_expected_mca(cfg, b, s)
    kv_calls = c.get("kernels.kv_slot_update.kernel_calls", 0)
    mca_calls = c.get("kernels.mca_matmul.kernel_calls", 0)
    fallbacks = {k: v for k, v in c.items() if k.endswith("fallback_calls")}
    with torch.no_grad():
        _, _, st = model.forward_hidden(params, batch, 0)
    red = float(flops_reduction(st))
    log(f"[encdec-vlm] {arch}: launches {launches}; kv_slot_update "
        f"kernel_calls {kv_calls} ({cfg.n_layers} layers x {steps} steps = "
        f"{cfg.n_layers * steps} launches); mca_matmul_fixed kernel_calls "
        f"{mca_calls}, from the routing {enc_want} (encoder) + {dec_want} "
        f"(decoder); fallbacks {fallbacks}; forward flops_reduction "
        f"{red:.3f}; any non-finite logit: {bad}")
    if not (not bad and launches["kv_slot_update"] == cfg.n_layers * steps
            and kv_calls == 2 * cfg.n_layers * steps
            and launches["mca_matmul_fixed"] == mca_calls
            == enc_want + dec_want > 0
            and not any(fallbacks.values())
            and all(launches[k] == 0 for k in ENTRY_ONLY)
            and _passes_together(launches) and launches["attn_lse"] > 0
            and red > 1.0):
        raise AssertionError(f"{arch}: non-finite logits, or kernel launches "
                             "or MCA accounting do not add up")
    again = _greedy(model, params, batch, t0, steps, max_len, key=0)[0]
    if not np.array_equal(again, toks):
        raise AssertionError(f"{arch}: two runs of the same inputs gave "
                             "different tokens")
    step_s = np.asarray(times["step_s"])
    nums = {"params": n_params, "prefill_s": times["prefill_s"],
            "decode_step_p50_s": float(np.median(step_s)),
            "tokens_per_s": b * steps / float(step_s.sum()),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "flops_reduction": red, "mca_launches": mca_calls,
            "kv_launches": launches["kv_slot_update"]}
    nums["profile"] = _profile_encdec_vlm(model, params, batch, t0, max_len,
                                          f"[encdec-vlm] {arch} profile")
    nums["seconds"] = time.perf_counter() - t_phase
    log(f"[encdec-vlm] {arch}: " + json.dumps(nums)
        + "; two runs of the same inputs gave the same tokens")
    del params, model
    return launches, nums


def _decode_vs_forward(arch):
    """(c) ``arch`` at full width in f32 (TF32 off, MCA off, random
    weights from seed 1): prefill S - 1 tokens and decode the last; its
    logits against the forward's last position, within 1e-4 of
    max|logit| (the reference's test_decode_matches_forward)."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.api import _logits
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch, dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(1))
    b, s = ENCDEC_VLM_DVF
    batch, t_end = _encdec_vlm_batch(cfg, b, s, 14, "cuda")
    pre = dict(batch, tokens=batch["tokens"][:, :-1])
    with torch.no_grad():
        cache, _, _ = model.prefill(params, pre, t_end + 8)
        got, _ = model.decode(params, batch["tokens"][:, -1:], cache,
                              torch.tensor(t_end - 1, dtype=torch.int32,
                                           device="cuda"))
        hid, _, _ = model.forward_hidden(params, batch)
        want = _logits(params, cfg, hid[:, -1:])
    got, want = got[..., :cfg.vocab_size], want[..., :cfg.vocab_size]
    err = _held(f"[encdec-vlm] {arch} f32 full width: decode of position "
                f"{t_end - 1} vs the forward's last logits", got, want,
                1e-4 * float(want.abs().max()))
    out = {"err": err, "max_logit": float(want.abs().max())}
    del params, model, cache
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_encdec_vlm():
    """Phase 12: the encoder-decoder and VLM families, after phase 11
    with nothing else resident: (a) reduced whisper-small and internvl2-1b,
    card against CPU; (b) both at full width with MCA on, one after the
    other; (c) full-width f32 decode against forward."""
    t0 = time.perf_counter()
    out = {"parity": {arch: _encdec_vlm_card_vs_cpu(arch)
                      for arch, _, _ in ENCDEC_VLM}}
    launches = {k: 0 for k in ALL_KERNELS}
    for arch, s, max_len in ENCDEC_VLM:
        got, out[arch] = _serve_encdec_vlm(arch, s, max_len)
        for k, v in got.items():
            launches[k] += v
    out["decode_vs_forward"] = {arch: _decode_vs_forward(arch)
                                for arch, _, _ in ENCDEC_VLM}
    out["phase_s"] = time.perf_counter() - t0
    log(f"[encdec-vlm] phase 12 passed in {out['phase_s']:.1f}s")
    return launches, out


# ------------------------------------------------------------ phase 10
class _BurstReads:
    """Counts the host's reads of CUDA tensors (``.cpu()``, ``.item()``,
    ``.tolist()``, ``int``/``float``/``bool`` of a tensor and
    ``torch.cuda.synchronize``) while installed: ``reads`` all of them,
    ``burst_reads`` those made inside ``engine.decode_burst``."""

    NAMES = ("cpu", "item", "tolist", "__int__", "__float__", "__bool__")

    def __init__(self, engine):
        self.engine = engine
        self.reads = self.burst_reads = self.bursts = 0
        self._in_burst = False

    def _note(self):
        self.reads += 1
        self.burst_reads += self._in_burst

    def __enter__(self):
        import torch
        self._saved = {n: (torch.Tensor.__dict__.get(n),
                           getattr(torch.Tensor, n)) for n in self.NAMES}
        for n, (_, fn) in self._saved.items():
            def counted(t, *a, _fn=fn, **k):
                if t.is_cuda:
                    self._note()
                return _fn(t, *a, **k)
            setattr(torch.Tensor, n, counted)
        self._sync = torch.cuda.synchronize

        def sync(*a, **k):
            self._note()
            return self._sync(*a, **k)
        torch.cuda.synchronize = sync
        inner = self.engine.decode_burst

        def burst(*a, **k):
            self.bursts += 1
            self._in_burst = True
            try:
                return inner(*a, **k)
            finally:
                self._in_burst = False
        self.engine.decode_burst = burst
        return self

    def __exit__(self, *exc):
        import torch
        for n, (own, _) in self._saved.items():
            if own is None:
                delattr(torch.Tensor, n)
            else:
                setattr(torch.Tensor, n, own)
        torch.cuda.synchronize = self._sync
        del self.engine.decode_burst


def _slot_pass(engine, tel_on):
    """Phase 5's SlotBatcher pass (its 8 requests, prompts 16..200, 32 new
    tokens, bursts of 8) with devtel on or off: the snapshot, launch
    counts, tokens of every prefill and the host's reads."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.obs import devtel
    from repro_torch.serve import Request, SlotBatcher
    cfg = engine.model.cfg
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i, prompt=rng.integers(1, cfg.vocab_size,
                                               int(rng.integers(16, 201))),
                    max_new=32) for i in range(8)]
    routed = []
    inner = engine._prefill

    def prefill(batch_in, mca_on):
        routed.append(int(batch_in["tokens"].numel()))
        return inner(batch_in, mca_on)

    engine._prefill = prefill
    try:
        with obs.scoped() as reg, devtel.enabled_scope(tel_on):
            sb = SlotBatcher(engine, check_every=8)
            for r in reqs:
                sb.submit(r)
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            with _BurstReads(engine) as reads:
                sb.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ops.launch_counts()
            snap = reg.snapshot()
    finally:
        engine._prefill = inner
    _check_requests(f"SlotBatcher (devtel {'on' if tel_on else 'off'})",
                    reqs, cfg.vocab_size, 32)
    return dict(snap=snap, launches=launches, routed=routed, wall=wall,
                reads=reads.reads, burst_reads=reads.burst_reads,
                bursts=reads.bursts)


def _check_devtel_pass(cfg, run):
    """The device counts of a devtel-on pass against the host's and the
    routing's."""
    c, n = run["snap"]["counters"], run["launches"]
    steps = run["snap"]["histograms"]["serve.decode_step_seconds"][
        "count"] * 8
    kv = c.get("kernels.kv_slot_update.device_launches", 0)
    rows = c.get("kernels.kv_slot_update.device_rows_written", 0)
    mca = c.get("kernels.mca_matmul.device_launches", 0)
    blocks = c.get("kernels.mca_matmul.device_sampled_blocks", 0)
    want_launch, want_blocks = _expected_mca(cfg, run["routed"])
    hist = sum(v for k, v in c.items()
               if k.startswith("mca.device_tier_hist.t"))
    occ = sum(v for k, v in c.items()
              if k.startswith("serve.tier_occupancy.t"))
    log(f"[devtel] SlotBatcher: {steps} decode steps; kv_slot_update "
        f"device_launches {kv} (2 x {cfg.n_layers} layers x steps = "
        f"{2 * cfg.n_layers * steps}; launch_counts {n['kv_slot_update']}), "
        f"device_rows_written {rows}; mca_matmul device_launches {mca} "
        f"(kernel_calls {c.get('kernels.mca_matmul.kernel_calls', 0)}, "
        f"launch_counts {n['mca_matmul_fixed']}, routing {want_launch}), "
        f"device_sampled_blocks {blocks} (routing {want_blocks}); "
        f"device_tier_hist sum {hist} (tier_occupancy {occ})")
    if not (kv == 2 * cfg.n_layers * steps == 2 * n["kv_slot_update"]
            and rows == 4 * kv
            and mca == c.get("kernels.mca_matmul.kernel_calls", -1)
            == n["mca_matmul_fixed"] == want_launch
            and blocks == want_blocks and hist == occ > 0):
        raise AssertionError("device telemetry of the serve path does not "
                             "match the host's counts and the routing")


def _tel_kernel_times():
    """Each phase-7 timed kernel through its launcher with the telemetry
    buffer off and on, in turns (off, on, on, off): its own device time
    (profiler, one trace of 20 calls each) and the time per call (CUDA
    events, the buffer's zero fill included)."""
    import torch
    from repro_torch.kernels import cache_update
    from repro_torch.kernels.attn_colmax import attn_colmax
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mca_matmul import (mca_matmul_fixed,
                                                mca_matmul_ragged)
    x, w, idx, inv_rp = _mca_inputs(*MCA_TIMED, seed=100)
    m, d, f, r_tile, r_max = RAGGED_CASES[0]
    rx, rw, rt, ridx, rinv = _ragged_inputs(m, d, f, r_tile, r_max, seed=300)
    b, hq, hkv, sq, skv, dh, causal, dtn = ATTN_TIMED
    q, k, v = _attn_inputs(b, hq, hkv, sq, skv, dh, getattr(torch, dtn),
                           seed=200)
    kw = dict(scale=dh ** -0.5, causal=causal)
    _, lse = flash_attention(q, k, v, **kw)
    g = torch.Generator(device="cuda").manual_seed(11)
    kc, vc, kn, vn, spos, t = _layer_inputs(g)
    calls = {
        "mca_matmul_fixed": (MCA_KERNEL, lambda tel: mca_matmul_fixed(
            x, w, idx, inv_rp, block=128, telemetry=tel)),
        "mca_matmul_ragged": (MCA_KERNEL, lambda tel: mca_matmul_ragged(
            rx, rw, rt, ridx, rinv, block=128, telemetry=tel)),
        "flash_attention": (FLASH_KERNEL, lambda tel:
                            flash_attention(q, k, v, telemetry=tel, **kw)),
        "attn_colmax": ("colmax_bf16_kernel", lambda tel: attn_colmax(
            q, k, lse, telemetry=tel, **kw)),
        "kv_slot_update": ("kv_slot_update_kernel", lambda tel:
                           cache_update.kv_slot_update_layer(
                               kc, kn, vc, vn, spos, t, window=0,
                               telemetry=tel)),
    }
    out = {}
    turns = (False, True, True, False)
    for name, (kern, fn) in calls.items():
        per = [cuda_time_ms(functools.partial(fn, tel)) * 1e3
               for tel in turns]                    # warms both up too
        dev = [_device_us(functools.partial(fn, tel), kern) for tel in turns]
        out[name] = {"device_us_off": [dev[0], dev[3]],
                     "device_us_on": [dev[1], dev[2]],
                     "per_call_us_off": [per[0], per[3]],
                     "per_call_us_on": [per[1], per[2]]}
        log(f"[devtel] {name} (telemetry off, on, on, off): device "
            + ", ".join(_us(x) for x in dev) + "; per call "
            + ", ".join(f"{x:.2f} us" for x in per))
    return out


def _burst_launches(engine):
    """Device launches of one 8-step decode burst with devtel on, under
    the profiler, set up as phase 6's (4 slots of 200-token prompts)."""
    import numpy as np
    from repro_torch.obs import devtel
    rng = np.random.default_rng(1)
    cfg = engine.model.cfg
    box = [engine.init_slot_state()]
    for slot in range(4):
        box[0], _, _ = engine.prefill_into(
            rng.integers(1, cfg.vocab_size, 200), box[0], slot, 32)

    def burst():
        box[0], _, _, _ = engine.decode_burst(box[0], 8)

    with devtel.enabled_scope():
        burst()                                     # warm up
        _, avgs = _profile(burst)
    return sum(e.count for e in _device_items(avgs))


def phase_devtel(engine):
    """Phase 10 (a), before phase 6 runs a profiler: device telemetry
    through the full-width serve path.  Phase 5's SlotBatcher pass four
    times, devtel off, on, on, off: with it on, the device counts equal
    the host's and the routing's (60 kv_slot_update device launches a
    decode step, MCA launches and blocks from the routing, the tier
    histogram the stats'), and the host reads inside the decode bursts
    are those with it off; decode step and prefill p50 of each run.  Then
    the entry chain of phase 5b with devtel on."""
    t0 = time.perf_counter()
    cfg = engine.model.cfg
    runs = [_slot_pass(engine, tel_on) for tel_on in (False, True, True,
                                                      False)]
    t_passes = time.perf_counter() - t0
    for run, tel_on in zip(runs, (False, True, True, False)):
        if tel_on:
            _check_devtel_pass(cfg, run)
    reads = {(r["reads"], r["burst_reads"], r["bursts"]) for r in runs}
    log(f"[devtel] host reads of device tensors (all, inside decode "
        f"bursts, bursts) per pass, off/on/on/off: "
        f"{[(r['reads'], r['burst_reads'], r['bursts']) for r in runs]}")
    if len(reads) != 1:
        raise AssertionError("devtel changed the host's reads of the "
                             "serve path")
    p50 = [(r["snap"]["histograms"]["serve.decode_step_seconds"]["p50"],
            r["snap"]["histograms"]["serve.prefill_seconds"]["p50"])
           for r in runs]
    log("[devtel] decode step p50 ms (off, on, on, off): "
        + ", ".join(f"{a * 1e3:.2f}" for a, _ in p50)
        + "; prefill p50 s: " + ", ".join(f"{b:.4f}" for _, b in p50))
    phase_entry(engine, tel=True)
    nums = {"decode_step_p50_s": [a for a, _ in p50],
            "prefill_p50_s": [b for _, b in p50],
            "reads_per_pass": runs[0]["reads"],
            "burst_reads": runs[0]["burst_reads"],
            "bursts": runs[0]["bursts"], "passes_s": t_passes,
            "phase_s": time.perf_counter() - t0}
    log(f"[devtel] phase 10 (a) passed in {nums['phase_s']:.1f}s (the four "
        f"passes {t_passes:.1f}s)")
    return nums


def phase_devtel_profiled(engine, prof_off, nums):
    """Phase 10 (b), after phase 6: one profiled decode burst with devtel
    on (launches beside phase 6's), and each timed kernel with its
    telemetry buffer on and off.  Adds to ``nums``."""
    t0 = time.perf_counter()
    launches = (prof_off["decode_burst_8"]["kernel_launches"],
                _burst_launches(engine))
    log(f"[devtel] device launches of an 8-step decode burst, devtel off "
        f"(phase 6) and on: {launches}; the port's kernels launch as often "
        "either way (launch_counts above)")
    nums["profile_launches"] = launches
    nums["kernels"] = _tel_kernel_times()
    nums["phase_s"] += time.perf_counter() - t0
    log(f"[devtel] phase 10 passed in {nums['phase_s']:.1f}s ((b) "
        f"{time.perf_counter() - t0:.1f}s)")


# ------------------------------------------------------------ phase 14
DIST_TRAIN_ARGS = ["--arch", "starcoder2-3b", "--steps", "2", "--mca",
                   "--alpha", "0.2"]  # the launcher's batch 8, seq 256
DIST_PROMPTS = (8, 256)          # global prompts: 4 x 256 tokens a rank
DIST_DECODE = 8                  # decode steps from the prefilled caches
DIST_MAX_LEN = 272
DIST_TRAIN_LAYERS = 4            # starcoder2-3b cut for two AdamW replicas
DIST_DIR = ROOT / "build" / "dist_smoke"


def _torchrun(nproc, part, timeout):
    """``python -m torch.distributed.run`` of this script's ``part`` on
    ``nproc`` ranks; each rank writes ``rank{r}.json`` under DIST_DIR.
    The whole process group is killed on a timeout."""
    import os
    import shutil
    import signal
    out = DIST_DIR / part
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="4")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", str(ROOT / "chip_smoke.py"),
           "--dist-part", part, "--out", str(out)]
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise AssertionError(f"phase 14 ({part}) passed its {timeout} s")
    for line in stdout.splitlines():
        log(line)
    if proc.returncode != 0:
        raise AssertionError(f"phase 14 ({part}) failed (rc "
                             f"{proc.returncode}):\n{stderr[-6000:]}")
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(nproc)]


def _recording(factory, gnorms):
    """``factory`` (a step maker) whose steps append their grad norm."""
    def make(*a, **kw):
        step = factory(*a, **kw)

        def rec(params, opt_state, batch):
            out = step(params, opt_state, batch)
            gnorms.append(float(out[2]["grad_norm"]))
            return out
        rec.__dict__.update(step.__dict__)
        return rec
    return make


def _dist_train_run(train, mesh):
    """One launcher run of DIST_TRAIN_ARGS: through the mesh branch
    (``run_mesh``, under torch.distributed.run) or the unsharded one
    (``build`` then ``run``, as phase 8).  Returns (numbers, the params
    copied to the host)."""
    import gc
    import torch
    from repro_torch import obs
    from repro_torch.optim.adamw import leaves
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gnorms = []
    maker = "jit_train_step" if mesh else "make_train_step"
    orig = getattr(train, maker)
    setattr(train, maker, _recording(orig, gnorms))
    try:
        with obs.scoped() as reg:
            if mesh:
                trainer, out = train.run_mesh(
                    train.parse_args(DIST_TRAIN_ARGS + ["--mesh"]))
            else:
                trainer = train.build(train.parse_args(DIST_TRAIN_ARGS))
                out = trainer.run()
            torch.cuda.synchronize()
            snap = reg.snapshot()
    finally:
        setattr(train, maker, orig)
    nums = {"losses": [h["loss"] for h in out["history"]],
            "grad_norms": gnorms,
            "tier_hist": [h.get("tier_hist") for h in out["history"]],
            "step_p50_s": snap["histograms"]["train.step_seconds"]["p50"],
            "step_s": [h["dt"] for h in out["history"]],
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "deterministic": torch.are_deterministic_algorithms_enabled()}
    params = [t.detach().cpu() for t in leaves(trainer.params)]
    del trainer
    return nums, params


def _dist_part_a(out):
    """(a) the launcher's mesh branch in a world of one (NCCL), then the
    unsharded launcher objects in the same process: equal bit for bit."""
    import os
    import torch
    from repro_torch.launch import train
    if int(os.environ["WORLD_SIZE"]) != 1:
        raise AssertionError("part a runs a world of one")
    mesh_nums, mesh_params = _dist_train_run(train, mesh=True)
    flat_nums, flat_params = _dist_train_run(train, mesh=False)
    same = [bool(torch.equal(a, b)) for a, b in zip(mesh_params,
                                                     flat_params)]
    del mesh_params
    # the launcher leaves deterministic algorithms off (PyTorch's default):
    # one more unsharded run with them on, for its bits and its cost
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        det_nums, det_params = _dist_train_run(train, mesh=False)
    finally:
        torch.use_deterministic_algorithms(False)
    det_same = sum(bool(torch.equal(a, b)) for a, b in zip(det_params,
                                                            flat_params))
    return {"mesh": mesh_nums, "unsharded": flat_nums,
            "leaves": len(same), "leaves_equal": sum(same),
            "det": det_nums, "det_leaves_equal": det_same}


def _dist_setup():
    """Both ranks on the one card, a gloo group (NCCL will not put two
    ranks on one GPU), the ("data", "model") = (2, 1) mesh."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo")
    return dist.get_rank(), make_local_mesh(2, 1, device=dev), dev


def _spy(module, name, record):
    """Replace ``module.name`` by a wrapper that appends (args, kwargs,
    result) to ``record``; returns a function that undoes it."""
    orig = getattr(module, name)

    def wrapper(*a, **kw):
        res = orig(*a, **kw)
        record.append((a, kw, res))
        return res
    setattr(module, name, wrapper)
    return lambda: setattr(module, name, orig)


def _call_counter(module, name):
    """Replace ``module.name`` by a wrapper that counts its calls and keeps
    no reference to their arguments or results (``_spy`` keeps both,
    which would hold every layer's activations); returns (the count, a
    one-element list, and a function that undoes it)."""
    orig = getattr(module, name)
    count = [0]

    def wrapper(*a, **kw):
        count[0] += 1
        return orig(*a, **kw)
    setattr(module, name, wrapper)
    return count, lambda: setattr(module, name, orig)


def _kernel_counters(snap):
    c = snap["counters"]
    return {k: v for k, v in c.items() if k.startswith("kernels.")}


def _dist_part_b(out):
    """(b) starcoder2-3b at full width on two ranks over gloo: the
    sharded prefill with the MCA kernel, then decode."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch, policy
    from repro_torch.core.policy import MCAConfig, _caps_for
    from repro_torch.dist import context as dctx
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.train.step import make_prefill_step
    rank, mesh, dev = _dist_setup()
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, use_kernel=True,
                    sites=("v_proj", "o_proj"))
    cfg = get_config("starcoder2-3b", mca=mca)
    model = build_model(cfg, device=dev)
    params = model.init(0)
    prompts = np.random.default_rng(14).integers(
        1, cfg.vocab_size, DIST_PROMPTS).astype(np.int32)
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    n_local = DIST_PROMPTS[0] // 2 * DIST_PROMPTS[1]
    calls = []
    undo = _spy(policy, "_tiered_maybe_sharded", calls)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad(), obs.scoped() as reg, _MCAShapes() as shapes, \
            dctx.use_mesh(mesh):
        cache, logits = make_prefill_step(model, DIST_MAX_LEN)(params,
                                                               batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        counters = _kernel_counters(reg.snapshot())
    undo()
    caps = _caps_for(n_local, cfg.mca.n_tiers, cfg.mca.capacity_fracs)
    local, summed, rerun_ok = [], [], True
    for a, _, (_, hist, local_hist) in calls:
        tier, imp = a[3], a[4]
        again = dispatch.tier_histogram(dispatch.apply_capacity(
            tier.cpu(), imp.cpu(), caps), len(caps))
        rerun_ok &= bool(torch.equal(again, local_hist.cpu()))
        local.append(local_hist.tolist())
        summed.append(hist.tolist())
    res = {"rank": rank, "prefill_s": prefill_s, "calls": len(calls),
           "n_local": n_local, "mca_launches": launches["mca_matmul_fixed"],
           "want_mca": _expected_mca(cfg, [n_local])[0],
           "counters": counters, "local_hist": local,
           "summed_hist": summed, "rerun_ok": rerun_ok,
           "shapes": sorted(shapes.seen)}
    # decode from the MCA prefill's caches: one layer write a layer a step
    tok = torch.argmax(logits[..., :cfg.vocab_size], -1).to(torch.int32)
    ops.reset_launch_counts()
    with torch.no_grad(), dctx.use_mesh(mesh):
        _, _, bad, _ = _decode_greedy(model, params, tok, cache,
                                      DIST_PROMPTS[1], DIST_DECODE)
        torch.cuda.synchronize()
    res["kv_launches"] = ops.launch_counts()["kv_slot_update"]
    res["decode_finite"] = not bool(bad)
    del cache
    # MCA off: this rank's rows, and (rank 0) all 8 rows in one process
    with torch.no_grad():
        with dctx.use_mesh(mesh):
            _, lg = make_prefill_step(model, DIST_MAX_LEN,
                                      with_mca=False)(params, batch)
        np.save(out / f"logits{rank}.npy", lg.float().cpu().numpy())
        if rank == 0:
            _, lg = make_prefill_step(model, DIST_MAX_LEN,
                                      with_mca=False)(params, batch)
            np.save(out / "logits_world1.npy", lg.float().cpu().numpy())
    if rank == 0:
        res["path_shapes_err"] = phase_path_shapes(shapes.seen)
    return res


def _digests(tree):
    """Two int64 digests a leaf of its raw bits (a plain sum and one
    weighted by position): equal leaves give equal digests."""
    import torch
    from repro_torch.optim.adamw import leaves
    out = []
    for t in leaves(tree):
        bits = t.detach().reshape(-1).view(torch.int16 if t.element_size()
                                           == 2 else torch.int32).long()
        pos = torch.arange(bits.numel(), device=t.device) % 65521 + 1
        out.append([int(bits.sum()), int((bits * pos).sum())])
    return out


def _dist_part_c(out):
    """(c) two ranks over gloo: olmoe-1b-7b's shard-local MoE dispatch,
    starcoder2-3b (4 layers) ZeRO-1 steps, psum_compressed."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.policy import MCAConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import compress, context as dctx
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, ffn
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    from repro_torch.train.step import jit_train_step, make_prefill_step
    rank, mesh, dev = _dist_setup()
    res = {"rank": rank}
    # --- olmoe-1b-7b at full width: MoE dispatch per rank
    t0 = time.perf_counter()
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, use_kernel=True,
                    sites=("v_proj", "o_proj", "expert_ffn"))
    cfg = get_config("olmoe-1b-7b", mca=mca)
    model = build_model(cfg, device=dev)
    params = model.init(0)
    prompts = np.random.default_rng(15).integers(
        1, cfg.vocab_size, DIST_PROMPTS).astype(np.int32)
    n_local = DIST_PROMPTS[0] // 2 * DIST_PROMPTS[1]
    local, reduced, caps = [], [], []
    undo = [_spy(ffn, "_moe_local", local), _spy(ffn, "moe_ffn", reduced),
            _spy(ffn, "moe_capacity", caps)]
    ops.reset_launch_counts()
    with torch.no_grad(), obs.scoped() as reg, _MCAShapes() as shapes, \
            dctx.use_mesh(mesh):
        make_prefill_step(model, DIST_MAX_LEN)(
            params, {"tokens": torch.as_tensor(prompts, device=dev)})
        torch.cuda.synchronize()
        counters = _kernel_counters(reg.snapshot())
    for u in undo:
        u()

    def stats(st):
        return {k: float(v) for k, v in st.items()}

    res["moe"] = {
        "layers": cfg.n_layers, "n_local": n_local,
        "tokens": [int(a[2].shape[0] * a[2].shape[1]) for a, _, _ in local],
        "caps": [[a[1], r] for a, _, r in caps],
        "want_cap": ffn.moe_capacity(cfg, n_local),
        "local_aux": [float(r[1]) for _, _, r in local],
        "local_stats": [stats(r[2]) for _, _, r in local],
        "aux": [float(r[1]) for _, _, r in reduced],
        "stats": [stats(r[2]) for _, _, r in reduced],
        "mca_launches": ops.launch_counts()["mca_matmul_fixed"],
        "want_mca": _expected_mca(cfg, [n_local])[0],
        "counters": counters, "s": time.perf_counter() - t0}
    # the spies' records hold the expert weights: drop them, or the
    # ZeRO-1 part's peak counts olmoe's 13.8 GB
    local.clear()
    reduced.clear()
    caps.clear()
    if rank == 0:
        res["path_shapes_err"] = phase_path_shapes(shapes.seen)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    # --- starcoder2-3b cut to 4 layers: 2 ZeRO-1 steps, MCA off
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("starcoder2-3b"),
                              n_layers=DIST_TRAIN_LAYERS)
    model = build_model(cfg, device=dev)
    data = SyntheticLM(cfg.vocab_size, DIST_PROMPTS[1], DIST_PROMPTS[0],
                       seed=0)
    opt = adamw.AdamWConfig(lr=3e-4, schedule=adamw.cosine_schedule(1, 2))
    b0 = {k: torch.empty(v.shape, dtype=torch.int32, device="meta")
          for k, v in data.batch(0).items()}
    step = jit_train_step(mesh, model, opt, b0, donate=False, fsdp=False)
    params = model.init(0)
    moment_sh = step.in_shardings[1]["m"]
    state = adamw.init_state(params, moment_sh)
    split = [[int(m.numel()), int(p.numel())] for p, m, sh in zip(
        adamw.leaves(params), adamw.leaves(state["m"]),
        adamw.leaves(moment_sh)) if sh.is_split()]
    losses, digests = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(2):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in data.batch(i).items()}
        params, state, m = step(params, state, batch)
        losses.append(float(m["total_loss"]))
        digests.append(_digests(params))
    res["zero1"] = {"losses": losses, "digests": digests, "split": split,
                    "leaves": len(adamw.leaves(params)),
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "s": time.perf_counter() - t0}
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:                # the world-one run of the same cut model
        flat = make_train_step(model, opt, with_mca=False)
        params = model.init(0)
        state = adamw.init_state(params)
        res["zero1"]["world1_losses"] = []
        for i in range(2):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in data.batch(i).items()}
            params, state, m = flat(params, state, batch)
            res["zero1"]["world1_losses"].append(float(m["total_loss"]))
        del params, state
    # --- psum_compressed on CUDA tensors
    g = torch.randn(4096, generator=torch.Generator(dev).manual_seed(
        100 + rank), device=dev) * 1e-3
    summed, _ = compress.psum_compressed(
        {"g": g}, compress.init_error_buffer({"g": g}), mesh)
    q, s = compress.quantize(g)
    np.save(out / f"deq{rank}.npy", compress.dequantize(q, s).cpu().numpy())
    np.save(out / f"psum{rank}.npy", summed["g"].cpu().numpy())
    return res


def dist_part_main() -> int:
    """A rank of phase 14 (``--dist-part a|b|c --out DIR``), started by
    ``torch.distributed.run`` from ``phase_dist``."""
    import os
    sys.path.insert(0, str(ROOT / "src"))
    part = sys.argv[sys.argv.index("--dist-part") + 1]
    out = pathlib.Path(sys.argv[sys.argv.index("--out") + 1])
    rank = int(os.environ["RANK"])
    res = {"a": _dist_part_a, "b": _dist_part_b, "c": _dist_part_c,
           "tp-serve": _tp_part_serve, "tp-train": _tp_part_train,
           "tp-families": _tp16_part, "sp": _sp_part,
           "mesh-2d": _mesh2d_part}[part](out)
    (out / f"rank{rank}.json").write_text(json.dumps(res))
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def _dist_check_a(r):
    m, u = r["mesh"], r["unsharded"]
    log(f"[dist] (a) world of one, NCCL, launch.train's mesh branch vs the "
        f"unsharded launcher objects, starcoder2-3b full width, 2 steps, "
        f"deterministic {m['deterministic']}/{u['deterministic']}: losses "
        f"{m['losses']} / {u['losses']}, grad norms {m['grad_norms']} / "
        f"{u['grad_norms']}, {r['leaves_equal']} of {r['leaves']} leaves "
        f"bitwise equal; step p50 {m['step_p50_s']:.3f} / "
        f"{u['step_p50_s']:.3f} s (steps {m['step_s']} / {u['step_s']}), "
        f"peak {m['peak_mem_gb']:.2f} / {u['peak_mem_gb']:.2f} GB")
    d = r["det"]
    log(f"[dist] (a) the unsharded run again with deterministic algorithms "
        f"on (the launcher leaves them off): losses {d['losses']}, "
        f"{r['det_leaves_equal']} of {r['leaves']} leaves bitwise equal to "
        f"the run with them off; step p50 {d['step_p50_s']:.3f} s (steps "
        f"{d['step_s']}), peak {d['peak_mem_gb']:.2f} GB")
    if (m["losses"] != u["losses"] or m["grad_norms"] != u["grad_norms"]
            or m["tier_hist"] != u["tier_hist"] or len(m["losses"]) != 2
            or r["leaves_equal"] != r["leaves"] or r["leaves"] < 100):
        raise AssertionError("the world of one is not the unsharded run "
                             "bit for bit")


def _dist_check_b(ranks):
    import numpy as np
    summed = np.array(ranks[0]["local_hist"]) + np.array(
        ranks[1]["local_hist"])
    for r in ranks:
        fallback = {k: v for k, v in r["counters"].items()
                    if k.endswith("fallback_calls") and v}
        log(f"[dist] (b) rank {r['rank']}: prefill of 4 x 256 tokens in "
            f"{r['prefill_s']:.3f} s, {r['calls']} routings of "
            f"{r['n_local']} local tokens, mca_matmul_fixed launches "
            f"{r['mca_launches']} (the local routing's {r['want_mca']}), "
            f"fallbacks {fallback or 0}, local tier_hist (sum) "
            f"{np.array(r['local_hist']).sum(0).tolist()}, the CPU rerun of "
            f"apply_capacity {'equal' if r['rerun_ok'] else 'DIFFERENT'}; "
            f"{DIST_DECODE} decode steps: kv_slot_update {r['kv_launches']}"
            f" launches, logits finite {r['decode_finite']}")
        if (r["mca_launches"] != r["want_mca"] or r["want_mca"] == 0
                or fallback or not r["rerun_ok"] or r["calls"] != 60
                or not np.array_equal(np.array(r["summed_hist"]), summed)
                or r["kv_launches"] != 30 * DIST_DECODE
                or not r["decode_finite"]):
            raise AssertionError(f"phase 14 (b) rank {r['rank']} failed")
    out = DIST_DIR / "b"
    world1 = np.load(out / "logits_world1.npy")
    rows = np.concatenate([np.load(out / f"logits{r}.npy") for r in (0, 1)])
    err = float(np.abs(rows - world1).max() / np.abs(world1).max())
    log(f"[dist] (b) MCA off: each rank's last-position logits against a "
        f"world-one prefill of the 8 rows, max|diff|/max|logit| {err:.2e} "
        f"(limit 1e-2); all-reduced tier_hist = the sum of the two ranks' "
        f"local ones in all {len(summed)} routings")
    if not err <= 1e-2:
        raise AssertionError("sharded logits differ from the world of one")
    return err


def _dist_check_c(ranks):
    import numpy as np
    f32 = np.float32
    moe = [r["moe"] for r in ranks]
    aux_ok = stats_ok = True
    for i in range(moe[0]["layers"]):
        a0, a1 = f32(moe[0]["local_aux"][i]), f32(moe[1]["local_aux"][i])
        want = (a0 + a1) / f32(2)
        aux_ok &= all(f32(m["aux"][i]) == want for m in moe)
        for k in moe[0]["stats"][i]:
            s = f32(moe[0]["local_stats"][i][k]) + f32(
                moe[1]["local_stats"][i][k])
            stats_ok &= all(f32(m["stats"][i][k]) == s for m in moe)
    for m, r in zip(moe, ranks):
        fallback = {k: v for k, v in m["counters"].items()
                    if k.endswith("fallback_calls") and v}
        caps_ok = all(n == m["n_local"] and c == m["want_cap"]
                      for n, c in m["caps"])
        log(f"[dist] (c) rank {r['rank']} olmoe-1b-7b: {len(m['caps'])} "
            f"dispatches of {set(m['tokens'])} local tokens, capacity "
            f"{sorted({c for _, c in m['caps']})} (moe_capacity of "
            f"{m['n_local']}: {m['want_cap']}), mca_matmul_fixed "
            f"{m['mca_launches']} (routing {m['want_mca']}), fallbacks "
            f"{fallback or 0}; {m['s']:.1f} s")
        if (not caps_ok or len(m["caps"]) != m["layers"]
                or m["mca_launches"] != m["want_mca"] or fallback):
            raise AssertionError(f"phase 14 (c) MoE rank {r['rank']}")
    log(f"[dist] (c) aux = the mean of the ranks' local auxes: {aux_ok}; "
        f"stats = their sums: {stats_ok} (f32, bit for bit)")
    z = [r["zero1"] for r in ranks]
    same = z[0]["digests"] == z[1]["digests"]
    halves = all(2 * m == p for m, p in z[0]["split"] + z[1]["split"])
    w1 = z[0]["world1_losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(z[0]["losses"], w1))
    log(f"[dist] (c) starcoder2-3b ({DIST_TRAIN_LAYERS} layers) ZeRO-1, 2 "
        f"steps of 8 x 256: losses {z[0]['losses']} / {z[1]['losses']}, "
        f"world of one {w1} (max rel {rel:.2e}, limit 1e-2); params "
        f"bitwise equal across ranks after each step: {same}; "
        f"{len(z[0]['split'])} of {z[0]['leaves']} moments split, each "
        f"rank holding half: {halves}; peak {z[0]['peak_mem_gb']:.2f} GB a "
        f"rank; {z[0]['s']:.1f} s")
    out = DIST_DIR / "c"
    deq = np.load(out / "deq0.npy") + np.load(out / "deq1.npy")
    psum_ok = all(np.load(out / f"psum{r}.npy").tobytes() == deq.tobytes()
                  for r in (0, 1))
    log(f"[dist] (c) psum_compressed on CUDA tensors = the sum of the two "
        f"ranks' dequantized payloads, bitwise: {psum_ok}")
    if (not (aux_ok and stats_ok and same and halves and psum_ok)
            or not rel <= 1e-2 or not z[0]["split"]
            or z[0]["losses"] != z[1]["losses"]):
        raise AssertionError("phase 14 (c) failed")
    return {"zero1_loss_rel": rel}


def phase_dist():
    """Phase 14: the distribution slice, in subprocesses (nothing else
    resident): (a) a world of one through launch.train's mesh branch,
    (b) two ranks' sharded serve path with the MCA kernel, (c) two ranks'
    MoE dispatch, ZeRO-1 steps and psum_compressed.  Returns (main-path
    launches, the max error of the shapes held, numbers)."""
    import gc
    import shutil
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    a = _torchrun(1, "a", 300)[0]
    _dist_check_a(a)
    b = _torchrun(2, "b", 300)
    logits_err = _dist_check_b(b)
    c = _torchrun(2, "c", 300)
    c_nums = _dist_check_c(c)
    PHASE14.update(b=b, c=c)
    launches = {
        "mca_matmul_fixed": sum(r["mca_launches"] for r in b)
        + sum(r["moe"]["mca_launches"] for r in c),
        "kv_slot_update": sum(r["kv_launches"] for r in b)}
    err = max(b[0]["path_shapes_err"], c[0]["path_shapes_err"])
    nums = {"a": a, "b_logits_err": logits_err,
            "b_prefill_s": [r["prefill_s"] for r in b], **c_nums,
            "zero1_peak_gb": c[0]["zero1"]["peak_mem_gb"],
            "phase_s": time.perf_counter() - t0}
    log(f"[dist] phase 14 in {nums['phase_s']:.1f}s; main-path launches "
        f"{launches}")
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    return launches, err, nums


# ------------------------------------------------------------ phase 15
TP_TRAIN_ROWS = (4, 128)         # (d): f32 steps, 2 chunks of 4 x 128 / 2
PHASE14 = {}                     # phase 14's (2, 1) results, for phase 15


def _tp_setup(n_data, n_model):
    """The ranks on the one card over gloo (two, or four for phase 18),
    the ("data", "model") mesh of (n_data, n_model); each rank's number
    and device."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("gloo")
    return dist.get_rank(), make_local_mesh(n_data, n_model, device=dev), dev


def _shard_on_card(model, mesh, dev, batch_rows):
    """(this rank's params under ``serve_step_shardings``, the cache
    placements, the abstract cache): the full weights drawn from seed 0
    and dropped once the rank's shards are taken."""
    import gc
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.train.step import serve_step_shardings
    a_cache = model.init_cache(batch_rows, DIST_MAX_LEN)
    full = model.init(0)
    p_sh, c_sh, _ = serve_step_shardings(
        mesh, model, a_cache, torch.empty((batch_rows, 1), device="meta"))
    params = shd.shard_params(full, p_sh)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    return params, c_sh, a_cache


def _tp_serve_a(out, rank, mesh, dev):
    """(a) starcoder2-3b at full width on (1, 2): the MCA kernel on each
    rank's head shard through make_prefill_step, 8 decode steps through
    each rank's KV heads, then the MCA-off f32 forward."""
    import gc
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core import policy
    from repro_torch.core.policy import MCAConfig
    from repro_torch.dist import context as dctx
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.train.step import make_prefill_step
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, use_kernel=True,
                    sites=("v_proj", "o_proj"))
    cfg = get_config("starcoder2-3b", mca=mca)
    model = build_model(cfg, device=dev)
    b = DIST_PROMPTS[0]
    params, c_sh, a_cache = _shard_on_card(model, mesh, dev, b)
    # phase 14 (b)'s prompts: its two ranks' rows are this mesh's chunks
    prompts = np.random.default_rng(14).integers(
        1, cfg.vocab_size, DIST_PROMPTS).astype(np.int32)
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}
    calls = []
    undo = _spy(policy, "_tiered_maybe_sharded", calls)
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.no_grad(), obs.scoped() as reg, _MCAShapes() as shapes, \
            dctx.use_mesh(mesh):
        cache, logits = make_prefill_step(model, DIST_MAX_LEN)(params,
                                                               batch)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        counters = _kernel_counters(reg.snapshot())
    undo()
    chunk = b // 2 * DIST_PROMPTS[1]
    res = {"rank": rank, "prefill_s": prefill_s, "calls": len(calls),
           "hists": [h.tolist() for _, _, (_, h, _) in calls],
           "mca_launches": launches["mca_matmul_fixed"],
           "want_mca": 2 * _expected_mca(cfg, [chunk])[0],
           "counters": counters, "shapes": sorted(shapes.seen),
           "cache_ok": all(tuple(cache["layers"][k].shape)
                           == c_sh["layers"][k].local_shape(
                               a_cache["layers"][k].shape)
                           for k in ("k", "v")),
           "kv_heads": int(cache["layers"]["k"].shape[-2])}
    tok = torch.argmax(logits[..., :cfg.vocab_size], -1).to(torch.int32)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad(), dctx.use_mesh(mesh):
        _, _, bad, _ = _decode_greedy(model, params, tok, cache,
                                      DIST_PROMPTS[1], DIST_DECODE)
        torch.cuda.synchronize()
    res["decode_s"] = time.perf_counter() - t0
    res["kv_launches"] = ops.launch_counts()["kv_slot_update"]
    res["decode_finite"] = not bool(bad)
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if rank == 0:
        res["path_shapes_err"] = phase_path_shapes(shapes.seen)
    del cache, params, model
    gc.collect()
    torch.cuda.empty_cache()
    # MCA off in f32 with TF32 off: the ranks' forward against one rank's
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = get_config("starcoder2-3b", dtype="float32")
    model = build_model(cfg32, device=dev)
    params, _, _ = _shard_on_card(model, mesh, dev, b)
    with torch.no_grad():
        with dctx.use_mesh(mesh):
            _, lg = make_prefill_step(model, DIST_MAX_LEN,
                                      with_mca=False)(params, batch)
        del params
        np.save(out / f"f32_{rank}.npy", lg.cpu().numpy())
        if rank == 0:
            full = model.init(0)
            _, lg = make_prefill_step(model, DIST_MAX_LEN,
                                      with_mca=False)(full, batch)
            np.save(out / "f32_world1.npy", lg.cpu().numpy())
            del full
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _tp_serve_b(out, rank, mesh, dev):
    """(b) olmoe-1b-7b at full width on (1, 2): a prefill of 4 x 256
    whose sequence splits over "model", each piece dispatched with its
    own capacity; the MCA kernel on v_proj and o_proj."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import MCAConfig
    from repro_torch.dist import context as dctx
    from repro_torch.kernels import ops
    from repro_torch.models import build_model, ffn
    from repro_torch.train.step import make_prefill_step
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, use_kernel=True,
                    sites=("v_proj", "o_proj"))
    cfg = get_config("olmoe-1b-7b", mca=mca)
    model = build_model(cfg, device=dev)
    rows = DIST_PROMPTS[0] // 2
    params, _, _ = _shard_on_card(model, mesh, dev, rows)
    prompts = np.random.default_rng(15).integers(
        1, cfg.vocab_size, (rows, DIST_PROMPTS[1])).astype(np.int32)
    local, reduced_, caps = [], [], []
    undo = [_spy(ffn, "_moe_local", local), _spy(ffn, "moe_ffn", reduced_),
            _spy(ffn, "moe_capacity", caps)]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad(), dctx.use_mesh(mesh):
        make_prefill_step(model, DIST_MAX_LEN)(
            params, {"tokens": torch.as_tensor(prompts, device=dev)})
        torch.cuda.synchronize()
    for u in undo:
        u()
    piece = rows * DIST_PROMPTS[1] // 2
    res = {"layers": cfg.n_layers, "piece": piece,
           "tokens": sorted({int(a[2].shape[0] * a[2].shape[1])
                             for a, _, _ in local}),
           "caps": sorted({(a[1], r) for a, _, r in caps}),
           "want_cap": ffn.moe_capacity(cfg, piece),
           "aux": [float(r[1]) for _, _, r in reduced_],
           "stats": [{k: float(v) for k, v in r[2].items()}
                     for _, _, r in reduced_],
           "mca_launches": ops.launch_counts()["mca_matmul_fixed"],
           "want_mca": 2 * _expected_mca(cfg, [piece])[0],
           "s": time.perf_counter() - t0}
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _tp_part_serve(out):
    """Phase 15 (a) and (b), two ranks on (1, 2)."""
    rank, mesh, dev = _tp_setup(1, 2)
    res = {"rank": rank, "a": _tp_serve_a(out, rank, mesh, dev)}
    res["b"] = _tp_serve_b(out, rank, mesh, dev)
    return res


def _train_steps_on(mesh, model, data, n, fsdp, opt, mca_off=True):
    """``n`` steps of ``jit_train_step`` over ``mesh`` from seed-0 weights:
    (losses, grad norms, digests of the gathered params each step, this
    rank's peak GB, the numel it holds)."""
    import gc
    import torch
    from repro_torch.dist import context as dctx
    from repro_torch.dist import sharding as shd
    from repro_torch.optim import adamw
    from repro_torch.train.step import jit_train_step
    dev = mesh.device
    b0 = {k: torch.empty(v.shape, dtype=torch.int32, device="meta")
          for k, v in data.batch(0).items()}
    step = jit_train_step(mesh, model, opt, b0, donate=False, fsdp=fsdp)
    p_sh = step.in_shardings[0]
    full = model.init(0)
    params = shd.shard_params(full, p_sh)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    state = adamw.init_state(params, step.in_shardings[1]["m"], p_sh)
    held = sum(int(t.numel()) for t in adamw.leaves(params))
    losses, gnorms, digests, peak, step_s = [], [], [], 0.0, []
    with dctx.use_mesh(mesh):
        for i in range(n):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in data.batch(i).items()}
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            losses.append(float(m["total_loss"]))
            gnorms.append(float(m["grad_norm"]))
            step_s.append(time.perf_counter() - t0)
            # the step's own peak, before the digests gather the params
            peak = max(peak, torch.cuda.max_memory_allocated() / 1e9)
            digests.append(_digests(shd.gather_params(params, p_sh)))
    out = {"losses": losses, "gnorms": gnorms, "digests": digests,
           "peak_mem_gb": peak, "held": held, "step_s": step_s,
           "s": sum(step_s)}
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tp_part_train(out):
    """Phase 15 (c) FSDP against ZeRO-1 on (2, 1), bf16; (d) TP training
    on (1, 2) in f32 against (2, 1) ZeRO-1 (MCA on v_proj, the plain
    sampled product) and, MCA off, against a world of one."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import MCAConfig
    from repro_torch.data import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    rank, dp_mesh, dev = _tp_setup(2, 1)
    _, tp_mesh, _ = _tp_setup(1, 2)
    opt = adamw.AdamWConfig(lr=3e-4, schedule=adamw.cosine_schedule(1, 2))
    res = {"rank": rank}
    cfg = dataclasses.replace(get_config("starcoder2-3b"),
                              n_layers=DIST_TRAIN_LAYERS)
    model = build_model(cfg, device=dev)
    data = SyntheticLM(cfg.vocab_size, DIST_PROMPTS[1], DIST_PROMPTS[0],
                       seed=0)
    res["c"] = {tag: _train_steps_on(dp_mesh, model, data, 2, fsdp, opt)
                for tag, fsdp in (("zero1", False), ("fsdp", True))}
    # (d) f32, TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = SyntheticLM(cfg.vocab_size, TP_TRAIN_ROWS[1], TP_TRAIN_ROWS[0],
                       seed=1)
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, sites=("v_proj",))
    d = {}
    for tag, mca_cfg in (("mca", mca), ("off", MCAConfig())):
        m32 = build_model(dataclasses.replace(cfg, dtype="float32",
                                              mca=mca_cfg), device=dev)
        d["tp_" + tag] = _train_steps_on(tp_mesh, m32, data, 2, True, opt)
        if tag == "mca":
            d["dp_mca"] = _train_steps_on(dp_mesh, m32, data, 2, False, opt)
        elif rank == 0:              # a world of one, the same steps
            flat = make_train_step(m32, opt, with_mca=False)
            params = m32.init(0)
            state = adamw.init_state(params)
            d["world1"] = {"losses": [], "gnorms": []}
            for i in range(2):
                batch = {k: torch.as_tensor(v, device=dev)
                         for k, v in data.batch(i).items()}
                params, state, m = flat(params, state, batch)
                d["world1"]["losses"].append(float(m["total_loss"]))
                d["world1"]["gnorms"].append(float(m["grad_norm"]))
            del params, state
    for v in d.values():
        v.pop("digests", None)
    res["d"] = d
    return res


def _rel(a, b):
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def _tp_check_serve(ranks):
    """Phase 15 (a), (b): the checks and their lines."""
    import numpy as np
    b14 = PHASE14["b"][0]["summed_hist"]
    worst = 0
    for r in ranks:
        a = r["a"]
        fallback = {k: v for k, v in a["counters"].items()
                    if k.endswith("fallback_calls") and v}
        diffs = [int(np.abs(np.array(h) - np.array(w)).sum())
                 for h, w in zip(a["hists"], b14)]
        worst = max(worst, max(diffs))
        log(f"[tp] (a) rank {r['rank']} starcoder2-3b (1, 2): prefill of "
            f"8 x 256 tokens in {a['prefill_s']:.3f} s, {a['calls']} "
            f"routings, mca_matmul_fixed {a['mca_launches']} launches "
            f"(predicted {a['want_mca']}: two chunks of 4 x 256 a rank), "
            f"fallbacks {fallback or 0}; the cache holds {a['kv_heads']} "
            f"KV head a rank (cache_shardings' block: {a['cache_ok']}); "
            f"{DIST_DECODE} decode steps in {a['decode_s']:.3f} s: "
            f"kv_slot_update {a['kv_launches']} launches (predicted "
            f"{30 * DIST_DECODE}), logits finite {a['decode_finite']}; "
            f"peak {a['peak_mem_gb']:.2f} GB")
        log(f"[tp] (a) rank {r['rank']}: layer 0's tier_hist (v_proj, "
            f"o_proj) {a['hists'][:2]} / phase 14 (b)'s (2, 1) {b14[:2]}; "
            f"every routing's summed |difference| {diffs}")
        if (a["mca_launches"] != a["want_mca"] or fallback
                or a["calls"] != 60 or a["hists"][:2] != b14[:2]
                or a["kv_launches"] != 30 * DIST_DECODE
                or not a["decode_finite"] or not a["cache_ok"]
                or a["kv_heads"] != 1):
            raise AssertionError(f"phase 15 (a) rank {r['rank']} failed")
    out = DIST_DIR / "tp-serve"
    world1 = np.load(out / "f32_world1.npy")
    errs = [float(np.abs(np.load(out / f"f32_{r}.npy") - world1).max()
                  / np.abs(world1).max()) for r in (0, 1)]
    log(f"[tp] (a) MCA off, f32, TF32 off: each rank's logits against a "
        f"world of one, max|diff|/max|logit| {errs} (limit 1e-4)")
    if not max(errs) <= 1e-4:
        raise AssertionError("phase 15 (a): TP logits differ from one rank")
    c14 = PHASE14["c"][0]["moe"]
    for r in ranks:
        m = r["b"]
        caps_ok = m["caps"][:1] == [[m["piece"], m["want_cap"]]]
        log(f"[tp] (b) rank {r['rank']} olmoe-1b-7b (1, 2), 4 x 256: "
            f"{len(m['aux'])} MoE layers, pieces of {m['tokens']} tokens, "
            f"(tokens, capacity) {m['caps']} (moe_capacity of "
            f"{m['piece']}: {m['want_cap']}; phase 14 (c)'s (2, 1): "
            f"{c14['want_cap']} for {c14['n_local']}), mca_matmul_fixed "
            f"{m['mca_launches']} (predicted {m['want_mca']}); layer 0 aux "
            f"{m['aux'][0]:.6f} (phase 14 (c) {c14['aux'][0]:.6f}), stats "
            f"{m['stats'][0]} (phase 14 (c) {c14['stats'][0]}); "
            f"{m['s']:.1f} s")
        if (not caps_ok or m["tokens"] != [m["piece"]]
                or len(m["aux"]) != m["layers"]
                or m["mca_launches"] != m["want_mca"]):
            raise AssertionError(f"phase 15 (b) rank {r['rank']} failed")
    if ranks[0]["b"]["aux"] != ranks[1]["b"]["aux"]:
        raise AssertionError("phase 15 (b): the model ranks' aux differ")
    return {"a_logits_f32_err": max(errs), "a_hist_worst_diff": worst}


def _tp_check_train(ranks):
    """Phase 15 (c), (d): the checks and their lines."""
    z, f = ranks[0]["c"]["zero1"], ranks[0]["c"]["fsdp"]
    same = all(r["c"]["zero1"]["losses"] == r["c"]["fsdp"]["losses"]
               and r["c"]["zero1"]["gnorms"] == r["c"]["fsdp"]["gnorms"]
               and r["c"]["zero1"]["digests"] == r["c"]["fsdp"]["digests"]
               for r in ranks)
    ranks_same = ranks[0]["c"]["fsdp"]["digests"] == \
        ranks[1]["c"]["fsdp"]["digests"]
    log(f"[tp] (c) starcoder2-3b ({DIST_TRAIN_LAYERS} layers) on (2, 1), "
        f"bf16, 8 x 256: ZeRO-1 losses {z['losses']} grad norms "
        f"{z['gnorms']}; FSDP losses {f['losses']} grad norms "
        f"{f['gnorms']}; every param bitwise equal after each step: {same}"
        f", across ranks: {ranks_same}; a rank holds {z['held']} / "
        f"{f['held']} param elements; peak {z['peak_mem_gb']:.2f} / "
        f"{f['peak_mem_gb']:.2f} GB a rank (ZeRO-1 / FSDP); "
        f"{z['s']:.1f} / {f['s']:.1f} s")
    if not (same and ranks_same and f["peak_mem_gb"] < z["peak_mem_gb"]
            and 2 * f["held"] <= z["held"] + 2):
        raise AssertionError("phase 15 (c) failed")
    d = ranks[0]["d"]
    rel_mca = max(_rel(d["tp_mca"]["losses"], d["dp_mca"]["losses"]),
                  _rel(d["tp_mca"]["gnorms"], d["dp_mca"]["gnorms"]))
    rel_off = max(_rel(d["tp_off"]["losses"], d["world1"]["losses"]),
                  _rel(d["tp_off"]["gnorms"], d["world1"]["gnorms"]))
    log(f"[tp] (d) f32, TF32 off, 4 x 128: MCA on v_proj, (1, 2) losses "
        f"{d['tp_mca']['losses']} grad norms {d['tp_mca']['gnorms']} vs "
        f"(2, 1) ZeRO-1 {d['dp_mca']['losses']} {d['dp_mca']['gnorms']}: "
        f"max rel {rel_mca:.2e}; MCA off, (1, 2) {d['tp_off']['losses']} "
        f"{d['tp_off']['gnorms']} vs a world of one "
        f"{d['world1']['losses']} {d['world1']['gnorms']}: max rel "
        f"{rel_off:.2e} (limit 1e-5); peak (1, 2) "
        f"{d['tp_off']['peak_mem_gb']:.2f} GB a rank")
    if not (rel_mca <= 1e-5 and rel_off <= 1e-5):
        raise AssertionError("phase 15 (d) failed")
    return {"c_zero1_peak_gb": z["peak_mem_gb"],
            "c_fsdp_peak_gb": f["peak_mem_gb"],
            "c_zero1_s": z["s"], "c_fsdp_s": f["s"],
            "d_rel_mca": rel_mca, "d_rel_off": rel_off}


def phase_tp():
    """Phase 15: tensor parallelism and FSDP in subprocess ranks over gloo
    on the one card: (a) starcoder2-3b served on (1, 2), (b) olmoe-1b-7b's
    MoE pieces on (1, 2), (c) FSDP against ZeRO-1 on (2, 1), (d) TP
    training on (1, 2).  Returns (main-path launches, the max error of
    the shapes held, numbers)."""
    import gc
    import shutil
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serve = _torchrun(2, "tp-serve", 420)
    nums = _tp_check_serve(serve)
    train = _torchrun(2, "tp-train", 420)
    nums.update(_tp_check_train(train))
    launches = {
        "mca_matmul_fixed": sum(r["a"]["mca_launches"]
                                + r["b"]["mca_launches"] for r in serve),
        "kv_slot_update": sum(r["a"]["kv_launches"] for r in serve)}
    nums["a_prefill_s"] = [r["a"]["prefill_s"] for r in serve]
    nums["a_decode_s"] = [r["a"]["decode_s"] for r in serve]
    nums["a_peak_gb"] = [r["a"]["peak_mem_gb"] for r in serve]
    nums["phase_s"] = time.perf_counter() - t0
    log(f"[tp] phase 15 in {nums['phase_s']:.1f}s; main-path launches "
        f"{launches}")
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    return launches, serve[0]["a"]["path_shapes_err"], nums


# ------------------------------------------------------------ phase 16
TP16_ARCHS = ("minicpm3-4b", "mamba2-2.7b", "recurrentgemma-9b",
              "whisper-small", "internvl2-1b")
TP16_PROMPTS = (4, 256)          # (a): 4 prompts of 256 tokens
TP16_DECODE = 8
TP16_MAX_LEN = {"whisper-small": 320, "internvl2-1b": 576}   # else 272
TP16_LAYERS = 4                  # (b), (c): depth cut, full width, f32
TP16_SERVE_LAYERS = 8            # (a): depth cut, full width, bf16
TP16_PARITY = (4, 128)           # (b), (c): rows x tokens


def _tp16_batch(cfg, b, s, seed, dev):
    """Tokens [b, s] (with the family's frames or patches) from ``seed``,
    and the first decode position."""
    import numpy as np
    import torch
    if cfg.is_encoder_decoder or cfg.family == "vlm":
        return _encdec_vlm_batch(cfg, b, s, seed, dev)
    toks = np.random.default_rng(seed).integers(1, cfg.vocab_size, (b, s))
    return {"tokens": torch.as_tensor(toks.astype(np.int32),
                                      device=dev)}, s


def _tp16_expected(cfg, b, s):
    """(mca_matmul_fixed launches a rank in a prefill of ``b`` rows on (1,
    2), kv_slot_update launches a decode step): each rank routes the two
    chunks of half the rows, as (2, 1)'s two ranks would."""
    from repro_torch.models import stack
    if cfg.family == "ssm":
        return 0, 0
    if cfg.is_encoder_decoder or cfg.family == "vlm":
        enc, dec = _encdec_vlm_expected_mca(cfg, b // 2, s)
        return 2 * (enc + dec), cfg.n_layers
    kinds = stack.layer_kinds(cfg)
    return (2 * _expected_mca(cfg, [b // 2 * s])[0],
            sum(k.startswith("attn") for k in kinds))


def _tp16_shard(model, mesh, full):
    """This rank's tensor-parallel shards of ``full`` (the serve
    placements), and the share of the elements it holds."""
    import torch
    from repro_torch.dist import sharding as shd
    from repro_torch.train.step import serve_step_shardings
    p_sh = serve_step_shardings(mesh, model, {},
                                torch.empty((1, 1), device="meta"))[0]
    params = shd.shard_params(full, p_sh)
    share = (sum(t.numel() for t in _leaves(params))
             / sum(t.numel() for t in _leaves(full)))
    return params, share


def _cache_shapes(cache):
    out = {}
    for k, v in cache["layers"].items():
        if isinstance(v, dict):
            out.update({f"{k}.{n}": list(t.shape) for n, t in v.items()})
        else:
            out[k] = list(v.shape)
    return out


def _tp16_serve(rank, mesh, dev, arch):
    """(a) ``arch`` at full width (bf16, seed-0 weights, cut to
    TP16_SERVE_LAYERS layers) on (1, 2), MCA on v_proj and o_proj through
    the kernel: ``make_prefill_step`` of 4 x 256 tokens (whisper's
    frames, internvl's patches), then 8 greedy decode steps, each
    synchronised and timed."""
    import gc
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core.policy import MCAConfig
    from repro_torch.dist import context as dctx
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.train.step import make_prefill_step
    gc.collect()
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, use_kernel=True,
                    sites=("v_proj", "o_proj"))
    cfg = _tp16_cfg(arch, TP16_SERVE_LAYERS, "bfloat16", mca=mca)
    model = build_model(cfg, device=dev)
    b, s = TP16_PROMPTS
    batch, t0 = _tp16_batch(cfg, b, s, 16, dev)
    max_len = TP16_MAX_LEN.get(arch, DIST_MAX_LEN)
    full = model.init(0)
    params, share = _tp16_shard(model, mesh, full)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_start
    torch.cuda.reset_peak_memory_stats()        # the serving peak

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    with torch.no_grad(), obs.scoped() as reg, _MCAShapes() as shapes, \
            dctx.use_mesh(mesh):
        ops.reset_launch_counts()
        t1 = clock()
        cache, logits = make_prefill_step(model, max_len)(params, batch)
        prefill_s = clock() - t1
        pre = ops.launch_counts()
        ops.reset_launch_counts()
        tok = torch.argmax(logits[..., :cfg.vocab_size], -1).to(torch.int32)
        toks, _, bad, step_s = _decode_greedy(model, params, tok, cache,
                                              t0, TP16_DECODE, clock)
        dec = ops.launch_counts()
        counters = _kernel_counters(reg.snapshot())
    want_mca, kv_step = _tp16_expected(cfg, b, s)
    res = {"arch": arch, "rank": rank, "layers": cfg.n_layers,
           "share": share, "init_s": init_s,
           "prefill_s": prefill_s,
           "decode_p50_s": float(np.median(step_s)),
           "decode_s": float(np.sum(step_s)),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "mca_launches": pre["mca_matmul_fixed"], "want_mca": want_mca,
           "kv_launches": dec["kv_slot_update"],
           "want_kv": kv_step * TP16_DECODE,
           "entry_launches": sum(pre[k] + dec[k] for k in ENTRY_ONLY),
           "fallbacks": {k: v for k, v in counters.items()
                         if k.endswith("fallback_calls") and v},
           "finite": not bool(bad), "cache": _cache_shapes(cache),
           "tokens": torch.cat([tok] + toks, 1).cpu().tolist(),
           "shapes": sorted(shapes.seen)}
    del cache, params, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _tp16_cfg(arch, n_layers=TP16_LAYERS, dtype="float32", **kw):
    """``arch`` cut to ``n_layers`` layers (and as many encoder layers):
    in f32, (b) and (c)'s models; (a)'s at TP16_SERVE_LAYERS in bf16."""
    from repro_torch.configs import get_config
    cfg = get_config(arch, dtype=dtype, n_layers=n_layers, **kw)
    if cfg.is_encoder_decoder:
        cfg = cfg.replace(n_encoder_layers=n_layers)
    return cfg


def _tp16_parity(rank, tp_mesh, dp_mesh, dev, arch, out):
    """(b) ``arch`` at 4 layers, full width, f32 (TF32 off), 4 x 128: MCA
    off, each rank's last-position logits on (1, 2) and, on rank 0, a
    world of one's, saved for the check; MCA on v_proj and o_proj (the
    plain sampled product), every routing's tier_hist and the logits on
    (1, 2) and on (2, 1).  (c) 2 AdamW steps (MCA off) on (1, 2) through
    ``jit_train_step``, and on rank 0 a world of one's: losses and grad
    norms."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core import policy
    from repro_torch.core.policy import MCAConfig
    from repro_torch.dist import context as dctx
    from repro_torch.dist import sharding as shd
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    from repro_torch.train.step import jit_train_step, make_prefill_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    cfg = _tp16_cfg(arch)
    model = build_model(cfg, device=dev)
    b, s = TP16_PARITY
    batch, t0 = _tp16_batch(cfg, b, s, 17, dev)
    max_len = t0 + TP16_DECODE
    full = model.init(0)
    params, _ = _tp16_shard(model, tp_mesh, full)
    res = {"arch": arch, "rank": rank}
    tag = arch.split("-")[0]

    def save(name, lg):           # the real vocabulary (padding is -1e30)
        np.save(out / f"{tag}_{name}.npy",
                lg[..., :cfg.vocab_size].cpu().numpy())

    with torch.no_grad():
        with dctx.use_mesh(tp_mesh):
            _, lg = make_prefill_step(model, max_len, with_mca=False)(
                params, batch)
        save(f"off_{rank}", lg)
        if rank == 0:
            _, lg = make_prefill_step(model, max_len, with_mca=False)(
                full, batch)
            save("off_world1", lg)
    del lg
    if cfg.family != "ssm":
        mca = MCAConfig(enabled=True, alpha=0.2, block=128,
                        sites=("v_proj", "o_proj"))
        m_mca = build_model(cfg.replace(mca=mca), device=dev)
        for mtag, mesh, p in (("12", tp_mesh, params), ("21", dp_mesh, full)):
            calls = []
            undo = _spy(policy, "_tiered_maybe_sharded", calls)
            try:
                with torch.no_grad(), dctx.use_mesh(mesh):
                    _, lg = make_prefill_step(m_mca, max_len)(p, batch)
            finally:
                undo()
            res["hists" + mtag] = [r[1].tolist() for _, _, r in calls]
            save(f"mca{mtag}_{rank}", lg)
        del m_mca, lg
    res["b_s"] = time.perf_counter() - t_start
    # (c) two AdamW steps, MCA off
    t_c = time.perf_counter()
    opt = adamw.AdamWConfig(lr=3e-4, schedule=adamw.cosine_schedule(1, 2))
    batches = []
    for i in range(2):
        bi, _ = _tp16_batch(cfg, b, s, 18 + i, dev)
        labels = torch.roll(bi["tokens"], -1, 1)
        labels[:, -1] = -1
        batches.append(dict(bi, labels=labels))
    step = jit_train_step(tp_mesh, model, opt, batches[0], donate=False)
    p_sh = step.in_shardings[0]
    params = shd.shard_params(full, p_sh)
    if rank != 0:
        del full
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = adamw.init_state(params, step.in_shardings[1]["m"], p_sh)
    losses, gnorms = [], []
    with dctx.use_mesh(tp_mesh):
        for bi in batches:
            params, state, m = step(params, state, bi)
            losses.append(float(m["total_loss"]))
            gnorms.append(float(m["grad_norm"]))
    res["c"] = {"losses": losses, "gnorms": gnorms,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()                    # rank 1's state freed before rank 0's
    if rank == 0:                     # world of one, the same steps
        flat = make_train_step(model, opt, with_mca=False)
        state = adamw.init_state(full)
        losses, gnorms = [], []
        for bi in batches:
            full, state, m = flat(full, state, bi)
            losses.append(float(m["total_loss"]))
            gnorms.append(float(m["grad_norm"]))
        res["c"]["world1"] = {"losses": losses, "gnorms": gnorms}
        del full, state
    dist.barrier()
    res["c_s"] = time.perf_counter() - t_c
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _tp16_part(out):
    """Phase 16, two ranks on the card: each family's (a), (b) and (c)
    in turn, in this one launch; rank 0 then holds every mca_matmul_fixed
    shape (a) gave against the plain version."""
    rank, tp_mesh, dev = _tp_setup(1, 2)
    _, dp_mesh, _ = _tp_setup(2, 1)
    res = {"rank": rank, "a": {}, "b": {}}
    seen = set()
    for arch in TP16_ARCHS:
        res["a"][arch] = _tp16_serve(rank, tp_mesh, dev, arch)
        seen.update(map(tuple, res["a"][arch]["shapes"]))
        res["b"][arch] = _tp16_parity(rank, tp_mesh, dp_mesh, dev, arch, out)
        log(f"[tp-families] rank {rank} {arch} done")
    if rank == 0:
        res["path_shapes_err"] = phase_path_shapes(seen)
    return res


def _tp16_check(ranks):
    """Phase 16's checks and lines; returns (launches, numbers)."""
    import numpy as np
    out = DIST_DIR / "tp-families"
    nums = {}
    launches = {"mca_matmul_fixed": 0, "kv_slot_update": 0}
    fail = []
    for arch in TP16_ARCHS:
        tag = arch.split("-")[0]
        a0 = ranks[0]["a"][arch]
        for r in ranks:
            a = r["a"][arch]
            launches["mca_matmul_fixed"] += a["mca_launches"]
            launches["kv_slot_update"] += a["kv_launches"]
            unlisted = [sh for sh in map(tuple, a["shapes"])
                        if sh[4:] == ("bfloat16", 128)
                        and sh[:4] not in TP16_MCA_CASES]
            log(f"[tp-families] (a) {arch} ({a['layers']} layers) (1, 2) "
                f"rank {a['rank']}: holds "
                f"{a['share']:.4f} of the elements; made in "
                f"{a['init_s']:.1f} s; prefill of 4 x 256 in "
                f"{a['prefill_s']:.3f} s, mca_matmul_fixed "
                f"{a['mca_launches']} launches (predicted {a['want_mca']}),"
                f" fallbacks {a['fallbacks'] or 0}; {TP16_DECODE} decode "
                f"steps p50 {1e3 * a['decode_p50_s']:.2f} ms, "
                f"kv_slot_update {a['kv_launches']} launches (predicted "
                f"{a['want_kv']}); logits finite {a['finite']}; peak "
                f"{a['peak_mem_gb']:.2f} GB; cache {a['cache']}; kernel "
                f"shapes {[sh[:4] for sh in map(tuple, a['shapes'])]}")
            if (a["mca_launches"] != a["want_mca"] or a["fallbacks"]
                    or a["kv_launches"] != a["want_kv"] or not a["finite"]
                    or a["entry_launches"] or unlisted
                    or not 0.4 < a["share"] < 0.6
                    or (arch != "mamba2-2.7b" and not a["want_mca"])):
                fail.append(f"(a) {arch} rank {a['rank']} (unlisted "
                            f"shapes {unlisted})")
        if ranks[1]["a"][arch]["tokens"] != a0["tokens"]:
            fail.append(f"(a) {arch}: the ranks' greedy tokens differ")
        world1 = np.load(out / f"{tag}_off_world1.npy")
        err = max(float(np.abs(np.load(out / f"{tag}_off_{r}.npy")
                               - world1).max() / np.abs(world1).max())
                  for r in (0, 1))
        b0 = ranks[0]["b"][arch]
        line = (f"[tp-families] (b) {arch} {TP16_LAYERS} layers f32, 4 x "
                f"128, MCA off: (1, 2) logits vs a world of one "
                f"max|diff|/max|logit| {err:.3e} (limit 1e-5)")
        mca_err, layer0_ok, later = None, True, []
        if "hists12" in b0:
            dp = np.concatenate([np.load(out / f"{tag}_mca21_{r}.npy")
                                 for r in (0, 1)])
            mca_err = max(float(np.abs(np.load(out / f"{tag}_mca12_{r}.npy")
                                       - dp).max() / np.abs(dp).max())
                          for r in (0, 1))
            for r in ranks:
                h12, h21 = r["b"][arch]["hists12"], r["b"][arch]["hists21"]
                layer0_ok &= h12[:2] == h21[:2] and len(h12) == len(h21)
                later.append([int(np.abs(np.array(x) - np.array(y)).sum())
                              for x, y in zip(h12, h21)])
            line += (f"; MCA on: layer 0's tier_hist (v_proj, o_proj) "
                     f"{b0['hists12'][:2]} on (1, 2), {b0['hists21'][:2]} on "
                     f"(2, 1): equal {layer0_ok}; every routing's summed "
                     f"|difference| {later}; logits (1, 2) vs (2, 1) "
                     f"max|diff|/max|logit| {mca_err:.3e} (measured)")
        c = b0["c"]
        rel = max(_rel(c["losses"], c["world1"]["losses"]),
                  _rel(c["gnorms"], c["world1"]["gnorms"]))
        line += (f"; (c) 2 AdamW steps on (1, 2): losses {c['losses']} "
                 f"grad norms {c['gnorms']} vs a world of one "
                 f"{c['world1']['losses']} {c['world1']['gnorms']}: max rel "
                 f"{rel:.2e} (limit 1e-5); peak "
                 f"{c['peak_mem_gb']:.2f} GB a rank; (b) {b0['b_s']:.1f} s, "
                 f"(c) {b0['c_s']:.1f} s")
        log(line)
        if not (err <= 1e-5 and layer0_ok and rel <= 1e-5):
            fail.append(f"(b)/(c) {arch}")
        nums[arch] = {
            "prefill_s": [r["a"][arch]["prefill_s"] for r in ranks],
            "decode_p50_ms": [1e3 * r["a"][arch]["decode_p50_s"]
                              for r in ranks],
            "peak_gb": [r["a"][arch]["peak_mem_gb"] for r in ranks],
            "mca_launches": a0["mca_launches"],
            "kv_launches": a0["kv_launches"], "b_off_err": err,
            "b_mca_err": mca_err, "c_rel": rel}
    if fail:
        raise AssertionError("phase 16 failed: " + "; ".join(fail))
    return launches, nums


def phase_tp_families():
    """Phase 16: tensor parallelism of the MLA, SSM, hybrid, encoder-
    decoder and VLM families, two ranks on the card over gloo.  Returns
    (main-path launches, the max error of the shapes held, numbers)."""
    import gc
    import shutil
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = _torchrun(2, "tp-families", 600)
    launches, nums = _tp16_check(ranks)
    nums["phase_s"] = time.perf_counter() - t0
    log(f"[tp-families] phase 16 in {nums['phase_s']:.1f}s; main-path "
        f"launches {launches}")
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    return launches, ranks[0]["path_shapes_err"], nums


# ------------------------------------------------------------ phase 17
SP_LAYERS = 8                    # (a), (c): starcoder2-3b cut to 8 layers
SP_TRAIN = (4, 1024)             # (a), (c): rows x tokens (1,023: whole)
SP_PREFILL = (4, 512)            # (b): rows x tokens
SP_PARITY_LAYERS = 4             # (b): the f32 check's depth
SP_EXAMPLES = ("torch_quickstart.py", "torch_serve_mca.py")
SP_EXAMPLE_S = 60                # (d): each example's time limit


def _sp_batch(cfg, b, s, seed, dev):
    """Tokens [b, s] from ``seed`` and their next-token labels (the last
    position ignored)."""
    import numpy as np
    import torch
    toks = np.random.default_rng(seed).integers(1, cfg.vocab_size, (b, s))
    tokens = torch.as_tensor(toks.astype(np.int32), device=dev)
    labels = torch.roll(tokens, -1, 1)
    labels[:, -1] = -1
    return {"tokens": tokens, "labels": labels}


def _sp_memory(rank, mesh, dev):
    """(a) starcoder2-3b at full width cut to SP_LAYERS layers, bf16,
    remat on, MCA on v_proj (the plain sampled product), on (1, 2): one
    loss and backward of 4 x 1,024 tokens (the residual split: each
    rank's checkpointed layers save [4, 512, 3072]), after one that
    warms up, then of 4 x 1,023 (whole); the bytes the forward leaves
    held, the peak over the step, the step time."""
    import gc
    import torch
    import torch.utils.checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core.policy import MCAConfig
    from repro_torch.dist import context as dctx
    from repro_torch.models import build_model
    cfg = get_config("starcoder2-3b", n_layers=SP_LAYERS, mca=MCAConfig(
        enabled=True, alpha=0.2, block=128, sites=("v_proj",)))
    model = build_model(cfg, device=dev)
    full = model.init(0)
    params, share = _tp16_shard(model, mesh, full)
    del full
    leaves = [t for t in _leaves(params) if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    gc.collect()
    torch.cuda.empty_cache()
    b, s = SP_TRAIN
    saved = []
    orig_ckpt = torch.utils.checkpoint.checkpoint

    def spy_ckpt(fn, *args, **kw):
        if fn.__name__ == "run":                # a layer of the stack
            saved.append((list(args[0].shape), str(args[0].dtype)))
        return orig_ckpt(fn, *args, **kw)

    runs = []
    for seq in (s, s, s - 1):                   # the first warms up
        batch = _sp_batch(cfg, b, seq, 17, dev)
        saved[:] = []
        calls, undo = _call_counter(dctx, "split_sequence")
        torch.utils.checkpoint.checkpoint = spy_ckpt
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        try:
            with dctx.use_mesh(mesh):
                loss, _ = model.loss(params, batch, 0)
                torch.cuda.synchronize()
                held = torch.cuda.memory_allocated() - before
                grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
        finally:
            undo()
            torch.utils.checkpoint.checkpoint = orig_ckpt
        runs.append({
            "seq": seq, "held": held, "step_s": time.perf_counter() - t0,
            "peak": torch.cuda.max_memory_allocated() - before,
            "splits": calls[0], "saved": saved[:1], "n_saved": len(saved),
            "loss": float(loss.detach()),
            "finite": all(bool(torch.isfinite(g).all()) for g in grads)})
        del loss, grads
    del params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return {"warm": runs[0], "split": runs[1], "whole": runs[2],
            "share": share}


def _sp_kernel(rank, mesh, dev, out):
    """(b) starcoder2-3b at full width on (1, 2), a no-grad
    ``forward_hidden`` of 4 x 512 tokens with the residual split and MCA
    on v_proj and o_proj through the kernel: its launches, counters and
    shapes; then 4 layers in f32 (TF32 off, MCA off): each rank's hidden
    states and, on rank 0, a world of one's, saved for the check."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core.policy import MCAConfig
    from repro_torch.dist import context as dctx
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, use_kernel=True,
                    sites=("v_proj", "o_proj"))
    cfg = get_config("starcoder2-3b", mca=mca)
    model = build_model(cfg, device=dev)
    full = model.init(0)
    params, _ = _tp16_shard(model, mesh, full)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    b, s = SP_PREFILL
    batch = {"tokens": _sp_batch(cfg, b, s, 18, dev)["tokens"]}
    calls, undo = _call_counter(dctx, "split_sequence")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with torch.no_grad(), obs.scoped() as reg, _MCAShapes() as shapes, \
                dctx.use_mesh(mesh):
            hidden, _, stats = model.forward_hidden(params, batch, 0)
            torch.cuda.synchronize()
            launches = ops.launch_counts()
            counters = _kernel_counters(reg.snapshot())
    finally:
        undo()
    res = {"s": time.perf_counter() - t0,
           "mca_launches": launches["mca_matmul_fixed"],
           "want_mca": 2 * _expected_mca(cfg, [b * s // 2])[0],
           "other_launches": {k: v for k, v in launches.items()
                              if k != "mca_matmul_fixed" and v},
           "fallbacks": {k: v for k, v in counters.items()
                         if k.endswith("fallback_calls") and v},
           "splits": calls[0], "finite": bool(torch.isfinite(hidden).all()),
           "hidden_shape": list(hidden.shape),
           "flops_reduction": float(stats["exact_flops"]
                                    / stats["mca_flops"]),
           "shapes": sorted(shapes.seen)}
    del params, model, hidden
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = get_config("starcoder2-3b", dtype="float32",
                       n_layers=SP_PARITY_LAYERS)
    m32 = build_model(cfg32, device=dev)
    full = m32.init(0)
    p32, _ = _tp16_shard(m32, mesh, full)
    calls, undo = _call_counter(dctx, "split_sequence")
    try:
        with torch.no_grad(), dctx.use_mesh(mesh):
            h = m32.forward_hidden(p32, batch)[0]
    finally:
        undo()
    res["f32_splits"] = calls[0]
    np.save(out / f"h32_{rank}.npy", h.cpu().numpy())
    del p32, h
    if rank == 0:
        with torch.no_grad():
            h = m32.forward_hidden(full, batch)[0]
        np.save(out / "h32_world1.npy", h.cpu().numpy())
        del h
    del full
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return res


def _sp_part(out):
    """Phase 17, two ranks on the card over gloo, mesh (1, 2): (a) the
    memory the split saves, (b) the split path through the MCA kernel;
    rank 0 then holds every mca_matmul_fixed shape (b) gave against the
    plain version; (e) the census of the rank's steps."""
    rank, mesh, dev = _tp_setup(1, 2)
    res = {"rank": rank}
    t0 = time.perf_counter()
    res["a"] = _sp_memory(rank, mesh, dev)
    res["a_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["b"] = _sp_kernel(rank, mesh, dev, out)
    res["b_s"] = time.perf_counter() - t0
    if rank == 0:
        res["path_shapes_err"] = phase_path_shapes(
            set(map(tuple, res["b"]["shapes"])))
    # the timed parts are done: the main process starts (e) on meta
    (out / f"ab_done{rank}").touch()
    t0 = time.perf_counter()
    res["e"] = _census_rank(mesh, dev)
    res["e_s"] = time.perf_counter() - t0
    return res


def _sp_check(ranks):
    """Phase 17 (a), (b): the checks and their lines."""
    import numpy as np
    from repro_torch.configs import get_config
    cfg = get_config("starcoder2-3b")
    b, s = SP_TRAIN
    # the checkpointed layer inputs: [b, s, d] bf16 (2 bytes) whole, half
    # of the rows a rank with the split
    predicted = SP_LAYERS * b * s * cfg.d_model * 2 / 2
    nums = {"a_predicted_mb": predicted / 1e6}
    fail = []
    for r in ranks:
        a = r["a"]
        sp, wh = a["split"], a["whole"]
        diff = wh["held"] - sp["held"]
        log(f"[sp] (a) rank {r['rank']} starcoder2-3b {SP_LAYERS} layers "
            f"bf16, remat, MCA on v_proj, (1, 2), holds {a['share']:.4f} "
            f"of the elements: {b} x {sp['seq']} (split: "
            f"{sp['splits']} split calls, {sp['n_saved']} checkpointed "
            f"layer inputs of {sp['saved']}) held {sp['held'] / 1e6:.1f} "
            f"MB after the forward, peak {sp['peak'] / 1e6:.1f} MB, step "
            f"{sp['step_s']:.3f} s (warm-up {a['warm']['step_s']:.3f} s); "
            f"{b} x {wh['seq']} (whole: {wh['splits']} split calls, "
            f"{wh['n_saved']} of {wh['saved']}) held "
            f"{wh['held'] / 1e6:.1f} MB, peak {wh['peak'] / 1e6:.1f} MB, "
            f"step {wh['step_s']:.3f} s; held difference "
            f"{diff / 1e6:.2f} MB (predicted {predicted / 1e6:.2f} MB, "
            f"limit 10%); losses {sp['loss']:.4f} {wh['loss']:.4f}")
        if not (abs(diff - predicted) <= 0.1 * predicted
                and sp["splits"] > 0 and wh["splits"] == 0
                and sp["finite"] and wh["finite"]
                and sp["saved"][0] == [[b, s // 2, cfg.d_model],
                                       "torch.bfloat16"]
                and wh["saved"][0][0] == [b, s - 1, cfg.d_model]):
            fail.append(f"(a) rank {r['rank']}")
        nums[f"a_rank{r['rank']}"] = {
            "held_split_mb": sp["held"] / 1e6,
            "held_whole_mb": wh["held"] / 1e6, "diff_mb": diff / 1e6,
            "peak_split_mb": sp["peak"] / 1e6,
            "peak_whole_mb": wh["peak"] / 1e6,
            "step_split_s": sp["step_s"], "step_whole_s": wh["step_s"]}
    out = DIST_DIR / "sp"
    world1 = np.load(out / "h32_world1.npy")
    errs = [float(np.abs(np.load(out / f"h32_{r}.npy") - world1).max()
                  / np.abs(world1).max()) for r in (0, 1)]
    for r in ranks:
        k = r["b"]
        log(f"[sp] (b) rank {r['rank']} starcoder2-3b full width (1, 2), "
            f"no-grad forward_hidden of {SP_PREFILL[0]} x {SP_PREFILL[1]} "
            f"in {k['s']:.3f} s: {k['splits']} split calls, "
            f"mca_matmul_fixed {k['mca_launches']} launches (predicted "
            f"{k['want_mca']}: two chunks of {SP_PREFILL[0]} x "
            f"{SP_PREFILL[1]} / 2), other launches "
            f"{k['other_launches'] or 0}, fallbacks {k['fallbacks'] or 0},"
            f" hidden {k['hidden_shape']} finite {k['finite']}, "
            f"flops_reduction {k['flops_reduction']:.3f}; kernel shapes "
            f"{[sh[:4] for sh in map(tuple, k['shapes'])]}")
        if (k["mca_launches"] != k["want_mca"] or not k["want_mca"]
                or k["fallbacks"] or not k["splits"] or not k["finite"]
                or not k["f32_splits"]):
            fail.append(f"(b) rank {r['rank']}")
    log(f"[sp] (b) {SP_PARITY_LAYERS} layers f32, TF32 off, MCA off, split "
        f"({ranks[0]['b']['f32_splits']} split calls): each rank's hidden "
        f"states against a world of one, max|diff|/max|h| {errs} (limit "
        f"1e-4)")
    if not max(errs) <= 1e-4:
        fail.append("(b) f32 hidden states")
    if fail:
        raise AssertionError("phase 17 failed: " + "; ".join(fail))
    nums["b_h32_err"] = max(errs)
    nums["b_s"] = [r["b"]["s"] for r in ranks]
    return nums


def _sp_count():
    """(c) the train step of (a) (MCA off, a world of one) on the card:
    ``launch.dryrun.count_flops`` there and on ``meta`` tensors must be
    equal; the measured step time beside the roofline's t_compute."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun, specs
    from repro_torch.models import build_model
    cfg = get_config("starcoder2-3b", n_layers=SP_LAYERS)
    b, s = SP_TRAIN
    dev = torch.device("cuda")
    model = build_model(cfg, device=dev)
    batch = _sp_batch(cfg, b, s, 17, dev)
    card = dryrun.count_flops(model, "train", batch)
    meta = dryrun.count_flops(build_model(cfg, device="meta"), "train",
                              specs.train_specs(cfg, s, b))
    params = model.init(0)
    leaves = [t for t in _leaves(params) if t.is_floating_point()]
    for t in leaves:
        t.requires_grad_(True)
    times = []
    for _ in range(3):                       # the first warms up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        del loss, grads
    arg_bytes = sum(t.numel() * t.element_size() for t in leaves)
    terms = dryrun.roofline_terms({"flops": card, "bytes_accessed":
                                   arg_bytes})
    step = sorted(times[1:])[0]
    log(f"[sp] (c) starcoder2-3b {SP_LAYERS} layers bf16, {b} x {s}, MCA "
        f"off, one rank: FlopCounterMode on the card {card} (loss and "
        f"backward), launch.dryrun on meta tensors {meta}: equal "
        f"{card == meta}; step {step:.4f} s (best of {len(times) - 1} "
        f"after a warm-up; measured) beside roofline t_compute "
        f"{terms['t_compute']:.4f} s and t_memory {terms['t_memory']:.6f} "
        f"s (the params read once): {terms['t_compute'] / step:.3f} of "
        f"the bf16 peak (not gated)")
    del params, leaves, model
    gc.collect()
    torch.cuda.empty_cache()
    if card != meta:
        raise AssertionError("phase 17 (c): the card's count differs from "
                             "the dry-run's")
    return {"c_flops": card, "c_step_s": step,
            "c_t_compute_s": terms["t_compute"]}


def _sp_examples():
    """(d) the port's examples on the card, each in a subprocess within
    SP_EXAMPLE_S seconds."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    nums = {}
    for script in SP_EXAMPLES:
        t0 = time.perf_counter()
        try:
            proc = subprocess.run([sys.executable,
                                   str(ROOT / "examples" / script)],
                                  cwd=ROOT, env=env, capture_output=True,
                                  text=True, timeout=SP_EXAMPLE_S)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"phase 17 (d): {script} passed its "
                                 f"{SP_EXAMPLE_S} s") from None
        dt = time.perf_counter() - t0
        for line in proc.stdout.splitlines():
            log(f"[sp] (d) {script}: {line}")
        log(f"[sp] (d) {script} exited {proc.returncode} in {dt:.1f} s "
            f"(limit {SP_EXAMPLE_S} s)")
        if proc.returncode != 0:
            raise AssertionError(f"phase 17 (d): {script} failed:\n"
                                 f"{proc.stderr[-4000:]}")
        nums[script] = dt
    return {"d_s": nums}


CENSUS_PREFILL = (4, 512)        # (e): the prefill's rows x tokens
CENSUS_MAX_LEN = 528             # (e): the decode's cache slots


def _census_cases(dev):
    """(e)'s steps on ``dev`` (the card, or ``meta``): starcoder2-3b at
    full width cut to SP_LAYERS layers, bf16; (kind, model, global
    inputs, mca): a train step with MCA off on (a)'s 4 x 1,024 tokens, a
    prefill of 4 x 512 with MCA on v_proj and o_proj through the kernel,
    one decode step from position 512."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import MCAConfig
    from repro_torch.launch import specs
    from repro_torch.models import build_model
    out = []
    for kind in ("train", "prefill", "decode"):
        mca = MCAConfig(enabled=kind == "prefill", alpha=0.2, block=128,
                        use_kernel=True, sites=("v_proj", "o_proj"))
        cfg = get_config("starcoder2-3b", n_layers=SP_LAYERS, mca=mca)
        model = build_model(cfg, device=dev)
        b, s = SP_TRAIN if kind == "train" else CENSUS_PREFILL
        if kind == "train":
            inputs = (specs.train_specs(cfg, s, b) if dev == "meta"
                      else _sp_batch(cfg, b, s, 19, dev))
        elif kind == "prefill":
            inputs = (specs.prefill_specs(cfg, s, b) if dev == "meta"
                      else {"tokens": _sp_batch(cfg, b, s, 20,
                                                dev)["tokens"]})
        else:
            toks = np.random.default_rng(21).integers(1, cfg.vocab_size,
                                                      (b, 1))
            tok = torch.as_tensor(toks.astype(np.int32), device=dev)
            inputs = (tok, None, torch.tensor(s, dtype=torch.int32,
                                              device=dev))
        out.append((kind, model, inputs, kind == "prefill"))
    return out


def _census_rank(mesh, dev):
    """(e), a rank on the card: each of ``_census_cases``' steps through
    ``launch.dryrun.rank_step`` under ``launch.hlo_analysis``'s census
    and ``FlopCounterMode``, its kernel counters, launches and the card's
    peak over the step."""
    import gc
    import torch
    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun, hlo_analysis
    res = {}
    for kind, model, inputs, mca in _census_cases(dev):
        run, args = dryrun.rank_step(model, kind, inputs, mesh, mca,
                                     max_len=CENSUS_MAX_LEN)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with obs.scoped() as reg, _MCAShapes() as shapes:
            _, counts = hlo_analysis.count_step(run, mesh=mesh,
                                                arguments=args, names=True)
            torch.cuda.synchronize()
            counters = _kernel_counters(reg.snapshot())
        counts.update({
            "shapes": sorted(shapes.seen),
            "s": time.perf_counter() - t0,
            "card_peak": torch.cuda.max_memory_allocated() - before,
            "launches": ops.launch_counts(),
            "kernel_calls": sum(v for k, v in counters.items()
                                if k.endswith(".kernel_calls")),
            "fallback_calls": sum(v for k, v in counters.items()
                                  if k.endswith(".fallback_calls"))})
        res[kind] = counts
        del run, args, model, inputs
        gc.collect()
        torch.cuda.empty_cache()
    return res


def _census_meta(rank):
    """(e) on ``meta`` tensors: ``rank`` of (1, 2) counted in a counting
    world (this process has no world of its own), ``_census_cases``'
    steps as the ranks run them on the card."""
    from repro_torch.dist.context import Mesh
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch.mesh import counting_world
    out = {}
    with counting_world(Mesh((1, 2), ("data", "model")), rank) as mesh:
        for kind, model, inputs, mca in _census_cases("meta"):
            run, args = dryrun.rank_step(model, kind, inputs, mesh, mca,
                                         max_len=CENSUS_MAX_LEN)
            out[kind] = hlo_analysis.count_step(
                run, mesh=mesh, arguments=args, names=True)[1]
    return out


def census_meta_main() -> int:
    """(e) on ``meta`` for one rank (``--census-meta RANK --out DIR``),
    started by ``phase_sp``; writes ``meta{RANK}.json``."""
    sys.path.insert(0, str(ROOT / "src"))
    rank = int(sys.argv[sys.argv.index("--census-meta") + 1])
    out = pathlib.Path(sys.argv[sys.argv.index("--out") + 1])
    (out / f"meta{rank}.json").write_text(json.dumps(_census_meta(rank)))
    return 0


def _census_check(ranks, metas):
    """(e): each rank's counts on the card against the counting world's
    (``_census_meta``): the collective census (count and bytes per kind
    and per axes) and the op census equal, the card's custom calls its
    kernel calls (no fallback), the train step's FLOPs equal (with MCA
    on, the card's kernel replaces products the plain version runs, so
    the prefill's are not compared); the meta peak printed beside the
    card's."""
    fail, nums = [], {}
    for r in ranks:
        for kind in ("train", "prefill", "decode"):
            meta, card = metas[r["rank"]][kind], r["e"][kind]
            ok = {"collectives": meta["collectives"] == card["collectives"],
                  "op_census": meta["op_census"] == card["op_census"],
                  "custom-call": card["op_census"]["custom-call"]
                  == card["kernel_calls"] and card["fallback_calls"] == 0,
                  "flops": kind != "train" or meta["flops"] == card["flops"]}
            launched = {k: v for k, v in card["launches"].items() if v}
            if kind == "prefill":     # MCA's matmuls and scoring passes
                ok["launches"] = set(launched) == {
                    "mca_matmul_fixed", "attn_lse", "attn_colmax",
                    "attn_av"} and sum(launched.values()) == \
                    card["kernel_calls"]
            if kind == "decode":
                ok["launches"] = launched.get("kv_slot_update") == SP_LAYERS
            coll = card["collectives"]
            ratio = meta["temp_size_in_bytes"] / max(card["card_peak"], 1)
            log(f"[sp] (e) rank {r['rank']} {kind} on (1, 2), "
                f"starcoder2-3b {SP_LAYERS} layers bf16 in "
                f"{card['s']:.3f} s: collectives {coll['total_bytes']} B "
                f"in {coll['all-reduce']['count']} all-reduces "
                f"(by axes {json.dumps(coll['by_axes'])}), meta "
                f"{meta['collectives']['total_bytes']} B; op census "
                f"card {card['op_census']} meta {meta['op_census']}; "
                f"kernel calls {card['kernel_calls']} (fallbacks "
                f"{card['fallback_calls']}), launches {launched}; "
                f"FLOPs card {card['flops']} meta {meta['flops']}; "
                f"peak: meta temp_size_in_bytes "
                f"{meta['temp_size_in_bytes'] / 1e6:.1f} MB, card "
                f"census {card['temp_size_in_bytes'] / 1e6:.1f} MB, "
                f"max_memory_allocated over the step "
                f"{card['card_peak'] / 1e6:.1f} MB, meta / card "
                f"{ratio:.3f}; equal: {ok}")
            if not all(ok.values()):
                diff = {k: (card["aten_names"].get(k, 0),
                            meta["aten_names"].get(k, 0))
                        for k in set(card["aten_names"])
                        | set(meta["aten_names"])
                        if card["aten_names"].get(k, 0)
                        != meta["aten_names"].get(k, 0)}
                log(f"[sp] (e) rank {r['rank']} {kind}: ATen ops that "
                    f"differ (card, meta): {diff}")
                fail.append(f"(e) rank {r['rank']} {kind}: "
                            f"{[k for k, v in ok.items() if not v]}")
            nums[f"e_rank{r['rank']}_{kind}"] = {
                "collective_bytes": coll["total_bytes"],
                "aten_ops": card["op_census"]["aten_ops"],
                "flops": card["flops"], "s": card["s"],
                "meta_temp_mb": meta["temp_size_in_bytes"] / 1e6,
                "card_census_temp_mb": card["temp_size_in_bytes"] / 1e6,
                "card_peak_mb": card["card_peak"] / 1e6,
                "meta_over_card": ratio}
    if fail:
        raise AssertionError("phase 17 (e) failed: " + "; ".join(fail))
    return nums


def phase_sp():
    """Phase 17: the sequence-parallel residual, two ranks on the card
    over gloo ((a) memory, (b) the MCA kernel on the split path, (e) the
    census of their steps); once (a) and (b) are done, each rank's
    census counted again on meta in a process of its own and (d) the
    examples in this process; then (c) the dry-run's count against the
    card's, and (e)'s check of card against meta.  Returns (main-path launches, the max error of the
    shapes held, numbers)."""
    import gc
    import os
    import shutil
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    # the ranks run (a), (b) and then (e) on the card; once their timed
    # (a) and (b) are done, a process for each rank counts (e) on meta
    # and this process runs (d), beside (e) on the card; (c) runs after
    # them all, alone
    box = {}
    marks = DIST_DIR / "sp"
    shutil.rmtree(marks, ignore_errors=True)

    def ranks_on_card():
        try:
            box["ranks"] = _torchrun(2, "sp", 600)
        except BaseException as exc:                      # noqa: BLE001
            box["error"] = exc

    card = threading.Thread(target=ranks_on_card)
    card.start()
    while card.is_alive() and not all(
            (marks / f"ab_done{r}").exists() for r in (0, 1)):
        time.sleep(0.2)
    meta_dir = DIST_DIR / "sp_meta"
    shutil.rmtree(meta_dir, ignore_errors=True)
    meta_dir.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    t_meta = time.perf_counter()
    procs = [] if "error" in box else [
        subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                          "--census-meta", str(r), "--out", str(meta_dir)],
                         env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for r in (0, 1)]
    try:
        nums = _sp_examples() if procs else {}
        card.join()
        if "error" in box:
            raise box["error"]
        ranks = box["ranks"]
        nums.update(_sp_check(ranks))
        for r, proc in enumerate(procs):
            _, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"phase 17 (e) on meta, rank {r}, "
                                     f"failed:\n{err[-6000:]}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    meta_s = time.perf_counter() - t_meta
    metas = {r: json.loads((meta_dir / f"meta{r}.json").read_text())
             for r in (0, 1)}
    nums.update(_sp_count())
    nums.update(_census_check(ranks, metas))
    # (e)'s prefill gives the kernel (b)'s shapes; any other is held here
    e_shapes = {tuple(sh) for r in ranks
                for sh in r["e"]["prefill"]["shapes"]}
    new = e_shapes - {tuple(sh) for r in ranks for sh in r["b"]["shapes"]}
    err = phase_path_shapes(new) if new else 0.0
    nums["e_s"] = [r["e_s"] for r in ranks]
    nums["e_meta_s"] = meta_s
    log(f"[sp] (e) the census on the card {nums['e_s']} s a rank, beside "
        f"(d) and the count on meta in a process a rank; from the end of "
        f"(b) to the end of (d), (e) and the meta count {meta_s:.1f} s")
    e_launches = [r["e"][k]["launches"] for r in ranks
                  for k in ("prefill", "decode")]
    launches = {"mca_matmul_fixed": sum(r["b"]["mca_launches"]
                                        for r in ranks)
                + sum(n["mca_matmul_fixed"] for n in e_launches),
                "kv_slot_update": sum(n["kv_slot_update"]
                                      for n in e_launches)}
    nums["phase_s"] = time.perf_counter() - t0
    log(f"[sp] phase 17 in {nums['phase_s']:.1f}s; main-path launches "
        f"{launches}")
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    return launches, max(ranks[0]["path_shapes_err"], err), nums


# ------------------------------------------------------------ phase 18
MESH2D_GLOBAL = (2, 63)          # (a), (c): one row of 63 tokens a data shard
MESH2D_CHUNKED = (4, 256)        # (b): 2 rows, 512 tokens a data shard
MESH2D_DECODE = 8
MESH2D_LAYERS = 4                # (c): starcoder2-3b cut, full width, f32
BOUNDARY_MARGIN = 1e-3           # (c): r_cols / block's distance to a rung
TIE_MARGIN = 1e-5                # (c): relative gap of distinct importances


def _mesh2d_prefill(model, params, mesh, batch, clock):
    """``make_prefill_step`` of ``batch`` under ``mesh`` with the MCA
    kernel's counts reset before and read after: (cache, logits, the
    time, launches, the kernels' registry counters, the routings as
    ``_spy`` records them, the kernel shapes)."""
    import torch
    from repro_torch import obs
    from repro_torch.core import policy
    from repro_torch.dist import context as dctx
    from repro_torch.kernels import ops
    from repro_torch.train.step import make_prefill_step
    calls = []
    undo = _spy(policy, "_tiered_maybe_sharded", calls)
    try:
        with torch.no_grad(), obs.scoped() as reg, _MCAShapes() as shapes, \
                dctx.use_mesh(mesh):
            ops.reset_launch_counts()
            t1 = clock()
            cache, logits = make_prefill_step(model, DIST_MAX_LEN)(params,
                                                                   batch)
            prefill_s = clock() - t1
            launches = ops.launch_counts()
            counters = _kernel_counters(reg.snapshot())
    finally:
        undo()
    return cache, logits, prefill_s, launches, counters, calls, shapes.seen


def _mesh2d_serve(rank, mesh, dev):
    """(a) starcoder2-3b at full width on (2, 2), MCA on v_proj and o_proj
    through the kernel: a prefill of 2 x 63 (the global routing), then 8
    greedy decode steps; (b) a prefill of 4 x 256 (the chunked one)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import MCAConfig
    from repro_torch.dist import context as dctx
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, use_kernel=True,
                    sites=("v_proj", "o_proj"))
    cfg = get_config("starcoder2-3b", mca=mca)
    model = build_model(cfg, device=dev)
    full = model.init(0)
    params, share = _tp16_shard(model, mesh, full)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()        # the serving peak

    def clock():
        torch.cuda.synchronize()
        return time.perf_counter()

    res = {"rank": rank, "share": share}
    for part, (b, s) in (("a", MESH2D_GLOBAL), ("b", MESH2D_CHUNKED)):
        prompts = np.random.default_rng(18).integers(
            1, cfg.vocab_size, (b, s)).astype(np.int32)
        cache, logits, prefill_s, launches, counters, calls, seen = \
            _mesh2d_prefill(model, params, mesh,
                            {"tokens": torch.as_tensor(prompts, device=dev)},
                            clock)
        r = res[part] = {
            "prefill_s": prefill_s, "calls": len(calls),
            "mca_launches": launches["mca_matmul_fixed"],
            "entry_launches": sum(launches[k] for k in ENTRY_ONLY),
            "fallbacks": {k: v for k, v in counters.items()
                          if k.endswith("fallback_calls") and v},
            "hists": [out[1].tolist() for _, _, out in calls],
            "local_hists": [out[2].tolist() for _, _, out in calls],
            "shapes": sorted(seen)}
        if part == "a":
            # the routing's inputs, for the check's rerun on the CPU
            r["tiers"] = [a[3].tolist() for a, _, _ in calls]
            r["imps"] = [a[4].float().tolist() for a, _, _ in calls]
            tok = torch.argmax(logits[..., :cfg.vocab_size],
                               -1).to(torch.int32)
            ops.reset_launch_counts()
            with torch.no_grad(), dctx.use_mesh(mesh):
                toks, _, bad, step_s = _decode_greedy(
                    model, params, tok, cache, s, MESH2D_DECODE, clock)
            r["kv_launches"] = ops.launch_counts()["kv_slot_update"]
            r["decode_p50_s"] = float(np.median(step_s))
            r["finite"] = not bool(bad) and bool(
                torch.isfinite(logits).all())
            r["tokens"] = torch.cat([tok] + toks, 1).cpu().tolist()
        del cache, logits, calls
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, model
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _mesh2d_parity(out, rank, mesh, dev):
    """(c) starcoder2-3b cut to 4 layers, f32, TF32 off, MCA on v_proj
    (the plain sampled product): a prefill of 2 x 63 on (2, 2) and, on
    rank 0, in a world of one with the same key (every routing's
    tier_hist and importances, the logits saved); then 2 AdamW steps of
    ``jit_train_step`` on (2, 2) and, on rank 0, of ``make_train_step``
    in a world of one."""
    import gc
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import policy
    from repro_torch.core.policy import MCAConfig
    from repro_torch.dist import context as dctx
    from repro_torch.dist import sharding as shd
    from repro_torch.models import build_model
    from repro_torch.optim import adamw
    from repro_torch.train import make_train_step
    from repro_torch.train.step import jit_train_step, make_prefill_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, sites=("v_proj",))
    cfg = get_config("starcoder2-3b", dtype="float32",
                     n_layers=MESH2D_LAYERS, mca=mca)
    model = build_model(cfg, device=dev)
    full = model.init(0)
    params, _ = _tp16_shard(model, mesh, full)
    b, s = MESH2D_GLOBAL
    toks = np.random.default_rng(19).integers(1, cfg.vocab_size, (b, s))
    batch = {"tokens": torch.as_tensor(toks.astype(np.int32), device=dev)}
    res = {"rank": rank}
    for tag, m, p in (("mesh", mesh, params), ("world1", None, full)):
        if tag == "world1" and rank != 0:
            continue
        calls = []
        undo = _spy(policy, "_tiered_maybe_sharded", calls)
        try:
            with torch.no_grad():
                if m is None:
                    _, lg = make_prefill_step(model, s + 1)(p, batch)
                else:
                    with dctx.use_mesh(m):
                        _, lg = make_prefill_step(model, s + 1)(p, batch)
        finally:
            undo()
        np.save(out / f"c_{tag}_{rank}.npy",
                lg[..., :cfg.vocab_size].cpu().numpy())
        res["hists_" + tag] = [o[1].tolist() for _, _, o in calls]
        if tag == "world1":
            res["imps"] = [a[4].tolist() for a, _, _ in calls]
        del lg, calls
    res["prefill_s"] = time.perf_counter() - t_start
    t_c = time.perf_counter()
    opt = adamw.AdamWConfig(lr=3e-4, schedule=adamw.cosine_schedule(1, 2))
    batches = []
    for i in range(2):
        t_i = torch.as_tensor(np.random.default_rng(20 + i).integers(
            1, cfg.vocab_size, (b, s)).astype(np.int32), device=dev)
        labels = torch.roll(t_i, -1, 1)
        labels[:, -1] = -1
        batches.append({"tokens": t_i, "labels": labels})
    step = jit_train_step(mesh, model, opt, batches[0], donate=False)
    p_sh = step.in_shardings[0]
    params = shd.shard_params(full, p_sh)
    if rank != 0:
        del full
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = adamw.init_state(params, step.in_shardings[1]["m"], p_sh)
    losses, gnorms = [], []
    with dctx.use_mesh(mesh):
        for bi in batches:
            params, state, mt = step(params, state, bi)
            losses.append(float(mt["total_loss"]))
            gnorms.append(float(mt["grad_norm"]))
    res["train"] = {"losses": losses, "gnorms": gnorms,
                    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()                    # the others' state freed first
    if rank == 0:
        flat = make_train_step(model, opt)
        state = adamw.init_state(full)
        losses, gnorms = [], []
        for bi in batches:
            full, state, mt = flat(full, state, bi)
            losses.append(float(mt["total_loss"]))
            gnorms.append(float(mt["grad_norm"]))
        res["train"]["world1"] = {"losses": losses, "gnorms": gnorms}
        del full, state
    dist.barrier()
    res["train_s"] = time.perf_counter() - t_c
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _mesh2d_part(out):
    """Phase 18, four ranks on the card: (a) and (b), then (c); rank 0
    then holds every mca_matmul_fixed shape of (a) and (b) against the
    plain version."""
    rank, mesh, dev = _tp_setup(2, 2)      # rank r at (r // 2, r % 2)
    res = {"rank": rank, "serve": _mesh2d_serve(rank, mesh, dev)}
    res["c"] = _mesh2d_parity(out, rank, mesh, dev)
    if rank == 0:
        seen = {tuple(sh) for p in ("a", "b")
                for sh in res["serve"][p]["shapes"]}
        res["path_shapes_err"] = phase_path_shapes(seen)
    return res


def _margin_cut(imps, seq_len, d, mca):
    """The first routing whose importances leave no room to agree across
    two placements (a budget r_cols / block within BOUNDARY_MARGIN of a
    sampled rung, or two distinct importances within TIE_MARGIN of each
    other, relative), or None; the check of ``tests/_torch_parity.py``."""
    import numpy as np
    from repro_torch.core import schedule
    block = mca.block_for(d)
    ladder = schedule.tier_ladder(d, block, mca.n_tiers, mca.r_min_blocks)
    for i, imp in enumerate(imps):
        imp = np.asarray(imp, dtype=np.float64)
        r = np.clip((seq_len * imp / mca.alpha) ** 2, 1.0, float(d)) / block
        if any(float(np.min(np.abs(r - rung))) / rung <= BOUNDARY_MARGIN
               for rung in ladder[:-1]):
            return i
        u = np.unique(imp[imp > 0])
        if len(u) > 1 and float(np.min(np.diff(u) / u[1:])) <= TIE_MARGIN:
            return i
    return None


def _mesh2d_check(ranks):
    """Phase 18's checks and lines; returns (launches, numbers)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch
    from repro_torch.core.policy import MCAConfig, _caps_for
    mca = MCAConfig(enabled=True, alpha=0.2, block=128, use_kernel=True,
                    sites=("v_proj", "o_proj"))
    cfg = get_config("starcoder2-3b", mca=mca)
    fail = []
    ga, gs = MESH2D_GLOBAL
    ca, cs = MESH2D_CHUNKED
    want = {"a": _expected_mca(cfg, [ga * gs])[0],
            "b": 2 * _expected_mca(cfg, [ca * cs // 2 // 2])[0]}
    caps = _caps_for(ga * gs, mca.n_tiers, mca.capacity_fracs)
    listed = set(MESH2D_MCA_CASES) | set(TP_MCA_CASES)
    # the global routing rerun on the CPU: the data ranks' (0 and 2)
    # tiers and importances in rank order, the capacities of 126 tokens
    s0, s2 = ranks[0]["serve"]["a"], ranks[2]["serve"]["a"]
    rerun = []
    for i in range(len(s0["tiers"])):
        tier = torch.tensor(s0["tiers"][i] + s2["tiers"][i],
                            dtype=torch.int32)
        imp = torch.tensor(s0["imps"][i] + s2["imps"][i],
                           dtype=torch.float32)
        n_t = len(s0["hists"][i])           # the routing's ladder
        caps_i = _caps_for(ga * gs, n_t, mca.capacity_fracs)
        rerun.append(dispatch.tier_histogram(dispatch.apply_capacity(
            tier, imp, caps_i), n_t).tolist())
    launches = {"mca_matmul_fixed": 0, "kv_slot_update": 0}
    for r in ranks:
        sv = r["serve"]
        for part in ("a", "b"):
            p = sv[part]
            launches["mca_matmul_fixed"] += p["mca_launches"]
            unlisted = [sh for sh in map(tuple, p["shapes"])
                        if sh[4:] != ("bfloat16", 128)
                        or sh[:4] not in listed]
            same = p["hists"] == ranks[0]["serve"][part]["hists"]
            ok = (p["mca_launches"] == want[part] and not p["fallbacks"]
                  and not p["entry_launches"] and not unlisted and same
                  and p["calls"] == 2 * cfg.n_layers)
            if part == "a":
                launches["kv_slot_update"] += p["kv_launches"]
                ok &= (p["hists"] == rerun and p["finite"]
                       and p["kv_launches"] == cfg.n_layers * MESH2D_DECODE
                       and sum(p["hists"][0]) == ga * gs)
                log(f"[mesh-2d] (a) rank {r['rank']} starcoder2-3b (2, 2), "
                    f"holds {sv['share']:.4f} of the elements: prefill of "
                    f"{ga} x {gs} (one row of {gs} tokens a data shard, "
                    f"routed globally, caps {list(caps)}) in "
                    f"{p['prefill_s']:.3f} s, {p['calls']} routings, "
                    f"mca_matmul_fixed {p['mca_launches']} launches "
                    f"(predicted {want['a']}), fallbacks "
                    f"{p['fallbacks'] or 0}; tier_hist equal on the four "
                    f"ranks {same}, equal to apply_capacity rerun on the "
                    f"CPU over the {ga * gs} gathered importances "
                    f"{p['hists'] == rerun} (layer 0: {p['hists'][:2]}, "
                    f"this rank's rows {p['local_hists'][:2]}); "
                    f"{MESH2D_DECODE} decode steps p50 "
                    f"{1e3 * p['decode_p50_s']:.2f} ms, kv_slot_update "
                    f"{p['kv_launches']} launches (predicted "
                    f"{cfg.n_layers * MESH2D_DECODE}), logits finite "
                    f"{p['finite']}; peak {sv['peak_mem_gb']:.2f} GB")
            else:
                log(f"[mesh-2d] (b) rank {r['rank']}: prefill of {ca} x "
                    f"{cs} ({ca // 2} rows a data shard, two chunks of "
                    f"{ca * cs // 4} tokens a rank) in {p['prefill_s']:.3f} "
                    f"s, mca_matmul_fixed {p['mca_launches']} launches "
                    f"(predicted {want['b']}), fallbacks "
                    f"{p['fallbacks'] or 0}; the summed tier_hist equal on "
                    f"the four ranks {same} (layer 0: {p['hists'][:2]})")
            if not ok:
                fail.append(f"({part}) rank {r['rank']} (unlisted shapes "
                            f"{unlisted})")
    for d0 in (0, 2):
        if ranks[d0]["serve"]["a"]["tokens"] != \
                ranks[d0 + 1]["serve"]["a"]["tokens"]:
            fail.append(f"(a) ranks {d0} and {d0 + 1} (one data shard) "
                        f"decode different tokens")
    # (c) against a world of one
    out = DIST_DIR / "mesh-2d"
    c0 = ranks[0]["c"]
    cut = _margin_cut(c0["imps"], gs, cfg.d_model, mca)
    held = len(c0["hists_world1"]) if cut is None else cut
    hist_ok = all(r["c"]["hists_mesh"][:held] == c0["hists_world1"][:held]
                  and len(r["c"]["hists_mesh"]) == len(c0["hists_world1"])
                  for r in ranks)
    world1 = np.load(out / "c_world1_0.npy")
    errs = []
    for r in ranks:
        row = r["rank"] // 2
        want_lg = world1[row:row + 1]
        errs.append(float(np.abs(np.load(out / f"c_mesh_{r['rank']}.npy")
                                 - want_lg).max() / np.abs(world1).max()))
    tr = c0["train"]
    rel = max(_rel(tr["losses"], tr["world1"]["losses"]),
              _rel(tr["gnorms"], tr["world1"]["gnorms"]))
    cut_s = ("every layer's routing has its margins" if cut is None else
             f"layer {cut}'s routing lies within the margins (a budget "
             f"within {BOUNDARY_MARGIN} of a rung or a near-tie): layers "
             f"before it held")
    log(f"[mesh-2d] (c) starcoder2-3b {MESH2D_LAYERS} layers f32, TF32 "
        f"off, MCA on v_proj (plain), {ga} x {gs} on (2, 2) against a "
        f"world of one: {cut_s}; tier_hist equal {hist_ok} "
        f"({c0['hists_world1']}); logits max|diff|/max|logit| a rank "
        f"{[f'{e:.2e}' for e in errs]} (limit 1e-4); 2 AdamW steps of "
        f"jit_train_step (FSDP): losses {tr['losses']} grad norms "
        f"{tr['gnorms']} vs a world of one {tr['world1']['losses']} "
        f"{tr['world1']['gnorms']}: max rel {rel:.2e} (limit 1e-5); peak "
        f"{tr['peak_mem_gb']:.2f} GB a rank; prefill part "
        f"{c0['prefill_s']:.1f} s, train part {c0['train_s']:.1f} s")
    if not (hist_ok and rel <= 1e-5 and held > 0
            and (cut is not None or max(errs) <= 1e-4)):
        fail.append("(c)")
    if fail:
        raise AssertionError("phase 18 failed: " + "; ".join(fail))
    a = [r["serve"]["a"] for r in ranks]
    return launches, {
        "a_prefill_s": [p["prefill_s"] for p in a],
        "a_decode_p50_ms": [1e3 * p["decode_p50_s"] for p in a],
        "b_prefill_s": [r["serve"]["b"]["prefill_s"] for r in ranks],
        "peak_gb": [r["serve"]["peak_mem_gb"] for r in ranks],
        "a_mca_launches": a[0]["mca_launches"],
        "b_mca_launches": ranks[0]["serve"]["b"]["mca_launches"],
        "c_logits_err": max(errs), "c_margin_cut": cut, "c_train_rel": rel}


def phase_mesh2d():
    """Phase 18: the (2, 2) mesh, four ranks on the card over gloo: (a)
    the global MCA routing at full width through prefill and decode, (b)
    the chunked routing, (c) 4 layers in f32 against a world of one,
    prefill and train step.  Returns (main-path launches, the max error
    of the shapes held, numbers)."""
    import gc
    import shutil
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = _torchrun(4, "mesh-2d", 300)
    launches, nums = _mesh2d_check(ranks)
    nums["phase_s"] = time.perf_counter() - t0
    log(f"[mesh-2d] phase 18 in {nums['phase_s']:.1f}s; main-path launches "
        f"{launches} | {nvidia_smi_line()}")
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    return launches, ranks[0]["path_shapes_err"], nums


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x {torch.cuda.device_count()}")
    phase_build()
    errs = phase_kernels()
    pass_errs, pass_nums = phase_passes()
    errs.update(pass_errs)
    with _MCAShapes() as path_shapes:
        phase_parity()
        launches, per, serve_nums, engine = phase_serve()
        for wrapper, launcher in PASS_WRAPPERS.items():
            launches[wrapper] = launches[launcher]
        launches.update(phase_entry(engine))
        devtel_nums = phase_devtel(engine)
        prof_off = phase_profile(engine)
        phase_devtel_profiled(engine, prof_off, devtel_nums)
        del engine
        nums = phase_numbers()
        train_nums = phase_train()
        fam_launches, fam_nums = phase_families()
        ssm_launches, ssm_nums = phase_ssm_hybrid()
        ev_launches, ev_nums = phase_encdec_vlm()
    errs["mca_matmul_fixed"] = max(errs["mca_matmul_fixed"],
                                   phase_path_shapes(path_shapes.seen))
    dist_launches, dist_err, dist_nums = phase_dist()
    tp_launches, tp_err, tp_nums = phase_tp()
    tp16_launches, tp16_err, tp16_nums = phase_tp_families()
    sp_launches, sp_err, sp_nums = phase_sp()
    m2_launches, m2_err, m2_nums = phase_mesh2d()
    errs["mca_matmul_fixed"] = max(errs["mca_matmul_fixed"], dist_err,
                                   tp_err, tp16_err, sp_err, m2_err)
    for k in SERVE_KERNELS:
        launches[k] += (fam_launches[k] + ssm_launches[k] + ev_launches[k]
                        + dist_launches[k] + tp_launches[k]
                        + tp16_launches[k] + sp_launches[k]
                        + m2_launches[k])
        per[k] += (f"; phase 9: {fam_launches[k]}; phase 11: "
                   f"{ssm_launches[k]}; phase 12: {ev_launches[k]}; "
                   f"phase 14: {dist_launches[k]}; phase 15: "
                   f"{tp_launches[k]}; phase 16: {tp16_launches[k]}; "
                   f"phase 17: {sp_launches[k]}; phase 18: "
                   f"{m2_launches[k]}")
    per["mca_matmul_fixed"] += (" (per prefill of <= 256 tokens: olmoe "
                                "16 x 2 x 3 = 96, minicpm3 62 x (1 + 3) "
                                "= 248; recurrentgemma-9b: 12 attention "
                                "layers x the routing's tiers; mamba2: 0; "
                                "whisper-small 12 x 3 x 3 = 108, none on "
                                "the encoder; internvl2-1b 24 x 2 x 3 = "
                                "144; phase 15, two chunks a rank: "
                                "starcoder2-3b 2 x 180 = 360 a rank, "
                                "olmoe-1b-7b 2 x 64 = 128 a rank; phase "
                                "16, two chunks a rank: the routing's, "
                                "printed on its (a) lines; phase 17 (b), "
                                "two chunks of 4 x 256 a rank: the "
                                "routing's, printed on its (b) lines; "
                                "(e), 8 layers, the same a layer, printed "
                                "on its (e) lines; phase 18, four ranks: "
                                "(a) the global routing, 180 a rank, (b) "
                                "two chunks, 360 a rank)")
    per["kv_slot_update"] += (" (per decode step: olmoe 16, minicpm3 62, "
                              "recurrentgemma-9b 12, mamba2-2.7b 0, "
                              "whisper-small 12, internvl2-1b 24; phase "
                              "15: 30 a rank, one KV head each; phase 16: "
                              "one an attention layer of its 8-layer "
                              "cut, a rank; phase 17 (e): 8 a rank, one "
                              "decode step of 8 layers; phase 18 (a): 30 "
                              "a rank)")
    meta = {
        "mca_matmul_fixed": ("src/repro_torch/csrc/mca_matmul.cu",
                             "src/repro/kernels/mca_matmul.py:84"),
        "kv_slot_update": ("src/repro_torch/csrc/kv_slot_update.cu",
                           "src/repro/kernels/cache_update.py:48"),
        "mca_matmul_ragged": ("src/repro_torch/csrc/mca_matmul.cu",
                              "src/repro/kernels/mca_matmul.py:168"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:92"),
        "attn_colmax": ("src/repro_torch/csrc/attn_colmax.cu",
                        "src/repro/kernels/attn_colmax.py:74"),
        "attn_lse": ("src/repro_torch/csrc/flash_attention.cu",
                     "src/repro/models/attention.py:59"),
        "attn_colmax_pass": ("src/repro_torch/csrc/attn_colmax.cu",
                             "src/repro/models/attention.py:96"),
        "attn_av": ("src/repro_torch/csrc/flash_attention.cu",
                    "src/repro/models/attention.py:128"),
    }
    per.update({k: "on the entry-point path (phase 5b), once each"
                for k in ENTRY_KERNELS})
    nums.update(pass_nums)
    kernels = []
    for name, (source, replaces) in meta.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], **nums[name]})
    for name in meta:
        log(f"[numbers] {name} launches {launches[name]} ({per[name]})")
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f}s "
        f"(phase 8: {train_nums['phase_s']:.1f}s, phase 9: "
        f"{fam_nums['phase_s']:.1f}s, phase 10: "
        f"{devtel_nums['phase_s']:.1f}s, phase 11: "
        f"{ssm_nums['phase_s']:.1f}s, phase 12: {ev_nums['phase_s']:.1f}s, "
        f"phase 14: {dist_nums['phase_s']:.1f}s, phase 15: "
        f"{tp_nums['phase_s']:.1f}s, phase 16: "
        f"{tp16_nums['phase_s']:.1f}s, phase 17: "
        f"{sp_nums['phase_s']:.1f}s, phase 18: "
        f"{m2_nums['phase_s']:.1f}s)")
    log(json.dumps({"serve": serve_nums, "train": train_nums,
                    "families": fam_nums, "devtel": devtel_nums,
                    "ssm_hybrid": ssm_nums, "encdec_vlm": ev_nums,
                    "dist": dist_nums, "tp": tp_nums,
                    "tp_families": tp16_nums, "sp": sp_nums,
                    "mesh_2d": m2_nums,
                    "family_kernels": nums["families"], "card": smi}))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(dist_part_main() if "--dist-part" in sys.argv
             else census_meta_main() if "--census-meta" in sys.argv
             else main())
