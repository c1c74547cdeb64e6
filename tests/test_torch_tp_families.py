"""Tensor parallelism of the MLA, SSM, hybrid, encoder-decoder and VLM
families (a ``"model"`` axis > 1) against the reference.

The reference runs once, in a subprocess with 4 forced host devices and
Auto axes; the port runs in ``gloo`` worlds of 2 ranks, mesh (1, 2), and
of 4 ranks, meshes (1, 4) and (2, 2) (subprocesses, as
``tests/test_torch_tp.py``).  Reduced configs in f32 (``reduced()``: 2
layers, 3 for the hybrid's pattern, d 128), the port's params converted
from the reference's (``convert.params_from_jax``) and sharded
(``shard_params``); prompts of 4 x 16 tokens, whisper's 32 frames and
internvl's 8 patches.

* Each family on each mesh, MCA off: the prefill and 8 greedy decode
  steps' logits within 1e-5 of the reference's max |logit| and the same
  9 greedy tokens (the reference's top-2 gaps are asserted first); the
  loss (the mean over the data ranks) within 1e-5 relative; the
  gradients (averaged over the data ranks, gathered over "model")
  within 1e-5 of each leaf's largest against the reference and against
  the port's world of one.  The reference's MCA-off numbers do not
  depend on its mesh, so it runs those unsharded.  One FSDP step of
  ``jit_train_step`` on each mesh: loss and grad norm within 1e-5
  relative of the port's unsharded step.  Each rank's cache holds its
  heads or channels (Mamba-2's state and conv tail, RG-LRU's state,
  whisper's self and cross K/V; MLA's latent cache whole), and
  Mamba-2's gathered state and conv tail are the reference's after the
  8 steps.  The reduced Mamba-2's ``in_proj`` has 552 columns, so its
  halves (276) and quarters (138) cut through its ``[z | x | B | C |
  dt]`` segments.
* MCA on (v_proj and o_proj, block 16): layer 0's tier histogram of the
  prefill exactly the reference's under the same mesh (the hybrid's
  first attention layer, after two recurrent ones that draw nothing),
  after ``assert_routing_margins``; for whisper, its encoder layer and
  the cross attention alone on the same inputs (the decoder's cross
  attention reads the self attention's sampled output, so its routing
  in a prefill depends on the samples).
* Row-parallel MCA with a block split between ranks (d 96, block 32:
  ranks hold 48 or 24 columns): the block probabilities are the whole
  weight's, the ranks' parts sum to the unsplit product with the same
  samples within 1e-5 of its max, and the tier histogram and FLOPs are
  the reference's; the same for the per-token mode with ``tp="row"``
  and ``tp="col"``, whose estimates (summed or gathered over "model")
  stay within Lemma 1 over 64 keys.
* MCA on ``expert_ffn`` with the experts' columns split: FLOPs exactly
  the reference's ``moe_ffn`` under the mesh, and the per-expert
  estimates within Lemma 1 over 64 keys.
"""
import json
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from _torch_parity import assert_routing_margins, model_pair  # noqa: E402
from repro.core.policy import MCAConfig as JMCAConfig  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.policy import MCAConfig  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import named_leaves  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMS = {"mla": "minicpm3-4b", "ssm": "mamba2-2.7b",
        "hybrid": "recurrentgemma-9b", "encdec": "whisper-small",
        "vlm": "internvl2-1b"}
#: the MCA-on models: layer 0 alone (the hybrid's pattern of 3)
MCA_KW = {"mla": {"n_layers": 1}, "hybrid": {},
          "encdec": {"n_layers": 1, "n_encoder_layers": 1},
          "vlm": {"n_layers": 1}}
MCA = {"enabled": True, "alpha": 0.3, "block": 16,
       "sites": ["v_proj", "o_proj"]}
MOE_MCA = {"enabled": True, "alpha": 0.5, "block": 16,
           "sites": ["expert_ffn"]}
TAGS = ["12", "14", "22"]
B, S, STEPS = 4, 16, 8
# the projections: 4 rows of 32, d 96 (3 blocks of 32), f 64
PD, PF, PBLOCK = 96, 64, 32


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_REF = textwrap.dedent("""
    import json, pickle, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_config
    from repro.core.policy import MCAConfig, mca_project
    from repro.dist import context as dctx
    from repro.models import api as japi, build_model, reduced
    from repro.models import attention as jatt, ffn as jffn
    from repro.train.step import make_decode_step, make_prefill_step

    assert jax.device_count() == 4, jax.device_count()
    tmp = sys.argv[1]
    spec = json.load(open(f"{tmp}/spec.json"))
    d = dict(np.load(f"{tmp}/in.npz"))
    steps = spec["steps"]

    def mca_cfg(m):
        return MCAConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in m.items()})

    def make_mesh(tag):
        shape = (int(tag[0]), int(tag[1]))
        return jax.make_mesh(shape, ("data", "model"),
                             devices=jax.devices()[:shape[0] * shape[1]],
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)

    def build(arch, kw, mca=None):
        kw = dict(kw, dtype="float32")
        if mca is not None:
            kw["mca"] = mca_cfg(mca)
        model = build_model(reduced(get_config(arch), **kw))
        return model, model.init(jax.random.PRNGKey(0))

    def batch_of(fam):
        b = {"tokens": jnp.asarray(d["tokens"])}
        if fam == "encdec":
            b["frames"] = jnp.asarray(d["frames"])
        if fam == "vlm":
            b["patches"] = jnp.asarray(d["patches"])
        return b

    def seq(fam):
        return d["tokens"].shape[1] + (d["patches"].shape[1]
                                       if fam == "vlm" else 0)

    res, grads = {}, {}
    for fam, arch in spec["fams"].items():
        model, params = build(arch, {})
        b = batch_of(fam)
        s = seq(fam)
        cache, lg = jax.jit(make_prefill_step(model, s + steps,
                                              with_mca=False))(params, b)
        dec = jax.jit(make_decode_step(model))
        toks, lgs = [], [np.asarray(lg)]
        for i in range(steps):
            tok = jnp.argmax(lg[:, -1], -1).astype(jnp.int32)[:, None]
            toks.append(np.asarray(tok))
            lg, cache = dec(params, tok, cache, s + i)
            lgs.append(np.asarray(lg))
        toks.append(np.asarray(jnp.argmax(lg[:, -1], -1))[:, None])
        res[fam + "_tokens"] = np.concatenate(toks, 1)
        res[fam + "_logits"] = np.stack(lgs)
        if fam == "ssm":
            res["ssm_state"] = np.asarray(cache["layers"]["state"])
            res["ssm_conv"] = np.asarray(cache["layers"]["conv"])
        lb = dict(b, labels=jnp.asarray(d["labels"]))
        loss, g = jax.jit(jax.value_and_grad(
            lambda p: model.loss(p, lb, None)[0]))(params)
        res[fam + "_loss"] = np.asarray(loss)
        grads[fam] = jax.tree.map(np.asarray, g)

    for fam, kw in spec["mca_kw"].items():
        model, params = build(spec["fams"][fam], kw, spec["mca"])
        b = batch_of(fam)
        s = seq(fam)
        key = jax.random.PRNGKey(0)
        for tag in spec["tags"]:
            with dctx.use_mesh(make_mesh(tag)):
                if fam == "encdec":
                    est = jax.jit(lambda p, f: japi._encode(
                        p, model.cfg, f, jax.random.fold_in(key, 101))[1])(
                            params, b["frames"])
                    res[f"encdec_enc_hist{tag}"] = np.asarray(
                        est["tier_hist"])
                    cross = jax.tree.map(lambda a: a[0],
                                         params["dec_layers"]["cross"])
                    st = jax.jit(lambda p, h, e: jatt.gqa_attention(
                        p, model.cfg, h, pos=jnp.arange(h.shape[1])[None],
                        mca_key=key, causal=False, window=0, kv_x=e)[2])(
                            cross, jnp.asarray(d["mx"]), b["frames"])
                else:
                    st = jax.jit(lambda p, bb: model.prefill(
                        p, bb, s + steps, key)[2])(params, b)
            res[f"{fam}_hist{tag}"] = np.asarray(st["tier_hist"])

    moe, mp = build("olmoe-1b-7b", {}, spec["moe_mca"])
    ffn0 = jax.tree.map(lambda a: a[0], mp["layers"]["ffn"])
    for tag in spec["tags"]:
        with dctx.use_mesh(make_mesh(tag)):
            st = jax.jit(lambda p, x: jffn.moe_ffn(
                p, moe.cfg, x, mca_key=jax.random.PRNGKey(3))[2])(
                    ffn0, jnp.asarray(d["mx"]))
            res[f"moe_flops{tag}"] = np.array(
                [float(st["exact_flops"]), float(st["mca_flops"])])
            for mode in ("tiered", "per_token"):
                cfg = mca_cfg(dict(spec["proj_mca"], mode=mode))
                st = jax.jit(lambda x, w, imp: {
                    k: v for k, v in mca_project(
                        jax.random.PRNGKey(0), x, w, imp, x.shape[1], cfg,
                        "v_proj")[1].items()
                    if k in ("tier_hist", "mca_flops")})(
                        jnp.asarray(d["px"]), jnp.asarray(d["pw"]),
                        jnp.asarray(d["pimp"]))
                res[f"proj_{mode}{tag}"] = np.array(
                    np.asarray(st["tier_hist"]).tolist()
                    + [float(st["mca_flops"])])
    np.savez(f"{tmp}/ref.npz", **res)
    pickle.dump(grads, open(f"{tmp}/ref_grads.pkl", "wb"))
    print("OK")
""")

_WORLD = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def run(rank, world, port, tmp):
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        torch.set_num_threads(1)
        from repro_torch.core import amm, dispatch, policy, schedule
        from repro_torch.dist import context as dctx, sharding as shd
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import api, attention, build_model, ffn
        from repro_torch.optim import adamw
        from repro_torch.train.step import (jit_train_step,
                                            make_prefill_step,
                                            serve_step_shardings)
        spec = json.load(open(f"{tmp}/spec.json"))
        d = np.load(f"{tmp}/in.npz")
        steps = spec["steps"]
        imps = []
        orig_mca = attention.mca_project

        def spy_mca(key, x, w, imp, seq_len, cfg, site, tp=None):
            imps.append((imp.detach().double().numpy().ravel(), seq_len,
                         x.shape[-1] * (dctx.model_size()
                                        if tp == "row" else 1)))
            return orig_mca(key, x, w, imp, seq_len, cfg, site, tp=tp)

        attention.mca_project = spy_mca

        def load(name):
            cfg, params = torch.load(f"{tmp}/params_{name}.pt",
                                     weights_only=False)
            return build_model(cfg, device="cpu"), params

        def batch_of(fam, rows):
            b = {"tokens": torch.as_tensor(d["tokens"][rows])}
            if fam == "encdec":
                b["frames"] = torch.as_tensor(d["frames"][rows])
            if fam == "vlm":
                b["patches"] = torch.as_tensor(d["patches"][rows])
            return b

        def seq(fam):
            return d["tokens"].shape[1] + (d["patches"].shape[1]
                                           if fam == "vlm" else 0)

        for tag in (["12"] if world == 2 else ["14", "22"]):
            mesh = make_local_mesh(int(tag[0]), int(tag[1]), device="cpu")
            nm = mesh.shape["model"]
            mi = dctx.model_index(mesh)
            per = d["tokens"].shape[0] // mesh.shape["data"]
            r0 = dctx.axis_index(mesh, ("data",)) * per
            rows = slice(r0, r0 + per)
            res = {}

            def shard(model, params):
                p_sh = serve_step_shardings(mesh, model, {},
                                            torch.as_tensor(d["tokens"]))[0]
                return shd.shard_params(params, p_sh), p_sh

            for fam in spec["fams"]:
                model, params = load(fam)
                local, p_sh = shard(model, params)
                s = seq(fam)
                with torch.no_grad(), dctx.use_mesh(mesh):
                    cache, lg = make_prefill_step(
                        model, s + steps, with_mca=False)(
                            local, batch_of(fam, slice(None)))
                    toks, lgs = [], [lg.numpy()]
                    for i in range(steps):
                        tok = torch.argmax(lg[:, -1], -1).to(
                            torch.int32)[:, None]
                        toks.append(tok.numpy())
                        lg, cache = model.decode(local, tok, cache, s + i)
                        lgs.append(lg.numpy())
                    toks.append(torch.argmax(lg[:, -1], -1)[:, None].numpy())
                    res[fam + "_tokens"] = np.concatenate(toks, 1)
                    res[fam + "_logits"] = np.stack(lgs)
                    leaves = cache["layers"]
                    if fam == "encdec":
                        leaves = dict(leaves["self"],
                                      cross_k=leaves["cross_k"])
                    for k, v in leaves.items():
                        res[f"{fam}_shape_{k}"] = np.array(v.shape)
                    if fam == "ssm":
                        st, cv = leaves["state"], leaves["conv"]
                        dl = cv.shape[-1] - 2 * model.cfg.ssm_state
                        res["ssm_state"] = dctx.all_gather(
                            st, mesh, ("model",), 3).numpy()
                        res["ssm_conv"] = torch.cat([dctx.all_gather(
                            cv[..., :dl].contiguous(), mesh, ("model",), -1),
                            cv[..., dl:]], -1).numpy()
                lb = dict(batch_of(fam, rows),
                          labels=torch.as_tensor(d["labels"][rows]))
                with dctx.use_mesh(mesh):
                    (loss, _), g = adamw.value_and_grad(
                        lambda p, b, k: model.loss(p, b, k), local, lb)
                res[fam + "_loss"] = dctx.pmean_(
                    loss.detach().clone(), mesh, ("data",)).numpy()
                for t in adamw.leaves(g):
                    dctx.pmean_(t, mesh, ("data",))
                for i, t in enumerate(adamw.leaves(
                        shd.gather_params(g, p_sh))):
                    res[f"{fam}_g{i}"] = t.numpy()
                # one FSDP step of jit_train_step on the global batch
                gb = dict(batch_of(fam, slice(None)),
                          labels=torch.as_tensor(d["labels"]))
                step = jit_train_step(mesh, model, adamw.AdamWConfig(
                    lr=3e-4), gb, donate=False)
                f_sh = step.in_shardings[0]
                fp = shd.shard_params(params, f_sh)
                fs = adamw.init_state(fp, step.in_shardings[1]["m"], f_sh)
                with dctx.use_mesh(mesh):
                    _, _, m = step(fp, fs, gb)
                res[fam + "_step"] = np.array([float(m["total_loss"]),
                                               float(m["grad_norm"])])

            # MCA on: layer 0's routing
            for fam in spec["mca_kw"]:
                model, params = load(fam + "_mca")
                local, _ = shard(model, params)
                b = batch_of(fam, rows)
                imps.clear()
                with torch.no_grad(), dctx.use_mesh(mesh):
                    if fam == "encdec":     # the encoder; the cross attention
                        _, est = api._encode(local, model.cfg, b["frames"],
                                             amm.fold_in(0, 101))
                        res["encdec_enc_hist"] = est["tier_hist"].numpy()
                        h = torch.as_tensor(d["mx"][rows])
                        st = attention.gqa_attention(
                            local["dec_layers"][0]["cross"], model.cfg, h,
                            pos=torch.arange(h.shape[1])[None], mca_key=0,
                            causal=False, window=0, kv_x=b["frames"])[2]
                    else:
                        st = model.prefill(local, b, seq(fam) + steps, 0)[2]
                res[fam + "_hist"] = st["tier_hist"].numpy()
                for i, (imp, n, dd) in enumerate(imps):
                    res[f"{fam}_imp{i}"] = imp
                    res[f"{fam}_impmeta{i}"] = np.array([n, dd])

            # MCA on expert_ffn, the experts' columns split
            model, params = load("moe_mca")
            local, _ = shard(model, params)
            p0 = local["layers"][0]["ffn"]
            with torch.no_grad(), dctx.use_mesh(mesh):
                _, _, st = ffn.moe_ffn(p0, model.cfg, torch.as_tensor(
                    d["mx"][rows]), mca_key=3)
                res["moe_flops"] = np.array([float(st["exact_flops"]),
                                             float(st["mca_flops"])])
                # the per-expert estimate against the exact product
                full_up = params["layers"][0]["ffn"]["w_up"]
                xe = torch.as_tensor(d["xe"])
                e, cap = xe.shape[:2]
                se = torch.arange(e).repeat_interleave(cap)
                slot = torch.arange(cap).repeat(e)
                gate = torch.as_tensor(d["gate"])
                ests = [dctx.all_gather(ffn._mca_expert_matmul(
                    k, model.cfg, xe, p0["w_up"], se, slot, gate, cap,
                    16)[0], mesh, ("model",), -1) for k in range(64)]
                res["moe_err"] = torch.stack([torch.linalg.vector_norm(
                    y - torch.bmm(xe, full_up), dim=-1)
                    for y in ests]).mean(0).numpy()
                res["moe_held"] = np.array(p0["w_up"].shape)

            # the projections: split blocks, both modes
            x = torch.as_tensor(d["px"])[rows]
            w = torch.as_tensor(d["pw"])
            imp = torch.as_tensor(d["pimp"])[rows]
            dl, fl = w.shape[0] // nm, w.shape[1] // nm
            xr, wr = x[..., mi * dl:(mi + 1) * dl], w[mi * dl:(mi + 1) * dl]
            wc = w[:, mi * fl:(mi + 1) * fl]
            pm = spec["proj_mca"]
            with torch.no_grad(), dctx.use_mesh(mesh):
                for mode in ("tiered", "per_token"):
                    cfg = policy.MCAConfig(
                        enabled=True, alpha=pm["alpha"], block=pm["block"],
                        sites=tuple(pm["sites"]), mode=mode)
                    for tp, xx, ww in (("row", xr, wr), ("col", x, wc)):
                        errs = []
                        for k in range(64 if mode == "per_token" else 1):
                            y, st = policy.mca_project(
                                k, xx, ww, imp, x.shape[1], cfg, "v_proj",
                                tp=tp)
                            y = (dctx.psum(y, mesh, ("model",)) if tp == "row"
                                 else dctx.all_gather(y, mesh, ("model",),
                                                      -1))
                            errs.append(torch.linalg.vector_norm(
                                y - x @ w, dim=-1))
                        res[f"proj_{mode}_{tp}"] = np.array(
                            st["tier_hist"].tolist()
                            + [float(st["mca_flops"])])
                        res[f"proj_{mode}_{tp}_err"] = torch.stack(
                            errs).mean(0).numpy()
                # the ranks' parts of a split block against the unsplit
                # product with the same samples
                blk = pm["block"]
                x2, xr2 = x.reshape(-1, w.shape[0]), xr.reshape(-1, dl)
                xp, wp, probs, lbk = policy._tp_operands(xr2, wr, blk, "row",
                                                         mesh)
                ladder = schedule.tier_ladder(w.shape[0], blk, 4, 1)
                imp2 = imp.reshape(-1)
                caps = policy._caps_for(x2.shape[0], len(ladder),
                                        cfg.capacity_fracs)
                tier, tok_rank, _, _, _ = dispatch.route(
                    imp2, seq_len=x.shape[1], alpha=pm["alpha"],
                    d=w.shape[0], block=blk, ladder=ladder, caps=caps,
                    f=w.shape[1])
                whole = dispatch.tiered_mca_matmul(
                    5, x2, w, tier, imp2, ladder, caps, blk, probs=probs,
                    rank=tok_rank)
                part = dispatch.tiered_mca_matmul(
                    5, xp, wp, tier, imp2, ladder, caps, blk, probs=probs,
                    local_blocks=lbk, rank=tok_rank)
                res["split_whole"] = whole.numpy()
                res["split_sum"] = dctx.psum(part, mesh, ("model",)).numpy()
                res["split_probs"] = probs.numpy()
                res["split_probs_full"] = amm.block_probs(w, blk).numpy()
                res["split_blocks"] = np.array(lbk + (xp.shape[1],))
            np.savez(f"{tmp}/{tag}_rank{rank}.npz", **res)
            dist.barrier()
        dist.destroy_process_group()
        print(f"OK {world} {rank}", flush=True)

    if __name__ == "__main__":
        world, port, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
        mp.spawn(run, args=(world, port, tmp), nprocs=world, join=True)
""")


def _mca(m):
    return {k: tuple(v) if isinstance(v, list) else v for k, v in m.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference subprocess and the port's 2- and 4-rank worlds, run
    side by side; their outputs, and the port's unsharded gradients."""
    tmp = tmp_path_factory.mktemp("tpfam")
    rng = np.random.default_rng(0)
    pimp = (rng.uniform(0.0, 0.16, (B, 32))
            * np.array([1, 1, 0.5, 0.5])[:, None]).astype(np.float32)
    data = dict(
        tokens=rng.integers(1, 500, (B, S)).astype(np.int32),
        labels=rng.integers(0, 500, (B, S)).astype(np.int32),
        frames=rng.standard_normal((B, 32, 128)).astype(np.float32),
        patches=rng.standard_normal((B, 8, 128)).astype(np.float32),
        px=rng.standard_normal((B, 32, PD)).astype(np.float32),
        pw=rng.standard_normal((PD, PF)).astype(np.float32), pimp=pimp,
        mx=rng.standard_normal((B, S, 128)).astype(np.float32),
        xe=rng.standard_normal((4, 8, 128)).astype(np.float32),
        gate=rng.uniform(0.05, 1.0, 32).astype(np.float32))
    np.savez(tmp / "in.npz", **data)
    spec = {"fams": FAMS, "mca_kw": MCA_KW, "mca": MCA, "moe_mca": MOE_MCA,
            "proj_mca": {"enabled": True, "alpha": 0.3, "block": PBLOCK,
                         "sites": ["v_proj"]},
            "tags": TAGS, "steps": STEPS}
    (tmp / "spec.json").write_text(json.dumps(spec))
    models = {}
    for fam, arch in FAMS.items():
        _, _, tm, tp = model_pair(arch, dtype="float32")
        models[fam] = (tm, tp)
        torch.save((tm.cfg, tp), tmp / f"params_{fam}.pt")
    for fam, kw in MCA_KW.items():
        _, _, tm, tp = model_pair(FAMS[fam], dtype="float32",
                                  j_mca=JMCAConfig(**_mca(MCA)),
                                  t_mca=MCAConfig(**_mca(MCA)), **kw)
        torch.save((tm.cfg, tp), tmp / f"params_{fam}_mca.pt")
    _, _, tm, tp = model_pair("olmoe-1b-7b", dtype="float32",
                              j_mca=JMCAConfig(**_mca(MOE_MCA)),
                              t_mca=MCAConfig(**_mca(MOE_MCA)))
    torch.save((tm.cfg, tp), tmp / "params_moe_mca.pt")
    moe_mca = (tm.cfg, tp)
    (tmp / "ref.py").write_text(_REF)
    (tmp / "world.py").write_text(_WORLD)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    procs = {"ref": subprocess.Popen(
        [sys.executable, str(tmp / "ref.py"), str(tmp)],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)}
    for world in (2, 4):
        procs[world] = subprocess.Popen(
            [sys.executable, str(tmp / "world.py"), str(world),
             str(_free_port()), str(tmp)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    # the port's world of one, meanwhile: its gradients and a train step
    one, one_step = {}, {}
    for fam, (tm, tp) in models.items():
        b = {k: torch.as_tensor(data[k]) for k in ("tokens", "labels")}
        if fam == "encdec":
            b["frames"] = torch.as_tensor(data["frames"])
        if fam == "vlm":
            b["patches"] = torch.as_tensor(data["patches"])
        _, g = adamw.value_and_grad(lambda p, bb, k: tm.loss(p, bb, k), tp,
                                    b)
        one[fam] = list(named_leaves(g))
        _, _, m = make_train_step(tm, adamw.AdamWConfig(lr=3e-4))(
            tp, adamw.init_state(tp), b)
        one_step[fam] = (float(m["total_loss"]), float(m["grad_norm"]))
    for name, proc in procs.items():
        try:
            _, stderr = proc.communicate(timeout=400)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        assert proc.returncode == 0, f"{name}: {stderr[-4000:]}"
    ref_grads = pickle.load(open(tmp / "ref_grads.pkl", "rb"))
    out = {"ref": dict(np.load(tmp / "ref.npz")), "one": one,
           "one_step": one_step,
           "models": models, "moe": moe_mca, "data": data,
           "ref_grads": {fam: adamw.leaves(params_from_jax(g, device="cpu"))
                         for fam, g in ref_grads.items()}}
    for tag, n in (("12", 2), ("14", 4), ("22", 4)):
        out[tag] = [dict(np.load(tmp / f"{tag}_rank{r}.npz"))
                    for r in range(n)]
    return out


def _rows(tag, rank):
    per = B // int(tag[0])
    d = rank // int(tag[1])
    return slice(d * per, (d + 1) * per)


def _close(got, want, tol, what):
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= tol, f"{what}: {err:.2e} of max|want| (limit {tol})"


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("fam", list(FAMS))
def test_serve_logits_and_greedy_tokens(runs, fam, tag):
    """Prefill and 8 greedy decode steps on each mesh: logits within 1e-5
    of the reference's max |logit| on every rank's rows, the same 9
    greedy tokens (the reference's top-2 gap is asserted first, so a
    flip names its cause)."""
    ref = runs["ref"]
    lg = ref[fam + "_logits"][:, :, -1]                  # [steps+1, B, V]
    top = np.sort(lg, -1)
    gap = (top[..., -1] - top[..., -2]) / np.abs(lg).max()
    assert float(gap.min()) > 1e-4, f"a top-2 gap of {gap.min():.2e}"
    for rank, r in enumerate(runs[tag]):
        rows = _rows(tag, rank)
        _close(r[fam + "_logits"], ref[fam + "_logits"][:, rows], 1e-5,
               f"{fam} {tag}")
        np.testing.assert_array_equal(r[fam + "_tokens"],
                                      ref[fam + "_tokens"][rows])


def _cfg(runs, fam):
    return runs["models"][fam][0].cfg


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("fam", list(FAMS))
def test_cache_holds_the_rank_share(runs, fam, tag):
    """Each rank's decode cache holds its heads or channels: SSD state
    heads, conv channels and RG-LRU channels over "model", whisper's
    self and cross K/V heads, internvl's KV heads where they divide the
    axis (else all); MLA's latent cache whole.  Mamba-2's gathered state
    and conv tail are the reference's after the decode steps."""
    cfg = _cfg(runs, fam)
    nm, nd = int(tag[1]), int(tag[0])
    b = B // nd
    for rank, r in enumerate(runs[tag]):
        shapes = {k[len(fam) + 7:]: tuple(v) for k, v in r.items()
                  if k.startswith(fam + "_shape_")}
        if fam == "ssm":
            h, ph, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
            assert shapes["state"] == (cfg.n_layers, b, 1, h // nm, n, ph)
            assert shapes["conv"] == (cfg.n_layers, b, cfg.conv_width - 1,
                                      cfg.ssm_inner // nm + 2 * n)
            ref = runs["ref"]
            rows = _rows(tag, rank)
            _close(r["ssm_state"], ref["ssm_state"][:, rows], 1e-5,
                   "ssm state")
            _close(r["ssm_conv"], ref["ssm_conv"][:, rows], 1e-5,
                   "ssm conv")
        elif fam == "hybrid":
            assert shapes["h"][-1] == cfg.rnn_width // nm
            assert shapes["conv"][-1] == cfg.rnn_width // nm
            assert shapes["k"][-2] == 1              # one KV head: whole
        elif fam == "mla":
            assert shapes["ckv"][-1] == cfg.mla_kv_lora
            assert shapes["kr"][-1] == cfg.mla_qk_rope
        else:
            hkv = cfg.n_kv_heads
            want = hkv // nm if hkv % nm == 0 else hkv
            assert shapes["k"][-2] == want
            if fam == "encdec":
                assert shapes["cross_k"][-2] == want


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("fam", list(FAMS))
def test_loss_and_gathered_gradients(runs, fam, tag):
    """The loss (mean over the data ranks) within 1e-5 relative of the
    reference's; the gradients, averaged over the data ranks and
    gathered over "model", within 1e-5 of each leaf's largest against
    the reference and against the port's world of one."""
    one, ref_g = runs["one"][fam], runs["ref_grads"][fam]
    for r in runs[tag]:
        np.testing.assert_allclose(float(r[fam + "_loss"]),
                                   float(runs["ref"][fam + "_loss"]),
                                   rtol=1e-5)
        got, i = [], 0
        while f"{fam}_g{i}" in r:
            got.append(r[f"{fam}_g{i}"])
            i += 1
        assert len(got) == len(one) == len(ref_g) and len(got) > 10
        for (name, w1), wr, g in zip(one, ref_g, got):
            for want, what in ((w1.numpy(), "world of one"),
                               (wr.numpy(), "reference")):
                assert g.shape == want.shape, name
                lim = 1e-5 * max(float(np.abs(want).max()), 1e-12)
                err = float(np.abs(g - want).max())
                assert err <= lim, f"{name} vs {what}: {err:.2e} > {lim:.2e}"


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("fam", list(FAMS))
def test_fsdp_train_step_on_model_axes(runs, fam, tag):
    """``jit_train_step`` (FSDP, the default) takes every family on every
    mesh: one AdamW step on the global batch gives the loss and grad
    norm of the port's unsharded step within 1e-5 relative, on every
    rank."""
    loss, gnorm = runs["one_step"][fam]
    for r in runs[tag]:
        np.testing.assert_allclose(r[fam + "_step"], [loss, gnorm],
                                   rtol=1e-5)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("fam", list(MCA_KW))
def test_layer0_tier_hist_exact(runs, fam, tag):
    """MCA on v_proj and o_proj: layer 0's routing under the mesh equals
    the reference's (its importances do not depend on the samples drawn,
    which differ between the frameworks), after the margins check."""
    mca = MCAConfig(**_mca(MCA))
    ref = runs["ref"]
    for r in runs[tag]:
        calls, i = [], 0
        while f"{fam}_imp{i}" in r:
            n, d = r[f"{fam}_impmeta{i}"]
            calls.append((r[f"{fam}_imp{i}"], int(n), int(d), mca))
            i += 1
        assert len(calls) >= 2
        assert_routing_margins(calls)
        np.testing.assert_array_equal(r[fam + "_hist"],
                                      ref[f"{fam}_hist{tag}"])
        if fam == "encdec":
            np.testing.assert_array_equal(r["encdec_enc_hist"],
                                          ref[f"encdec_enc_hist{tag}"])


@pytest.mark.parametrize("tag", TAGS)
def test_split_block_row_parallel_mca(runs, tag):
    """d 96 in blocks of 32 over 2 or 4 ranks (48 or 24 columns each, so
    a block is split between two ranks): each rank's columns sit on the
    block grid, zero-padded to the blocks they touch; the probabilities
    are the whole weight's, the ranks' parts with the same samples sum
    to the unsplit product within 1e-5 of its max, and ``mca_project``
    (``tp="row"`` and ``"col"``) gives the reference's tier histogram
    and FLOPs."""
    nm = int(tag[1])
    dl = PD // nm
    for rank, r in enumerate(runs[tag]):
        mi = rank % nm
        first, count, width = r["split_blocks"]
        assert first == mi * dl // PBLOCK
        assert count == -(-(mi + 1) * dl // PBLOCK) - first
        assert width == count * PBLOCK
        np.testing.assert_allclose(r["split_probs"], r["split_probs_full"],
                                   rtol=1e-6)
        _close(r["split_sum"], r["split_whole"], 1e-5, "split block")
        for tp in ("row", "col"):
            np.testing.assert_array_equal(r[f"proj_tiered_{tp}"],
                                          runs["ref"][f"proj_tiered{tag}"])


@pytest.mark.parametrize("tag", TAGS)
def test_per_token_mca_on_a_model_axis(runs, tag):
    """The per-token mode with ``tp="row"`` (split blocks) and
    ``tp="col"``: the tier histogram and FLOPs exactly the reference's;
    every model rank draws the same samples from the whole weight's
    probabilities, so the parts (summed, or gathered) are one estimate,
    whose mean row error over 64 keys stays within 1.25 x Lemma 1."""
    data = runs["data"]
    x, w = data["px"], data["pw"]
    cfg = MCAConfig(enabled=True, alpha=0.3, block=PBLOCK,
                    sites=("v_proj",), mode="per_token")
    from repro_torch.core import schedule
    r_blocks = schedule.r_blocks_from_cols(schedule.r_cols_from_attention(
        torch.as_tensor(data["pimp"]), 32, cfg.alpha, PD), PBLOCK).numpy()
    for rank, r in enumerate(runs[tag]):
        rows = _rows(tag, rank)
        bound = (np.linalg.norm(x[rows], axis=-1) * np.linalg.norm(w)
                 / np.sqrt(r_blocks[rows]))
        for tp in ("row", "col"):
            np.testing.assert_array_equal(r[f"proj_per_token_{tp}"],
                                          runs["ref"][f"proj_per_token{tag}"])
            err = r[f"proj_per_token_{tp}_err"]
            assert np.all(err <= 1.25 * bound), float((err / bound).max())
            assert float(err.max()) > 0


@pytest.mark.parametrize("tag", TAGS)
def test_expert_ffn_mca_on_a_model_axis(runs, tag):
    """MCA on ``expert_ffn`` with each expert's columns split over
    "model": ``moe_ffn``'s exact and sampled FLOPs are the reference's
    under the mesh (the budgets come from the router gates, which do not
    depend on the samples), and each rank's columns, gathered, are an
    estimate of every expert's product whose mean row error over 64 keys
    stays within 1.25 x Lemma 1."""
    from repro_torch.core import schedule
    cfg, params = runs["moe"]
    data = runs["data"]
    xe = torch.as_tensor(data["xe"])
    e, cap, d = xe.shape
    imp = torch.as_tensor(data["gate"]).reshape(e, cap)
    r = schedule.r_blocks_from_cols(schedule.r_cols_from_attention(
        imp, 16, cfg.mca.alpha, d), cfg.mca.block_for(d)).numpy()
    w = params["layers"][0]["ffn"]["w_up"].numpy()
    bound = (np.linalg.norm(data["xe"], axis=-1)
             * np.linalg.norm(w, axis=(1, 2))[:, None] / np.sqrt(r))
    for rk in runs[tag]:
        np.testing.assert_array_equal(rk["moe_flops"],
                                      runs["ref"][f"moe_flops{tag}"])
        assert rk["moe_held"][-1] == cfg.d_ff // int(tag[1])
        err = rk["moe_err"]
        assert np.all(err <= 1.25 * bound), float((err / bound).max())
        assert float(err.max()) > 0
