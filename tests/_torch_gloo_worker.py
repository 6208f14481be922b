"""One rank of ``tests/test_torch_collectives.py``'s 4-rank gloo run.

    python tests/_torch_gloo_worker.py RANK WORLD DIR

Joins a gloo group through ``DIR/store``, reads the cases the test wrote to
``DIR/cases.pkl`` (numpy only: this process imports torch and the port,
never JAX), runs each on its shard of the world and writes what it got to
``DIR/rank{RANK}.pkl``:

* ``psum``: ``compressed_psum`` of this rank's row of each case;
* ``gqa`` / ``mla``: one decode step's write and attention over caches whose
  sequence is split over a 1-D ``("model",)`` mesh of the 4 ranks
  (``models.attention.decode_over_split_cache``, kernels 1 and 4's plain
  twins with their log-sum-exp), gathered whole;
* ``gemma``: reduced gemma-2b (fp32) greedy decode steps on a 2 x 2
  ``("data", "model")`` mesh, params, cache and inputs laid out by the
  rules: each step's logits and tokens; ``kinds``: the same for reduced
  minitron-4b-mla, deepseek-v2-lite-16b, gdn-4b, zamba2-1.2b and
  llama-3.2-vision-11b (the ``local_map`` sites of the other block kinds);
* ``moe``: deepseek-v2-lite-16b's first routed MoE block and a whole
  prefill on the 2 x 2 mesh, tokens split over ``data``, where the
  capacity binds;
* ``replay``: the event engine's ``shard_map`` replay on 2-rank groups
  (ranks 0-1, 2-3): rows, counters and the banks' local rows;
* ``replicas``: one ``decode_step`` over a fold of 4 members x 2 rows laid
  out by ``shard_map_replicas`` on a 1-D replica mesh: its logits and new
  cache (the test holds them to the reference's ``vmap_replicas``), and the
  same step on the whole fold in this process;
* ``grads``: the training loss and every parameter's gradient of reduced
  gemma-2b and mamba2-780m (fp32) on the 2 x 2 mesh, params and batch by
  the rules, the gradients reduced to the params' layout (``reduce_like``)
  and gathered (the test holds them to the gradients of the
  reference's loss), and against the same on plain tensors in this
  process.
"""
import pickle
import sys

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _t(a):
    return torch.from_numpy(a.copy())


def main(rank: int, world: int, workdir: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=world)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels.decode_attn import decode_attention
    from repro_torch.kernels.mla_decode import mla_latent_decode
    from repro_torch.launch import mesh as M
    from repro_torch.launch import sharding as S
    from repro_torch.models import (
        cache_from_numpy,
        decode_step,
        init_cache,
        params_from_numpy,
        prefill,
        shard_map_replicas,
    )
    from repro_torch.models.moe import moe_mlp
    from repro_torch.models.attention import decode_over_split_cache
    from repro_torch.training import tree as T
    from repro_torch.training.compression import compressed_psum
    from repro_torch.training.train import reduce_like, value_and_grad

    with open(f"{workdir}/cases.pkl", "rb") as f:
        cases = pickle.load(f)
    out = {"psum": [compressed_psum(_t(x[rank]), dist.group.WORLD).numpy()
                    for x in cases["psum"]]}

    seq = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
    rep, split = (Replicate(),), (Shard(1),)

    def place(a, pl):
        return DTensor.from_local(_t(a), seq, rep, run_check=False).redistribute(seq, pl)

    for name, c in cases["attn"].items():
        qs = [place(q, rep) for q in c["queries"]]
        news = [place(n, rep) for n in c["new"]]
        caches = [place(b, split) for b in c["caches"]]
        if name.startswith("mla"):
            attend = lambda q, b, vl, c=c: mla_latent_decode(q[0], q[1], b[0], b[1], vl,
                                                              scale=c["scale"],
                                                              return_lse=True)
        else:
            attend = lambda q, b, vl, c=c: decode_attention(q[0], b[0], b[1], vl,
                                                             scale=c["scale"],
                                                             window=c["window"],
                                                             return_lse=True)
        ctx = decode_over_split_cache(name, attend, qs, news, caches,
                                      place(c["lengths"], rep), window=c["window"])
        out[name] = {"ctx": ctx.full_tensor().numpy(),
                     "caches": [b.full_tensor().numpy() for b in caches]}

    mesh = M.make_host_mesh(model_axis=2)

    def on_mesh(params, cfg):
        fsdp = S.needs_fsdp(cfg, mesh)
        return S.distribute(params, S.param_shardings(params, mesh, fsdp=fsdp), mesh)

    def greedy_steps(g):
        cfg = g["cfg"]
        params = on_mesh(params_from_numpy(g["params"], cfg, device="cpu"), cfg)
        cache = cache_from_numpy(g["cache"], device="cpu")
        cache = S.distribute(cache, S.cache_shardings(cache, mesh), mesh)
        token, lengths = _t(g["token"]), _t(g["lengths"])
        logits, tokens = [], []
        with torch.no_grad():
            for _ in range(g["steps"]):
                b = S.distribute({"t": token, "l": lengths},
                                 S.batch_shardings({"t": token, "l": lengths}, mesh), mesh)
                lg, cache, _ = decode_step(params, cfg, b["t"], cache, b["l"])
                lg = lg.full_tensor()
                token = torch.argmax(lg, dim=-1).to(torch.int32)
                lengths = lengths + 1
                logits.append(lg.numpy())
                tokens.append(token.numpy())
        return {"logits": logits, "tokens": tokens}

    out["gemma"] = greedy_steps(cases["gemma"])
    out["kinds"] = {arch: greedy_steps(g) for arch, g in cases["kinds"].items()}

    m = cases["moe"]
    cfg = m["cfg"]
    block = S.distribute(T.map(_t, m["block"]),
                         S.param_shardings(T.map(_t, m["block"]), mesh, fsdp=False), mesh)
    params = on_mesh(params_from_numpy(m["params"], cfg, device="cpu"), cfg)
    cache = init_cache(cfg, 4, 32, device="cpu")
    cache = S.distribute(cache, S.cache_shardings(cache, mesh), mesh)
    inputs = S.distribute({"x": _t(m["x"]), "t": _t(m["tokens"])},
                          S.batch_shardings({"x": _t(m["x"]), "t": _t(m["tokens"])}, mesh), mesh)
    with torch.no_grad():
        y = moe_mlp(block, inputs["x"], cfg).full_tensor()
        lg, _, _ = prefill(params, cfg, inputs["t"], cache)
    out["moe"] = {"block": y.numpy(), "prefill": lg.full_tensor().numpy()}

    r = cases["replicas"]
    cfg = r["cfg"]
    params = params_from_numpy(r["params"], cfg, device="cpu")
    fold = cache_from_numpy(r["cache"], device="cpu")
    whole = cache_from_numpy(r["cache"], device="cpu")
    n = len(T.leaves(fold))
    step = shard_map_replicas(lambda p, t, c, ln: decode_step(p, cfg, t, c, ln), 4,
                              in_dims=(0, 1, 0), out_dims=(0,) + (1,) * n + (0,))
    with torch.no_grad():
        lg, new, _ = step(params, _t(r["token"]), fold, _t(r["lengths"]))
        want, _, _ = decode_step(params, cfg, _t(r["token"]), whole, _t(r["lengths"]))
    out["replicas"] = {
        "logits": lg.numpy(), "want": want.numpy(),
        "cache": T.map(lambda t: t.numpy(), new),
        "cache_diff": max(float((a - b).abs().max()) for a, b in zip(T.leaves(new),
                                                                     T.leaves(whole)))}
    out["grads"] = {}
    for arch, c in cases["grads"].items():
        cfg = c["cfg"]
        params = params_from_numpy(c["params"], cfg, device="cpu")
        batch = {k: _t(v) for k, v in c["batch"].items()}
        loss0, g0 = value_and_grad(params, cfg, batch, remat=False)
        dparams = S.distribute(params, S.param_shardings(params, mesh, fsdp=False), mesh)
        dbatch = S.distribute(batch, S.batch_shardings(batch, mesh), mesh)
        loss1, g1 = value_and_grad(dparams, cfg, dbatch, remat=False)
        g1 = T.unflatten(g1, [reduce_like(b, p).full_tensor()
                              for b, p in zip(T.leaves(g1), T.leaves(dparams))])
        errs = [float((b - a).abs().max() / a.abs().max())
                for a, b in zip(T.leaves(g0), T.leaves(g1))]
        out["grads"][arch] = {"loss": (float(loss0), float(loss1.full_tensor())),
                              "tree": T.map(lambda t: t.numpy(), g1),
                              "rel_err": max(errs), "leaves": len(errs),
                              "worst": max(zip(errs, T.paths(g0)))}
    if "replay" in cases:
        out["replay"] = _replay(cases["replay"], rank, world)
    with open(f"{workdir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _replay(c, rank: int, world: int) -> dict:
    """The event engine's replay with ``batch_layout="shard_map"`` on a group
    of 2 ranks (ranks 2k and 2k + 1 of the world): four reduced gemma-2b
    replicas, the bank split over the two. -> the finished requests' rows
    ``[output, finish_s, energy_j]``, the engine's counters and, for every
    bank it stepped, its members, the rows this rank holds and the batch."""
    import json

    import numpy as np

    from repro_torch.core import EnergyModel
    from repro_torch.core.traces import TracedRequest
    from repro_torch.hw import H200_SXM
    from repro_torch.models import params_from_numpy
    from repro_torch.serving import (ClockSpec, EventDrivenFleet, Fleet, FleetSpec, PoolSpec,
                                     ReplicaSpec)
    from repro_torch.serving import events as ev

    groups = [dist.new_group([r, r + 1]) for r in range(0, world, 2)]
    group = groups[rank // 2]
    cfg = c["cfg"]
    spec = FleetSpec(replicas=tuple(
        ReplicaSpec(name=f"r{i}", arch=c["arch"], clock=ClockSpec(mode="lock"),
                    decode=PoolSpec(batch=2), max_seq_len=64, prefill_chunk_tokens=64)
        for i in range(4)), router="jsq")
    params = params_from_numpy(c["params"], cfg, device="cpu")
    fleet = Fleet.from_spec(spec, emodel=EnergyModel(H200_SXM), params_for={c["arch"]: params},
                            device="cpu")
    trace = [TracedRequest(arrival_s=0.0, prompt=np.asarray(p), max_new_tokens=4,
                           bucket="mixed", temperature=t) for p, t in c["requests"]]
    eng = EventDrivenFleet(fleet, fast_path_min=2, batch_layout="shard_map",
                           process_group=group)
    done = eng.run(trace)
    rows = [[r.output, r.ledger.finish_s, r.energy_j] for r in sorted(done, key=lambda r: r.uid)]
    banks = [(b.size, b.first, b.local, b.tree["stages"][0]["b0"]["k"].shape[1], b.batch)
             for entry in ev._PROGRAM_CACHE.values() if isinstance(entry, ev._BankSet)
             for b in entry.banks]
    stats = eng.stats.as_dict()
    stats.pop("fused_decode_wall")
    return {"rows": json.dumps(rows), "stats": stats, "banks": banks,
            "received": eng.bank_rows_received}


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
