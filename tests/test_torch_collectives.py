"""The port's multi-rank pieces on four CPU processes (gloo), against the
reference.

One 4-rank run for the module (``tests/_torch_gloo_worker.py``, started as
four processes that import torch and the port, never JAX); this process
makes the cases from numpy seeds and computes the reference's answers:

* ``compressed_psum`` equals the reference's under ``jax.vmap(...,
  axis_name=...)`` bitwise, on every rank;
* one decode step over caches whose sequence is split in 4 (ragged
  lengths, some ranks holding no key of a row; the LSE combine of kernels
  1 and 4's plain twins across ranks) is within fp32 5e-5 of the
  reference's unsplit ``decode_attention_ref`` / ``mla_latent_decode_ref``
  (GQA with a sliding window: of the port's unsplit twin), and the new
  rows land where one device writes them;
* reduced gemma-2b (fp32) on a 2 x 2 gloo mesh, params, cache and inputs by
  the rules, is within 1e-4 of ``repro.models.decode_step`` over three
  greedy steps, with the tokens equal;
* the last five ``local_map`` sites: reduced minitron-4b-mla
  (``mla.decode``), deepseek-v2-lite-16b (``moe.experts``), gdn-4b
  (``gdn.scan``), zamba2-1.2b (``ssm.step``) and llama-3.2-vision-11b
  (``attention.cross``) decode on the same 2 x 2 mesh within 1e-4 of
  ``repro.models.decode_step``, the greedy tokens equal;
* deepseek-v2-lite-16b's routed MoE where the capacity binds (a block on
  4 x 32 tokens and a whole prefill): the port on DTensors drops what the
  reference's one global capacity drops (the dropped counts are printed);
* the event engine with ``batch_layout="shard_map"`` on 2-rank groups
  replays ``tests/test_batched_dispatch.py``'s mixed-temperature scenario
  with the reference's rows and ``EngineStats``, each rank's banks holding
  half the rows;
* ``shard_map_replicas`` over a 1-D replica mesh steps a fold of 4 members
  as the reference's ``vmap_replicas(decode_step)`` steps the same 4
  replicas (logits and cache within fp32 1e-5), and as the whole fold does
  in one process;
* the training loss and every gradient of reduced gemma-2b and
  mamba2-780m (fp32) on the 2 x 2 mesh, reduced to the params' layout,
  are within 1e-4 (of each leaf's largest entry) of ``jax.value_and_grad``
  of the reference's loss (``forward`` + ``chunked_softmax_xent``, as its
  train step computes it) on the same params and batch, and of the plain
  tensors' (the ``local_map`` sites' partial gradients summed where they
  should be).
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
import repro.serving as jserving
from repro.core import EnergyModel as JEnergyModel
from repro.core.traces import TracedRequest as JTracedRequest
from repro.hw import H200_SXM as J_H200
from repro.models import moe as jmoe
from repro.kernels.decode_attn.ref import decode_attention_ref as j_decode_ref
from repro.kernels.mla_decode.ref import mla_latent_decode_ref as j_mla_ref
from repro.models.model import vmap_replicas as j_vmap_replicas
from repro.training.compression import compressed_psum as j_compressed_psum
from repro.training.losses import chunked_softmax_xent as j_xent
from repro_torch.configs import reduced_config
from repro_torch.kernels.decode_attn import decode_attention_ref

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
ARCH = "gemma-2b"
# the reduced configs whose decode runs the last five local_map sites
KINDS = ("minitron-4b-mla", "deepseek-v2-lite-16b", "gdn-4b", "zamba2-1.2b",
         "llama-3.2-vision-11b")


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")


def _to_numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _attn_cases(rng):
    """GQA (plain and windowed) and MLA decode over a 64-key cache split in
    4 (16 keys a rank); lengths 3 / 17 / 40 / 63 put rows 0 and 1 on one
    or two ranks only."""
    b, l, lengths = 4, 64, np.array([3, 17, 40, 63], np.int32)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    out = {}
    for name, window in (("gqa", 0), ("gqa_window", 20)):
        out[name] = {"queries": [f(b, 8, 32)], "new": [f(b, 2, 32), f(b, 2, 32)],
                     "caches": [f(b, l, 2, 32), f(b, l, 2, 32)], "lengths": lengths,
                     "scale": 32 ** -0.5, "window": window}
    out["mla"] = {"queries": [f(b, 4, 64), f(b, 4, 16)], "new": [f(b, 64), f(b, 16)],
                  "caches": [f(b, l, 64), f(b, l, 16)], "lengths": lengths,
                  "scale": 0.125, "window": 0}
    return out


def _written(c):
    """The caches with each row's new token at ``lengths`` (one device)."""
    bufs = [x.copy() for x in c["caches"]]
    for buf, new in zip(bufs, c["new"]):
        buf[np.arange(len(c["lengths"])), c["lengths"]] = new
    return bufs


def _gemma_case(rng, arch=ARCH):
    """Reduced ``arch`` (fp32) prefilled by the reference over ragged
    prompts (with encoder states for ``cross_attn``), and its next three
    greedy decode steps: the logits and tokens."""
    jcfg = _fp32(jconfigs.reduced_config(arch))
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    b, l = 4, 64
    prompts = rng.integers(1, jcfg.vocab_size, (b, 40)).astype(np.int32)
    plens = np.array([5, 20, 33, 40], np.int32)
    cache = jmodels.init_cache(jcfg, b, l)
    enc = ({"enc_states": jnp.asarray(rng.standard_normal(
        (b, jcfg.n_media_tokens, jcfg.d_model)).astype(np.float32))}
        if jcfg.n_media_tokens else {})
    lg, cache, lengths = jmodels.prefill(params, jcfg, jnp.asarray(prompts), cache,
                                         prompt_lengths=jnp.asarray(plens), **enc)
    token = jnp.argmax(lg, axis=-1).astype(jnp.int32)
    case = {"cfg": _fp32(reduced_config(arch)), "params": _to_numpy(params),
            "cache": _to_numpy(cache), "token": np.asarray(token),
            "lengths": np.asarray(lengths), "steps": 3}
    want_logits, want_tokens = [], []
    for _ in range(case["steps"]):
        lg, cache, lengths = jmodels.decode_step(params, jcfg, token, cache, lengths)
        token = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        want_logits.append(np.asarray(lg))
        want_tokens.append(np.asarray(token))
    return case, {"logits": want_logits, "tokens": want_tokens}


def _drops(params, x, cfg, shards=1):
    """The (token, slot) entries the reference's capacity dispatch drops in
    ``moe_mlp(params, x)`` (its routing in numpy on its own gates), with one
    capacity over the whole batch, or (``shards`` > 1) with each batch shard
    ranking and capping its own entries, as a per-shard dispatch would."""
    b, s, d = x.shape
    gates = np.asarray(jax.nn.softmax(jnp.asarray(x.reshape(b * s, d)) @ params["router"],
                                      axis=-1))
    topi = np.asarray(jax.lax.top_k(jnp.asarray(gates), cfg.moe_top_k)[1])
    dropped = set()
    per = b * s // shards
    for r in range(shards):
        flat = topi[r * per:(r + 1) * per].reshape(-1)
        cap = jmoe._capacity(cfg, per)
        seen = np.zeros(cfg.n_routed_experts, int)
        for i, e in enumerate(flat):
            if seen[e] >= cap:
                dropped.add(r * per * cfg.moe_top_k + i)
            seen[e] += 1
    return dropped


def _moe_case(rng):
    """deepseek-v2-lite-16b (fp32, reduced: 8 experts, top 2) where the
    capacity binds: its first routed MoE block on 4 x 32 tokens (capacity
    40 over the batch, 20 a data shard), and a whole prefill of the same
    token count. -> the case, the reference's outputs and its dropped
    entries (and those a per-shard capacity would drop)."""
    arch = "deepseek-v2-lite-16b"
    jcfg = _fp32(jconfigs.reduced_config(arch))
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(3))
    block = next(jax.tree.map(lambda a: a[0], st[name]["moe"])
                 for st in params["stages"] for name in st if "moe" in st[name])
    x = (rng.standard_normal((4, 32, jcfg.d_model)) * 2.0).astype(np.float32)
    out, _ = jmoe.moe_mlp(block, jnp.asarray(x), jcfg)
    tokens = rng.integers(1, jcfg.vocab_size, (4, 32)).astype(np.int32)
    lg, _, _ = jmodels.prefill(params, jcfg, jnp.asarray(tokens),
                               jmodels.init_cache(jcfg, 4, 32))
    case = {"cfg": _fp32(reduced_config(arch)), "params": _to_numpy(params),
            "block": _to_numpy(block), "x": x, "tokens": tokens}
    blk = _to_numpy(block)
    return case, {"block": np.asarray(out), "prefill": np.asarray(lg),
                  "dropped": _drops(blk, x, jcfg), "dropped_per_shard": _drops(blk, x, jcfg, 2)}


def _replay_case(rng):
    """``tests/test_batched_dispatch.py``'s multi-device scenario: four
    reduced gemma-2b replicas of batch 2, ``max_seq_len`` 64, jsq,
    ``fast_path_min`` 2, 8 requests of 16 tokens, every third at
    temperature 0.7; the reference's rows ``[output, finish_s, energy_j]``
    and ``EngineStats`` from its in-process (vmap) replay, which that test
    holds equal to its ``shard_map`` replay."""
    jcfg = jconfigs.reduced_config(ARCH)
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    reqs = []
    for i in range(8):
        r = np.random.default_rng(10 + i + 16)
        reqs.append((r.integers(1, 100, 16).astype(np.int32), 0.7 if i % 3 == 0 else 0.0))
    spec = jserving.FleetSpec(replicas=tuple(
        jserving.ReplicaSpec(name=f"r{i}", arch=ARCH, clock=jserving.ClockSpec(mode="lock"),
                             decode=jserving.PoolSpec(batch=2), max_seq_len=64,
                             prefill_chunk_tokens=64)
        for i in range(4)), router="jsq")
    fleet = jserving.Fleet.from_spec(spec, emodel=JEnergyModel(J_H200), params_for={ARCH: params})
    trace = [JTracedRequest(arrival_s=0.0, prompt=p, max_new_tokens=4, bucket="mixed",
                            temperature=t) for p, t in reqs]
    done = fleet.run_trace(trace, engine_opts={"fast_path_min": 2, "batch_layout": "vmap"})
    rows = json.dumps([[r.output, r.ledger.finish_s, r.energy_j]
                       for r in sorted(done, key=lambda r: r.uid)])
    stats = fleet.last_engine_stats.as_dict()
    stats.pop("fused_decode_wall")
    case = {"arch": ARCH, "cfg": reduced_config(ARCH), "params": _to_numpy(params),
            "requests": reqs}
    return case, {"rows": rows, "stats": stats, "temps": [t for _, t in reqs]}


def _replica_case(rng):
    """A fold of 4 members x 2 rows (member-major; a cache leaf's rows on dim
    1) and the reference's answer: ``vmap_replicas(decode_step)`` over the
    same 4 replicas stacked on a leading axis."""
    jcfg = _fp32(jconfigs.reduced_config(ARCH))
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(1))
    k, rows = 4, 2
    b = k * rows
    cache = jmodels.init_cache(jcfg, b, 32)
    prompts = rng.integers(1, jcfg.vocab_size, (b, 12)).astype(np.int32)
    _, cache, lengths = jmodels.prefill(params, jcfg, jnp.asarray(prompts), cache)
    token = rng.integers(1, jcfg.vocab_size, (b,)).astype(np.int32)
    stack = lambda a: jnp.moveaxis(a.reshape(a.shape[:1] + (k, rows) + a.shape[2:]), 1, 0)
    unstack = lambda a: np.asarray(jnp.moveaxis(a, 0, 1).reshape((a.shape[1], b)
                                                                  + a.shape[3:]))
    step = j_vmap_replicas(lambda p, t, c, ln: jmodels.decode_step(p, jcfg, t, c, ln), 4)
    lg, new, _ = step(params, jnp.asarray(token).reshape(k, rows), jax.tree.map(stack, cache),
                      lengths.reshape(k, rows))
    case = {"cfg": _fp32(reduced_config(ARCH)), "params": _to_numpy(params),
            "cache": _to_numpy(cache), "lengths": np.asarray(lengths), "token": token}
    return case, {"logits": np.asarray(lg).reshape(b, -1),
                  "cache": jax.tree.map(unstack, new)}


def _grad_case(rng, arch):
    """Reduced ``arch`` (fp32) and one batch, with the reference's loss and
    gradients: ``jax.value_and_grad`` of its train step's loss."""
    jcfg = _fp32(jconfigs.reduced_config(arch))
    params = jmodels.init_params(jcfg, jax.random.PRNGKey(2))
    tokens = rng.integers(1, jcfg.vocab_size, (4, 16)).astype(np.int32)
    batch = {"inputs": tokens, "labels": np.roll(tokens, -1, axis=1)}

    def loss(p):
        h = jmodels.forward(p, jcfg, jnp.asarray(batch["inputs"]), remat=False)
        return j_xent(h, p["embed"]["table"], jnp.asarray(batch["labels"]), chunk=512,
                      final_softcap=jcfg.final_softcap)

    value, grads = jax.value_and_grad(loss)(params)
    case = {"cfg": _fp32(reduced_config(arch)), "params": _to_numpy(params), "batch": batch}
    return case, {"loss": float(value), "grads": _to_numpy(grads)}


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    rng = np.random.default_rng(0)
    work = tmp_path_factory.mktemp("gloo")
    gemma, gemma_want = _gemma_case(rng)
    kinds = {a: _gemma_case(rng, a) for a in KINDS}
    moe, moe_want = _moe_case(rng)
    replay, replay_want = _replay_case(rng)
    replicas, replicas_want = _replica_case(rng)
    grads = {a: _grad_case(rng, a) for a in (ARCH, "mamba2-780m")}
    cases = {"psum": [rng.standard_normal((WORLD, n)).astype(np.float32) * s
                      for n, s in ((1000, 1.0), (37, 1e-3), (4096, 50.0))],
             "attn": _attn_cases(rng), "gemma": gemma, "replicas": replicas,
             "kinds": {a: c for a, (c, _) in kinds.items()}, "moe": moe, "replay": replay,
             "grads": {a: c for a, (c, _) in grads.items()}}
    with open(work / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "_torch_gloo_worker.py"),
                               str(r), str(WORLD), str(work)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    got = []
    for r in range(WORLD):
        with open(work / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    want = {"gemma": gemma_want, "replicas": replicas_want,
            "kinds": {a: w for a, (_, w) in kinds.items()}, "moe": moe_want,
            "replay": replay_want, "grads": {a: w for a, (_, w) in grads.items()}}
    return cases, got, want


def test_workers_import_no_jax():
    src = (ROOT / "tests" / "_torch_gloo_worker.py").read_text()
    assert "jax" not in src.replace("JAX", "") and "import repro." not in src


def test_compressed_psum_is_the_reference_bitwise(gloo_run):
    cases, got, _ = gloo_run
    for i, x in enumerate(cases["psum"]):
        want = np.asarray(jax.vmap(lambda v: j_compressed_psum(v, "i"), axis_name="i")(
            jnp.asarray(x)))
        for r in range(WORLD):
            np.testing.assert_array_equal(got[r]["psum"][i], want[r])


@pytest.mark.parametrize("name", ["gqa", "gqa_window", "mla"])
def test_split_sequence_lse_combine_equals_unsplit(gloo_run, name):
    cases, got, _ = gloo_run
    c = cases["attn"][name]
    bufs = _written(c)
    vl = c["lengths"] + 1
    if name == "mla":
        want = np.asarray(j_mla_ref(jnp.asarray(c["queries"][0]), jnp.asarray(c["queries"][1]),
                                    jnp.asarray(bufs[0]), jnp.asarray(bufs[1]),
                                    jnp.asarray(vl), c["scale"]))
    elif c["window"]:
        want = decode_attention_ref(torch.from_numpy(c["queries"][0]),
                                    torch.from_numpy(bufs[0]), torch.from_numpy(bufs[1]),
                                    torch.from_numpy(vl), c["scale"],
                                    window=c["window"]).numpy()
    else:
        want = np.asarray(j_decode_ref(jnp.asarray(c["queries"][0]), jnp.asarray(bufs[0]),
                                       jnp.asarray(bufs[1]), jnp.asarray(vl), c["scale"]))
    for r in range(WORLD):
        np.testing.assert_allclose(got[r][name]["ctx"], want, rtol=0, atol=5e-5)
        for g, w in zip(got[r][name]["caches"], bufs):
            np.testing.assert_array_equal(g, w)


def test_gemma_decode_on_a_2x2_mesh_matches_the_reference(gloo_run):
    _, got, want = gloo_run
    for r in range(WORLD):
        for g, w in zip(got[r]["gemma"]["logits"], want["gemma"]["logits"]):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
        for g, w in zip(got[r]["gemma"]["tokens"], want["gemma"]["tokens"]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("arch", KINDS)
def test_block_kinds_decode_on_a_2x2_mesh_match_the_reference(gloo_run, arch):
    """The last five ``local_map`` sites on DTensors (``mla.decode``,
    ``moe.experts``, ``gdn.scan``, ``ssm.step``, ``attention.cross``):
    three greedy decode steps of reduced ``arch`` on the 2 x 2 mesh within
    fp32 1e-4 of ``repro.models.decode_step``, the tokens equal."""
    _, got, want = gloo_run
    for r in range(WORLD):
        g = got[r]["kinds"][arch]
        for lg, w in zip(g["logits"], want["kinds"][arch]["logits"]):
            np.testing.assert_allclose(lg, w, rtol=0, atol=1e-4)
        for t, w in zip(g["tokens"], want["kinds"][arch]["tokens"]):
            np.testing.assert_array_equal(t, w)


def test_moe_capacity_binds_and_drops_what_the_reference_drops(gloo_run, capsys):
    """deepseek-v2-lite-16b's routed MoE on DTensors, tokens split over the
    data axis, where the capacity binds: the reference drops entries, a
    per-shard capacity would drop another set, and the port (one capacity
    over the whole batch, entries ranked after the shards before) gives the
    reference's block output and prefill logits within fp32 1e-4."""
    _, got, want = gloo_run
    ref = want["moe"]
    with capsys.disabled():
        print(f"\nMoE capacity: the reference drops {len(ref['dropped'])} of "
              f"{4 * 32 * 2} entries; a per-shard capacity would drop "
              f"{len(ref['dropped_per_shard'])}, {len(ref['dropped'] ^ ref['dropped_per_shard'])} "
              f"of them other entries")
    assert ref["dropped"] and ref["dropped"] != ref["dropped_per_shard"]
    for r in range(WORLD):
        np.testing.assert_allclose(got[r]["moe"]["block"], ref["block"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[r]["moe"]["prefill"], ref["prefill"], rtol=0, atol=1e-4)


def test_sharded_bank_replay_gives_the_reference_rows(gloo_run):
    """``batch_layout="shard_map"`` on two gloo ranks (ranks 0-1 and 2-3
    each replay on their own group): a mixed-temperature trace of four
    reduced gemma-2b replicas gives the reference's rows and
    ``EngineStats``, key for key, on every rank; each rank's banks hold
    ``p2 / 2 x B`` rows of their members, and the restacks moved rows
    across ranks."""
    _, got, want = gloo_run
    ref = want["replay"]
    assert 0.7 in ref["temps"] and ref["stats"]["batched_decode_calls"] > 0
    for r in range(WORLD):
        g = got[r]["replay"]
        assert g["rows"] == ref["rows"]
        assert g["stats"] == ref["stats"]
        assert g["banks"]
        for size, first, local, rows, batch in g["banks"]:
            assert local == size // 2 and rows == local * batch
            assert first == (r % 2) * local
        assert g["received"] > 0


def test_shard_map_replicas_steps_the_fold(gloo_run):
    _, got, want = gloo_run
    ref = want["replicas"]
    for r in range(WORLD):
        rep = got[r]["replicas"]
        np.testing.assert_allclose(rep["logits"], ref["logits"], rtol=0, atol=1e-5)
        jax.tree.map(lambda g, w: np.testing.assert_allclose(g, w, rtol=0, atol=1e-5),
                     rep["cache"], ref["cache"])
        np.testing.assert_allclose(rep["logits"], rep["want"], rtol=0, atol=1e-5)
        assert rep["cache_diff"] <= 1e-5


@pytest.mark.parametrize("arch", [ARCH, "mamba2-780m"])
def test_train_gradients_on_a_2x2_mesh_match_the_reference(gloo_run, arch):
    _, got, want = gloo_run
    ref = want["grads"][arch]
    for r in range(WORLD):
        g = got[r]["grads"][arch]
        assert abs(g["loss"][1] - ref["loss"]) <= 1e-5 * max(1.0, abs(ref["loss"]))
        leaves = []

        def check(path, a, w):
            err = float(np.abs(a - w).max() / np.abs(w).max())
            leaves.append(path)
            assert a.shape == w.shape and err <= 1e-4, (jax.tree_util.keystr(path), err)

        jax.tree_util.tree_map_with_path(check, g["tree"], ref["grads"])
        assert len(leaves) == g["leaves"] > 5


@pytest.mark.parametrize("arch", [ARCH, "mamba2-780m"])
def test_train_gradients_on_a_2x2_mesh_equal_plain(gloo_run, arch):
    _, got, _ = gloo_run
    for r in range(WORLD):
        g = got[r]["grads"][arch]
        assert abs(g["loss"][1] - g["loss"][0]) <= 1e-5 * max(1.0, abs(g["loss"][0]))
        assert g["leaves"] > 5 and g["rel_err"] <= 1e-4, g
