"""The port's prefix sharing and copy-on-write against the JAX package.

Reduced gemma-2b (plus qwen3-4b and minicpm-2b for the suffix prefill),
weights from ``repro.models.init_params`` through numpy, on the CPU:

* ``prefill_suffix`` against ``repro.models.prefill_suffix`` (logits and
  cache rows, fp32 1e-4), and against a full prefill of the whole prompt;
* the engine-level cases of ``tests/test_prefix.py`` and the dense / paged /
  paged+COW equivalence of ``tests/test_paged_cache.py`` on the port's
  ``ServingEngine``, each run beside the reference's engine: equal token
  streams, and equal ``PrefixStats``;
* ``serve_prefix``'s recipe through ``Fleet`` on the event engine, dense,
  paged and cow: tokens, ledger stamps, modelled and measured joules,
  ``PrefixStats``, ``EngineStats`` and the decode pools' traffic equal to
  the reference's replay, and the recipe's smoke run with its assertions
  and the reference's sha256.
"""
import dataclasses
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as R
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.core.energy import EnergyModel as JEnergyModel
from repro.hw import H200_SXM as J_H200
from repro.serving import ClockController as JController
from repro.serving import ServingEngine as JEngine
import repro_torch.models as T
from repro_torch.benchmarks import serve_prefix as t_serve_prefix
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.energy import EnergyModel
from repro_torch.hw import H200_SXM
from repro_torch.serving import ClockController, EngineStats, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import benchmarks.serve_prefix as j_serve_prefix  # noqa: E402

ARCH = "gemma-2b"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are tiny: torch's intra-op threads only spin
    on them, taking cores from the other workers of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(arch):
    jcfg = jax_reduced_config(arch)
    jp = R.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced_config(arch)
    return jcfg, jp, cfg, T.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                              device="cpu")


@pytest.fixture(scope="module")
def weights():
    return _weights(ARCH)


# --------------------------------------------------------- suffix prefill
@pytest.mark.parametrize("prefix_len", [16, 32])
@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-4b", "minicpm-2b"])
def test_prefill_suffix_matches_reference(arch, prefix_len):
    """A 40-token prompt prefilled whole, then its last ``40 - prefix_len``
    tokens prefilled again as a suffix over the first ``prefix_len`` cache
    rows: the port's logits and cache rows equal the reference's
    ``prefill_suffix`` (fp32 1e-4), and the suffix's logits equal the full
    prefill's (the math is position for position the same)."""
    jcfg, jp, cfg, tp = _weights(arch)
    rng = np.random.default_rng(prefix_len)
    prompt = rng.integers(1, 100, 40).astype(np.int32)
    full = np.zeros((1, 64), np.int32)
    full[0, :40] = prompt
    jcache = R.init_cache(jcfg, 1, 128)
    jfull, jcache, _ = R.prefill(jp, jcfg, jnp.asarray(full), jcache,
                                 prompt_lengths=jnp.asarray([40], jnp.int32))
    sl = 40 - prefix_len
    toks = np.zeros((1, 32), np.int32)
    toks[0, :sl] = prompt[prefix_len:]
    # the suffix run sees only the prefix rows: the rest of the row is zeroed
    jcache = jax.tree.map(lambda a: a.at[:, :, prefix_len:].set(0), jcache)
    tcache = T.cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    jlog, jcache, jlen = R.prefill_suffix(
        jp, jcfg, jnp.asarray(toks), jcache, prefix_len=jnp.asarray([prefix_len], jnp.int32),
        suffix_lengths=jnp.asarray([sl], jnp.int32))
    tlog, tcache, tlen = T.prefill_suffix(
        tp, cfg, torch.from_numpy(toks), tcache,
        prefix_len=torch.tensor([prefix_len], dtype=torch.int32),
        suffix_lengths=torch.tensor([sl], dtype=torch.int32))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jfull), atol=1e-4, rtol=1e-4)
    assert int(tlen[0]) == int(jlen[0]) == 40
    for (jl, tl) in zip(jax.tree.leaves(jcache), _leaves(tcache)):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=1e-4)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_prefill_suffix_refuses_recurrent_blocks_and_batches():
    _, _, cfg, tp = _weights("mamba2-780m")
    cache = T.init_cache(cfg, 1, 64, device="cpu")
    one = torch.tensor([16], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="attention-family"):
        T.prefill_suffix(tp, cfg, torch.ones((1, 32), dtype=torch.int32), cache,
                         prefix_len=one, suffix_lengths=one)
    _, _, gcfg, gp = _weights(ARCH)
    with pytest.raises(ValueError, match="batch-1"):
        T.prefill_suffix(gp, gcfg, torch.ones((2, 32), dtype=torch.int32),
                         T.init_cache(gcfg, 2, 64, device="cpu"),
                         prefix_len=one, suffix_lengths=one)


# -------------------------------------------- engine level, beside the reference
def _pair(weights, **kw):
    """(reference engine, port engine) built alike."""
    jcfg, jp, cfg, tp = weights
    return JEngine(jcfg, jp, **kw), ServingEngine(cfg, tp, device="cpu", **kw)


def _engines(weights, *, sharing, kv_blocks=64):
    return _pair(weights, max_batch=3, max_seq_len=64, paged=True, kv_block_size=8,
                 kv_blocks=kv_blocks, prefix_sharing=sharing)


def _waves(eng, waves, max_new=6):
    outs = []
    for wave in waves:
        reqs = [eng.submit(p, max_new_tokens=max_new) for p in wave]
        eng.run_to_completion(max_steps=4000)
        assert all(r.done for r in reqs)
        outs.append([r.output for r in reqs])
    return outs


def _both(engines, waves, max_new=6):
    """Run the waves through both engines: the port's outputs, which must
    equal the reference's, and the port's and the reference's prefix stats."""
    ref, got = (_waves(e, waves, max_new) for e in engines)
    assert got == ref
    return got, engines[1].pool.prefix_stats, engines[0].pool.prefix_stats.as_dict()


def test_shared_trunk_hits_and_outputs_match(weights):
    """Turn-style reuse: wave 2 extends wave 1's prompts. Sharing changes
    counters and saved work (as the reference's do) — never a token."""
    cfg = weights[2]
    rng = np.random.default_rng(0)
    trunk = rng.integers(1, cfg.vocab_size - 1, size=20).astype(np.int32)
    waves = [[trunk], [np.concatenate([trunk, rng.integers(1, cfg.vocab_size - 1, size=k)
                                       .astype(np.int32)]) for k in (3, 5)]]
    plain, _, _ = _both(_engines(weights, sharing=False), waves)
    cow, ps, ref_ps = _both(_engines(weights, sharing=True), waves)
    assert cow == plain
    assert ps.as_dict() == ref_ps
    assert ps.registrations >= 1 and ps.hits == 2
    assert ps.shared_tokens > 0 and ps.saved_prefill_tokens > 0 and ps.saved_migrate_bytes > 0


def test_exact_fork_cow_splits_shared_tail(weights):
    """A child resubmitting the parent's exact prompt gets a boundary tail
    hit; its first decode write lands in the shared tail page, which is
    split (copied) first — a shared page is never written."""
    cfg = weights[2]
    trunk = np.random.default_rng(1).integers(1, cfg.vocab_size - 1, size=20).astype(np.int32)
    plain, _, _ = _both(_engines(weights, sharing=False), [[trunk], [trunk]])
    engines = _engines(weights, sharing=True)
    pool = engines[1].pool
    cow, ps, ref_ps = _both(engines, [[trunk], [trunk]])
    assert cow == plain and ps.as_dict() == ref_ps
    assert ps.hits == 1 and ps.cow_splits >= 1
    assert pool.jit_dispatches == engines[0].pool.jit_dispatches
    assert dataclasses.asdict(pool.traffic) == dataclasses.asdict(engines[0].pool.traffic)


def test_saved_energy_is_a_side_channel(weights):
    """Conservation: per-request energies sum to the pool totals with
    sharing on, the saved joules appear in neither, and every figure equals
    the reference's."""
    jcfg, jp, cfg, tp = weights
    rng = np.random.default_rng(2)
    trunk = rng.integers(1, cfg.vocab_size - 1, size=24).astype(np.int32)
    out = []
    for eng in (
            JEngine(jcfg, jp, max_batch=3, max_seq_len=64, paged=True, kv_block_size=8,
                    kv_blocks=64, prefix_sharing=True,
                    controller=JController(JEnergyModel(J_H200), jax_get_config(ARCH))),
            ServingEngine(cfg, tp, max_batch=3, max_seq_len=64, paged=True, kv_block_size=8,
                          kv_blocks=64, prefix_sharing=True, device="cpu",
                          controller=ClockController(EnergyModel(H200_SXM), get_config(ARCH)))):
        done = []
        for wave in ([trunk], [np.concatenate([trunk, [5, 6, 7]])]):
            reqs = [eng.submit(p, max_new_tokens=5) for p in wave]
            eng.run_to_completion(max_steps=4000)
            done.extend(reqs)
        ps, st = eng.pool.prefix_stats, eng.pool.stats
        assert ps.hits == 1 and ps.saved_prefill_j > 0
        assert sum(r.prefill_j for r in done) == pytest.approx(st.prefill_j)
        assert sum(r.decode_j for r in done) == pytest.approx(st.decode_j)
        assert sum(r.saved_prefill_j for r in done) == pytest.approx(ps.saved_prefill_j)
        out.append(([r.output for r in done], [(r.prefill_j, r.decode_j, r.saved_prefill_j)
                                                for r in done], ps.as_dict()))
    assert out[1] == out[0]


def test_index_evicts_before_preempting_under_pressure(weights):
    """A tight budget stuffed with registered pages: admission reclaims
    index pages (evictions > 0) instead of failing or preempting."""
    cfg = weights[2]
    rng = np.random.default_rng(3)
    waves = [[rng.integers(1, cfg.vocab_size - 1, size=24).astype(np.int32)]
             for _ in range(4)]
    engines = _engines(weights, sharing=True, kv_blocks=12)
    _, ps, ref_ps = _both(engines, waves, max_new=4)
    assert ps.as_dict() == ref_ps
    assert ps.registrations >= 2 and ps.evictions > 0
    engines[1].pool.allocator.assert_invariants()


def test_sharing_requires_paged_and_shareable_arch(weights):
    jcfg, jp, cfg, tp = weights
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(cfg, tp, max_batch=2, max_seq_len=64, prefix_sharing=True, device="cpu")
    _, _, mcfg, mp = _weights("mamba2-780m")
    with pytest.raises(ValueError, match="attention-family blocks only"):
        ServingEngine(mcfg, mp, max_batch=2, max_seq_len=64, paged=True, kv_block_size=8,
                      prefix_sharing=True, device="cpu")


def _trunk_waves(cfg, seed):
    """Wave 1 seeds the index (registration happens at finish); wave 2
    reuses the trunk with random suffixes — a 0-length suffix is an exact
    fork, which must COW-split the shared tail on its first decode write."""
    rng = np.random.default_rng(seed)
    trunk = rng.integers(1, cfg.vocab_size - 1, size=int(rng.integers(10, 22))).astype(np.int32)
    kids = [np.concatenate([trunk, rng.integers(1, cfg.vocab_size - 1, size=int(k))
                            .astype(np.int32)]) for k in rng.integers(0, 9, size=3)]
    return [[trunk], kids]


@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("seed", [0, 7, 19])
def test_cow_outputs_bit_for_bit(weights, seed, tight):
    """Shared-trunk waves through dense, paged and paged+COW engines, each
    beside the reference's: sharing (hits, suffix-only prefill, COW splits,
    index eviction under the tight budget) never changes a token, and the
    port's counters equal the reference's."""
    waves = _trunk_waves(weights[2], seed)
    kv_blocks = 10 if tight else 24
    dense, _, _ = _both(_pair(weights, max_batch=3, max_seq_len=64), waves)
    plain, _, _ = _both(_pair(weights, max_batch=3, max_seq_len=64, paged=True,
                              kv_block_size=8, kv_blocks=kv_blocks), waves)
    engines = _pair(weights, max_batch=3, max_seq_len=64, paged=True, kv_block_size=8,
                    kv_blocks=kv_blocks, prefix_sharing=True)
    cow, ps, ref_ps = _both(engines, waves)
    assert cow == dense == plain
    assert ps.as_dict() == ref_ps and ps.lookups == 4 and ps.registrations >= 1
    pool = engines[1].pool
    alloc = pool.allocator
    alloc.assert_invariants()
    # at run end the only live pages are the index's retained ones
    assert alloc.used_blocks == pool._prefix.held_blocks
    pool._prefix.clear()
    assert alloc.used_blocks == 0


def test_defrag_mid_run_remaps_shared_exactly_once(weights):
    """Defrag while the index holds shared pages: the trie is remapped
    through the same old -> new mapping (each entry once), pages move in
    place, and the outputs stay those of an undisturbed run."""
    waves = _trunk_waves(weights[2], seed=7)
    kw = dict(max_batch=3, max_seq_len=64, paged=True, kv_block_size=8, kv_blocks=24,
              prefix_sharing=True)
    ref = _waves(_pair(weights, **kw)[1], waves)
    eng = _pair(weights, **kw)[1]
    outs = [_waves(eng, waves[:1])[0]]
    idx = eng.pool._prefix
    held_before = sorted(idx.blocks())
    assert held_before, "wave 1 registered nothing"
    reqs = [eng.submit(p, max_new_tokens=6) for p in waves[1]]
    for _ in range(2):
        eng.step()
    ptrs = [t.data_ptr() for t in _leaves(eng.pool.cache)]
    eng.pool.defrag()
    assert [t.data_ptr() for t in _leaves(eng.pool.cache)] == ptrs
    held_after = sorted(idx.blocks())
    assert len(held_after) == len(held_before)
    eng.run_to_completion(max_steps=4000)
    outs.append([r.output for r in reqs])
    assert outs == ref
    eng.pool.allocator.assert_invariants()


# ------------------------------------------------ serve_prefix, fleet level
# the port's EngineStats counters: the reference's but those of its jitted
# programs and stacked bank, which the port has no counterpart of
ENGINE_KEYS = set(EngineStats().as_dict())


def _fleet_fingerprint(fleet, done):
    done = sorted(done, key=lambda r: (r.ledger.arrival_s, r.uid))
    return json.dumps({
        "tokens": [r.output for r in done],
        "stamps": [[r.ledger.arrival_s, r.ledger.admitted_s, r.ledger.first_token_s,
                    list(r.ledger.token_s), r.ledger.finish_s] for r in done],
        "request": [[r.prefill_j, r.decode_j, r.saved_prefill_j, r.prefix_tokens,
                     r.decode_read_bytes, r.decode_write_bytes] for r in done],
        "measured": fleet.measured_energy_j(),
        "stats": {n: dataclasses.asdict(s) for n, s in fleet.stats_by_replica().items()},
        "prefix": fleet.prefix_stats_total().as_dict(),
        "engine": {k: v for k, v in fleet.last_engine_stats.as_dict().items()
                   if k in ENGINE_KEYS},
        "traffic": [dataclasses.asdict(r.decode_pool.traffic) for r in fleet.replicas],
    }, sort_keys=True)


@pytest.mark.parametrize("share", [0.5, 1.0])
def test_fleet_replays_match_reference(weights, share):
    """``serve_prefix``'s trace (scale 2) through dense, paged and cow
    fleets on the event engine: each fleet equals the reference's in
    tokens, every ledger stamp, per-request and pool joules, measured
    joules, ``PrefixStats``, ``EngineStats`` and traffic; the three token
    streams are equal."""
    tp = weights[3]
    jtrace, _ = j_serve_prefix.share_trace(share, 2)
    trace, _ = t_serve_prefix.share_trace(share, 2)
    streams = set()
    for config in t_serve_prefix.CONFIGS:
        jfleet = j_serve_prefix.make_fleet(config)      # weights: PRNGKey(0), as ``jp``
        ref = _fleet_fingerprint(jfleet, jfleet.run_trace(jtrace, engine="events"))
        fleet = t_serve_prefix.make_fleet(config, {ARCH: tp}, device="cpu")
        got = _fleet_fingerprint(fleet, fleet.run_trace(trace, engine="events"))
        assert got == ref, config
        streams.add(json.dumps(json.loads(got)["tokens"]))
    assert len(streams) == 1


def test_serve_prefix_smoke_matches_reference(weights):
    """The recipe's smoke run on the CPU, on the reference's weights: its
    assertions hold, and every row (determinism sha256 included) equals
    the reference recipe's, apart from the wall-clock field."""
    _, _, _, tp = weights
    rows = t_serve_prefix.run(smoke=True, device="cpu", params_for={ARCH: tp})
    ref = j_serve_prefix.run(smoke=True)
    assert [(n, d) for n, _, d in rows] == [(n, d) for n, _, d in ref]
    assert any(n == "serve_prefix/determinism" and "byte_identical=True" in d
               for n, _, d in rows)
