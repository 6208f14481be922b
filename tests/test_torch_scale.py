"""The port's replica banks and its ``serve_scale`` recipe against the JAX
package.

Reduced gemma-2b and minicpm-2b (the recipe's fleet), weights from
``repro.models.init_params`` (``jax.random.PRNGKey(0)``, the reference
recipe's own) carried across through numpy, on the CPU. The recipe's
300-request cut (``aligned_trace(200)`` then ``drifted_trace(100)``, the
100-replica fleet, quantum 0.5 ms) replays in batched mode to the
reference's sha256 with equal ``EngineStats``, key for key (the bank and
program counters and ``pool_jit_dispatches`` among them); the tuple mode
is held in ``tests/test_torch_scale_tuple.py``. Then the bank's three ways
in (coherent, gather, rebuild) and their counters, a member leaving its
group, ``place_many`` through a ``BankRow``, ``materialize_cache`` and
``clear_program_caches``, each against pools stepped on their own.

Tolerances: a decode step folded into a bank is bitwise equal to the
member steps on the CPU (``torch.equal`` on tokens and caches); the
batched admission prefill is not (one GEMM shape for the group), so it is
held to equal first tokens and cache rows within 1e-6.
"""
import gc
import json
import sys
import weakref
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro_torch.models as T
import repro_torch.serving as S
from repro_torch.benchmarks import serve_scale as t_scale
from repro_torch.configs import reduced_config
from repro_torch.core.clock import VirtualClock
from repro_torch.serving import events as events_mod
from repro_torch.serving import pool as pool_mod

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import benchmarks.serve_scale as j_scale  # noqa: E402

ARCH = "gemma-2b"
CUT_SHA = "7ce14a8dc31b3b4d"        # the reference's sha256 of the cut, both modes


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are tiny: intra-op threads only spin on them
    and take cores from the other workers of a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """arch -> port params of the reduced config, from the reference's
    ``params_for`` (``PRNGKey(0)``)."""
    return {a: T.params_from_numpy(jax.tree.map(np.asarray, p), reduced_config(a),
                                   device="cpu")
            for a, p in j_scale.params_for().items()}


def cut_traces():
    """The 300-request cut on both sides: (reference trace, port trace)."""
    out = []
    for m in (j_scale, t_scale):
        a, dropped = m.aligned_trace(200)
        assert dropped == 0
        out.append(a + m.drifted_trace(100, t0=(len(a) // m.N_REPLICAS + 2) * m.WAVE_DT_S))
    return out


def _engine_stats(metrics):
    d = dict(metrics["engine_stats"])
    d.pop("fused_decode_wall")
    return d


def test_scale_cut_batched_matches_reference(weights):
    """Batched mode: the port's replay of the cut streams to the
    reference's sha256, and ``EngineStats`` are equal key for key: two
    gathers, five rebuilds, 23 batched decode steps, 107 batched
    prefills, 14 fused programs, 304 pool dispatches."""
    jtrace, ttrace = cut_traces()
    ref, ref_sha, _ = j_scale.replay(jtrace, fusion_quantum_s=j_scale.QUANTUM_S,
                                     batch_replicas=True)
    got, sha, _, fleet = t_scale.replay(ttrace, weights, device="cpu",
                                        fusion_quantum_s=t_scale.QUANTUM_S,
                                        batch_replicas=True)
    assert sha == ref_sha and sha.startswith(CUT_SHA)
    st = _engine_stats(got)
    assert st == _engine_stats(ref)
    assert {k: st[k] for k in ("bank_gathers", "bank_rebuilds", "batched_decode_calls",
                               "batched_prefill_calls", "fused_traces",
                               "pool_jit_dispatches")} == {
        "bank_gathers": 2, "bank_rebuilds": 5, "batched_decode_calls": 23,
        "batched_prefill_calls": 107, "fused_traces": 14, "pool_jit_dispatches": 304}
    assert {k: v for k, v in got.items() if k != "engine_stats"} == {
        k: v for k, v in ref.items() if k != "engine_stats"}
    steps = fleet.last_batched_calls
    assert set(steps) == {reduced_config(a).name for a in ("gemma-2b", "minicpm-2b")}
    assert sum(e["decode_steps"] for e in steps.values()) == st["batched_decode_calls"]
    assert sum(e["prefill_calls"] for e in steps.values()) == st["batched_prefill_calls"]
    assert sum(e["prefill_requests"] for e in steps.values()) == st["fused_prefill_reqs"]
    assert all(e["replays"] == 0 for e in steps.values())    # no graph on the CPU


def test_scale_recipe_holds_its_gates_on_a_cut(weights, tmp_path, monkeypatch):
    """The recipe's ``run`` on cut traces (``--batched=off``, the
    invocation without the timed curve): every gate holds (``run`` raises
    otherwise), the rows are the reference's, name for name, and the JSON
    lands under the port's name."""
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    tags = []
    rows = t_scale.run(smoke=True, write_json=True, batched=False, device="cpu",
                       params_for=weights, n_scale=800, n_aligned=200, n_compare=300,
                       on_run=lambda tag, m, wall, fleet: tags.append(tag))
    assert [r[0] for r in rows] == [
        "serve_scale/replay", "serve_scale/determinism", "serve_scale/aligned_coverage",
        "serve_scale/dispatches_vs_serial", "serve_scale/batched_identity",
        "serve_scale/quantum", "serve_scale/wall_time", "serve_scale/json"]
    assert tags == ["scale 1", "scale 2", "aligned", "compare fused", "compare serial",
                    "compare cross", "quantum 0", "exact"]
    assert rows[4][2].startswith("byte_identical=True;batched_decode_calls=")
    blob = json.loads((tmp_path / t_scale.UNBATCHED_JSON_PATH).read_text())
    assert blob["results"]["batched"]["cross_mode_identical"] is True
    assert (tmp_path / "serve_scale.csv").exists()


def test_dispatch_curve_counts_both_modes(weights):
    """The dispatch curve on one aligned wave set (the smoke sweep, g 4, 8
    and 32): every point times both modes over the same fused calls by
    pow2 group size, reports each replay through ``on_run``, and
    ``clear_program_caches`` leaves no bank behind."""
    tags = []
    curve = t_scale.dispatch_curve(True, weights, n_requests=200, device="cpu",
                                   on_run=lambda tag, m, wall, fleet: tags.append(tag))
    assert not events_mod._PROGRAM_CACHE
    assert tags == [f"curve g{g} {m}" for g in (4, 8, 32) for m in ("batched", "tuple")]
    for g, point in curve.items():
        b, t = point["batched"], point["tuple"]
        assert b["fused_calls"] == t["fused_calls"] > 0
        assert ({k: v[0] for k, v in b["by_size"].items()}
                == {k: v[0] for k, v in t["by_size"].items()})
        assert all(int(k) <= int(g) for k in b["by_size"])


# ----------------------------------------------------------- bank unit tests
def _fleet(weights, n=4):
    spec = S.FleetSpec(replicas=tuple(
        S.ReplicaSpec(name=f"r{i}", arch=ARCH, clock=S.ClockSpec(mode="lock"),
                      decode=S.PoolSpec(batch=2), max_seq_len=64, prefill_chunk_tokens=64)
        for i in range(n)), router="rr")
    return S.Fleet.from_spec(spec, emodel=t_scale.h200_model(),
                             params_for={ARCH: weights[ARCH]}, device="cpu")


def _fill(fleet, seed=0, n_req=2):
    """Place ``n_req`` prefilled requests in every decode pool."""
    rng = np.random.default_rng(seed)
    uid = 0
    for r in fleet.replicas:
        for _ in range(n_req):
            prompt = rng.integers(1, 100, int(rng.integers(4, 20))).astype(np.int32)
            req = pool_mod.Request(uid=uid, prompt=prompt, max_new_tokens=40)
            uid += 1
            first, cache1 = r.prefill_pool.prefill_request(req)
            r.decode_pool.place(req, cache1, first, len(prompt))


def _tensors(tree):
    return [t for sc in tree["stages"] for blk in sc.values() for t in blk.values()]


def _sig(pool):
    return (pool.cfg.name, pool.params_token, pool.paged, pool.max_batch, pool.max_seq_len)


class Pair:
    """Two fleets with the same placements: ``a`` steps groups through the
    engine's batched path, ``b`` steps the same pools on their own."""

    def __init__(self, weights, n=4):
        self.a, self.b = _fleet(weights, n), _fleet(weights, n)
        for f in (self.a, self.b):
            _fill(f)
        self.eng = S.EventDrivenFleet(self.a)

    def pools(self, which):
        return [r.decode_pool for r in getattr(self, which).replicas]

    def step(self, idx):
        reps = [self.a.replicas[i] for i in idx]
        self.eng._decode_fused(_sig(reps[0].decode_pool), reps)
        for i in idx:
            self.b.replicas[i].decode_pool.decode_once()

    def check(self, idx=None):
        """Tokens, lengths and cache rows of the pools ``idx``: a's (read
        through its views) == b's, bit for bit."""
        for i in (range(len(self.a.replicas)) if idx is None else idx):
            pa, pb = self.a.replicas[i].decode_pool, self.b.replicas[i].decode_pool
            assert np.array_equal(pa._host_cur_token, pb._host_cur_token)
            assert np.array_equal(pa._host_lengths, pb._host_lengths)
            for x, y in zip(_tensors(pa.cache), _tensors(pb.cache)):
                assert torch.equal(x, y)


def test_bank_paths_and_counters(weights):
    """Rebuild (every member on its own cache), coherent (the same group
    again: no copy, no counter), gather (a sub-group off ONE bank) and
    rebuild off two banks (one dispatch a source bank, on its first
    member), each bitwise equal to the member steps; ``fused_traces``
    counts the three keys once each."""
    pair = Pair(weights)
    st, pools = pair.eng.stats, pair.pools("a")
    pair.step([0, 1, 2, 3])
    assert (st.bank_rebuilds, st.bank_gathers, st.batched_decode_calls) == (1, 0, 1)
    bank4 = pools[0].cache.bank
    assert [(p.cache.bank, p.cache.index) for p in pools] == [(bank4, j) for j in range(4)]
    pair.check()
    pair.step([0, 1, 2, 3])
    assert (st.bank_rebuilds, st.bank_gathers) == (1, 0) and pools[0].cache.bank is bank4
    pair.check()
    pair.step([1, 0])
    assert st.bank_gathers == 1
    bank2 = pools[1].cache.bank
    assert bank2 is not bank4 and bank2.size == 2
    assert (pools[1].cache.index, pools[0].cache.index) == (0, 1)
    pair.check()
    before = [p.jit_dispatches for p in pools]
    pair.step([2, 3, 0])
    assert st.bank_rebuilds == 2 and st.pad_waste == 1
    assert [p.jit_dispatches - b for p, b in zip(pools, before)] == [1, 0, 1, 0]
    pair.check()
    assert st.fused_traces == 3 and set(k[0] for k in pair.eng._fused_cache) == {
        "decode_restack", "decode", "decode_gather"}
    assert pools[1].cache.bank is bank2            # left behind, its row intact
    pair.check([1])


def test_member_leaving_its_group_keeps_its_rows(weights):
    """A member leaves its group. After a gather off the group's bank its
    row of the old bank is unchanged; after a coherent step of the rest,
    whose pad row it viewed with live slots, its rows were copied back into
    its own cache first, unchanged, and it then steps on its own as the
    unbanked pool does."""
    pair = Pair(weights)
    pools = pair.pools("a")
    pair.step([0, 1, 2, 3])
    bank4 = pools[0].cache.bank
    row3 = [t.clone() for t in _tensors(pools[3].cache)]
    pair.step([0, 1])                              # gather: bank4 untouched
    assert pools[3].cache.bank is bank4 and pools[2].cache.bank is bank4
    assert all(torch.equal(x, y) for x, y in zip(_tensors(pools[3].cache), row3))
    pair.check([3])
    pair = Pair(weights)
    pools = pair.pools("a")
    pair.step([0, 1, 2, 3])
    row3 = [t.clone() for t in _tensors(pools[3].cache)]
    before = pools[3].jit_dispatches
    pair.step([0, 1, 2])                           # coherent on bank4, pad row 3
    assert pools[3].cache is pools[3]._own_cache
    assert pools[3].jit_dispatches == before + 1
    assert all(torch.equal(x, y) for x, y in zip(_tensors(pools[3].cache), row3))
    pair.check()
    pair.step([3])
    pair.check()


def test_place_many_writes_through_a_bank_row(weights):
    """``place_many`` on a pool whose cache is a ``BankRow`` writes the
    rows into the bank (the pool's own tensors are untouched), the same
    rows a pool on its own cache gets, in one dispatch."""
    pair = Pair(weights)
    pair.step([0, 1, 2, 3])
    pa, pb = pair.a.replicas[2].decode_pool, pair.b.replicas[2].decode_pool
    own = [t.clone() for t in _tensors(pa._own_cache)]
    for p in (pa, pb):                             # free both slots
        for i, req in enumerate(p.slot_req):
            p.slot_req[i] = None
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 100, n).astype(np.int32) for n in (6, 13)]
    for p, r in ((pa, pair.a.replicas[2]), (pb, pair.b.replicas[2])):
        items = []
        for i, prompt in enumerate(prompts):
            req = pool_mod.Request(uid=100 + i, prompt=prompt, max_new_tokens=4)
            first, cache1 = r.prefill_pool.prefill_request(req)
            items.append((req, cache1, first, len(prompt), None))
        before = p.jit_dispatches
        assert p.place_many(items) == [0, 1] and p.jit_dispatches == before + 1
    assert isinstance(pa.cache, S.BankRow)
    bank = pa.cache.bank
    for x, y, t in zip(_tensors(pa.cache), _tensors(pb.cache), _tensors(bank.tree)):
        assert torch.equal(x, y) and torch.equal(t[:, 4:6], y)
    assert all(torch.equal(x, y) for x, y in zip(_tensors(pa._own_cache), own))


def test_materialize_copies_into_the_pools_own_tensors(weights):
    """``materialize_cache`` copies a ``BankRow``'s rows into the pool's own
    cache tensors (same ``data_ptr``), counts one dispatch, leaves the
    bank's viewers and is a no-op on the pool's own cache."""
    pair = Pair(weights)
    pair.step([0, 1, 2, 3])
    p = pair.pools("a")[1]
    ptrs = [t.data_ptr() for t in _tensors(p._own_cache)]
    row = [t.clone() for t in _tensors(p.cache)]
    bank = p.cache.bank
    before = p.jit_dispatches
    assert p.cache_is_view() and p in bank.viewers
    p.materialize_cache()
    assert not p.cache_is_view() and p not in bank.viewers
    assert [t.data_ptr() for t in _tensors(p.cache)] == ptrs
    assert all(torch.equal(x, y) for x, y in zip(_tensors(p.cache), row))
    p.materialize_cache()
    assert p.jit_dispatches == before + 1
    pair.check()


def test_clear_program_caches_frees_the_banks(weights):
    """A replay leaves its bank sets in the process-wide cache, where a
    fresh fleet of the same shape finds them; once the fleets are gone,
    ``clear_program_caches`` frees every bank."""
    S.clear_program_caches()
    fleet = _fleet(weights)
    trace = [S.TracedRequest(arrival_s=0.0, prompt=np.arange(1, 9, dtype=np.int32),
                             max_new_tokens=4) for _ in range(8)]
    fleet.run_trace(trace)
    sets = [v for k, v in events_mod._PROGRAM_CACHE.items() if k[0] == "bank"]
    assert sets and all(s.banks for s in sets)
    refs = [weakref.ref(b) for s in sets for b in s.banks]
    rebuilds = fleet.last_engine_stats.bank_rebuilds
    del fleet
    gc.collect()
    again = _fleet(weights)                        # the banks are free: reused
    again.run_trace(trace)
    assert again.last_engine_stats.bank_rebuilds == rebuilds > 0
    assert [weakref.ref(b) for s in sets for b in s.banks] == refs
    del again
    gc.collect()
    assert all(r() is not None for r in refs)      # still cached
    del sets
    S.clear_program_caches()
    gc.collect()
    assert not events_mod._PROGRAM_CACHE and all(r() is None for r in refs)


def test_batched_prefill_rows_within_1e6(weights):
    """One prefill of batch 4 over stacked prompts of one bucket against
    four batch-1 prefills: equal first tokens, logits and cache rows
    within 1e-6 (not bitwise: one GEMM shape for the group)."""
    cfg = reduced_config(ARCH)
    pp = S.Pool(cfg, weights[ARCH], role="prefill", max_batch=1, max_seq_len=64,
                clock=VirtualClock(), device="cpu")
    rng = np.random.default_rng(3)
    reqs = [pool_mod.Request(uid=i, prompt=rng.integers(1, 100, n).astype(np.int32))
            for i, n in enumerate((8, 17, 24, 31))]
    trip = [pp.prefill_tokens(r) for r in reqs]
    assert {b for _, _, b in trip} == {32}
    with torch.inference_mode():
        logits, cache = pp.prefill_rows(np.concatenate([t for t, _, _ in trip]),
                                        np.concatenate([n for _, n, _ in trip]))
        for i, (toks, n, _) in enumerate(trip):
            lg1, c1 = pp.prefill_rows(toks, n)
            assert int(lg1[0].argmax()) == int(logits[i].argmax())
            assert torch.allclose(lg1[0], logits[i], atol=1e-6, rtol=0)
            for x, y in zip(_tensors(c1), _tensors(pool_mod.cache_rows(cache, i, i + 1))):
                assert torch.allclose(x, y, atol=1e-6, rtol=0)
