"""The port's discrete-event fleet engine against the JAX package.

Reduced gemma-2b (and mamba2-780m for a mixed fleet), weights from
``repro.models.init_params`` through numpy, on the CPU. The counterparts
of ``tests/test_events.py`` and ``tests/test_batched_dispatch.py`` held on
the port — barrier equivalence on a shared clock, prefill/decode overlap,
the fused decode and admission-prefill paths, the fusion quantum, pow2
group buckets, autoscaler timers, the batched replica axis (both
``batch_layout``s: ``shard_map`` on one process runs the bank, as the
reference runs ``vmap`` on one device), params tokens and the spec's
engine options — minus the multi-device cases. Greedy replays are
held to a live reference replay: tokens, every ledger stamp, modelled and
measured joules and ``EngineStats`` (all but the wall-clock ledger, the
bank and program counters included) equal, on shared and split clocks,
fused and serial, batched and tuple, with and without a quantum. The
batched decode fold is bitwise equal to the member steps on the CPU; the
batched admission prefill is not (another GEMM shape), so batched replays
are held to the tuple and serial ones in tokens, stamps and joules. Sampled replays (temperature
> 0) draw on ``jax.random``'s threefry bits (``repro_torch.serving.prng``),
so mixed-temperature traces are held to the reference's replay in the same
way, beside the greedy ones (``PARITY``'s ``sampled`` and ``mixed``). Then
``serve_trace``'s smoke replay and ``serve_events``' recipe against the
reference's sha256.
"""
import dataclasses
import gc
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.models as R
import repro.serving as J
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.core import EnergyModel as JEnergyModel
from repro.core.clock import VirtualClock as JVirtualClock
from repro.core.traces import TracedRequest as JTracedRequest
from repro.core.traces import generate_trace as jax_generate_trace
from repro.hw import H200_SXM as J_H200
import repro_torch.models as T
import repro_torch.serving as S
from repro_torch.benchmarks import serve_events as t_serve_events
from repro_torch.benchmarks import serve_trace as t_serve_trace
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.clock import VirtualClock
from repro_torch.core.energy import EnergyModel
from repro_torch.core.latency import summarize_latency
from repro_torch.core.traces import TracedRequest, generate_trace
from repro_torch.hw import H200_SXM
from repro_torch.serving import pool as pool_mod

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import benchmarks.serve_events as j_serve_events  # noqa: E402
import benchmarks.serve_trace as j_serve_trace  # noqa: E402

ARCH = "gemma-2b"
ALT = "mamba2-780m"             # another family: per-arch grouping


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are tiny: torch's intra-op threads only spin
    on them, taking cores from the other workers of a parallel run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_WEIGHTS: dict = {}


def _weights():
    """{arch: (reference params, port params)} of the reduced configs."""
    if not _WEIGHTS:
        for arch in (ARCH, ALT):
            jp = R.init_params(jax_reduced_config(arch), jax.random.PRNGKey(0))
            _WEIGHTS[arch] = (jp, T.params_from_numpy(jax.tree.map(np.asarray, jp),
                                                      reduced_config(arch), device="cpu"))
    return _WEIGHTS


@pytest.fixture(scope="module")
def weights():
    return _weights()


# the two sides: the JAX package, then the port
SIDES = (
    dict(mod=J, em=JEnergyModel, chip=J_H200, tr=JTracedRequest, side=0, kw={}),
    dict(mod=S, em=EnergyModel, chip=H200_SXM, tr=TracedRequest, side=1,
         kw={"device": "cpu"}),
)
PORT = SIDES[1]


def _fleet(side, n=1, *, batch=2, max_seq_len=64, chunk=64, archs=None, autoscaler=None,
           engine_opts=None):
    m = side["mod"]
    archs = archs or [ARCH] * n
    spec = m.FleetSpec(
        replicas=tuple(
            m.ReplicaSpec(name=f"r{i}", arch=a, clock=m.ClockSpec(mode="lock"),
                          decode=m.PoolSpec(batch=batch), max_seq_len=max_seq_len,
                          prefill_chunk_tokens=chunk)
            for i, a in enumerate(archs)),
        router="jsq", autoscaler=autoscaler, engine_opts=engine_opts or {})
    params = {a: p[side["side"]] for a, p in _weights().items()}
    return m.Fleet.from_spec(spec, emodel=side["em"](side["chip"]), params_for=params,
                             **side["kw"])


def _req(side, prompt_len, arrival_s, max_new, seed=0, temp=0.0):
    rng = np.random.default_rng(seed + prompt_len)
    return side["tr"](arrival_s=arrival_s,
                      prompt=rng.integers(1, 100, prompt_len).astype(np.int32),
                      max_new_tokens=max_new, bucket="mixed", temperature=temp)


def _poisson(side, n, *, seed=3, rate=50.0, max_new=4):
    gen = jax_generate_trace if side["side"] == 0 else generate_trace
    cfg = (jax_reduced_config if side["side"] == 0 else reduced_config)(ARCH)
    return [dataclasses.replace(t, max_new_tokens=max_new)
            for t in gen(cfg, n, arrival="poisson", lengths="short_chat", rate_rps=rate,
                         seed=seed, max_total_len=48)]


def _blob(done, fleet):
    """Tokens, every ledger stamp, modelled and measured joules."""
    done = sorted(done, key=lambda r: r.uid)
    return json.dumps({
        "outputs": [r.output for r in done],
        "stamps": [[r.ledger.arrival_s, r.ledger.admitted_s, r.ledger.first_token_s,
                    list(r.ledger.token_s), r.ledger.finish_s] for r in done],
        "request_j": [[r.prefill_j, r.decode_j] for r in done],
        "modelled": {n: dataclasses.asdict(s) for n, s in fleet.stats_by_replica().items()},
        "measured": fleet.measured_energy_j(),
    }, sort_keys=True)


# counters of the reference's that the port has not: none since the port
# stacks its replica caches in banks too
REFERENCE_ONLY_STATS = set()


def _stats(fleet):
    """``EngineStats`` as a dict, minus the wall-clock ledger."""
    d = fleet.last_engine_stats.as_dict()
    d.pop("fused_decode_wall")
    return {k: v for k, v in d.items() if k not in REFERENCE_ONLY_STATS}


def test_engine_stats_differ_only_in_program_and_bank_counters():
    """The port's ``EngineStats`` has exactly the reference's counters, the
    program and bank counters (``fused_traces``, ``bank_gathers``,
    ``bank_rebuilds``, ``batched_prefill_calls``) included."""
    ref, port = set(J.EngineStats().as_dict()), set(S.EngineStats().as_dict())
    assert port == ref and not REFERENCE_ONLY_STATS


def _both(trace_fn, n=4, **opts):
    """A replay of ``trace_fn(side)`` on both sides with the same engine
    options: [(blob, stats, fleet)] for the reference, then the port."""
    out = []
    for side in SIDES:
        fleet = _fleet(side, n=n)
        trace = trace_fn(side)
        done = fleet.run_trace(trace, engine_opts=dict(opts))
        assert len(done) == len(trace)
        out.append((_blob(done, fleet), _stats(fleet), fleet))
    return out


def _drifted(side, n=10, max_new=8):
    """Staggered sub-step arrivals, greedy: exact ties never happen."""
    return [_req(side, 16, 1e-4 * i, max_new, seed=30 + i) for i in range(n)]


def _aligned(side, n=12, max_new=6, temps=False):
    """Identical prompt lengths in one burst: the replicas stay aligned."""
    return [_req(side, 16, 0.0, max_new, seed=10 + i,
                 temp=0.7 if temps and i % 3 == 0 else 0.0) for i in range(n)]


# --------------------------------------------------- parity with the reference
PARITY = {
    "default": {},
    "tuple": {"batch_replicas": False},
    "serial": {"batch_replicas": False, "fast_path_min": 99, "fuse_prefill": False},
    "fast2": {"fast_path_min": 2},
    "fast2_tuple": {"fast_path_min": 2, "batch_replicas": False},
    "quantum": {"fast_path_min": 2, "fusion_quantum_s": 0.003},
    "quantum_wide": {"fast_path_min": 2, "fusion_quantum_s": 0.5, "fuse_prefill": False},
    "shard_map": {"batch_layout": "shard_map"},
}


@pytest.mark.parametrize("trace", ["drifted", "aligned", "poisson", "sampled", "mixed"])
@pytest.mark.parametrize("opts", list(PARITY))
def test_split_clock_replay_matches_reference(weights, opts, trace):
    """Split pool clocks (``Fleet.from_spec``), four replicas: the port's
    replay equals the reference's in every byte of the fingerprint and in
    every ``EngineStats`` counter, the bank and program counters and the
    pools' dispatches (bank rows copied back included) among them. The
    ``sampled`` and ``mixed`` traces put every third request at temperature
    0.7 (an aligned burst; same-instant bursts of mixed lengths): the
    sampled tokens are the reference's, drawn on ``jax.random``'s bits."""
    fn = {"drifted": _drifted, "aligned": _aligned,
          "poisson": lambda side: _poisson(side, 12, rate=400.0),
          "sampled": lambda side: _aligned(side, temps=True),
          "mixed": lambda side: _mixed_trace(side=side)}[trace]
    (ref, ref_st, _), (got, st, fleet) = _both(fn, **PARITY[opts])
    assert got == ref
    assert st == ref_st
    assert fleet.last_engine_stats.decode_steps > 0


def test_shared_clock_engines_byte_identical(weights):
    """On the Cluster's single shared clock the event schedule degenerates
    to the barrier's round order: tokens, every ledger stamp, modelled and
    measured joules are byte-identical — and equal to the reference's."""
    blobs = {}
    for side in SIDES:
        m = side["mod"]
        cfg = (jax_reduced_config if side["side"] == 0 else reduced_config)(ARCH)
        full = (jax_get_config if side["side"] == 0 else get_config)(ARCH)
        clock_cls = JVirtualClock if side["side"] == 0 else VirtualClock
        for engine in ("events", "barrier"):
            ctl = m.ClockController(side["em"](side["chip"]), full, mode="lock")
            cl = m.Cluster(cfg, _weights()[ARCH][side["side"]], controller=ctl,
                           decode_batch=2, max_seq_len=64, prefill_chunk_tokens=64,
                           clock=clock_cls(), **side["kw"])
            done = cl.run_trace(_poisson(side, 8), engine=engine)
            blobs[side["side"], engine] = _blob(done, cl._fleet)
    assert blobs[1, "events"] == blobs[1, "barrier"] == blobs[0, "events"]


def test_split_clock_engines_same_tokens_close_joules(weights):
    """Split pool clocks: the engines schedule differently, but greedy
    token streams are a function of the prompt alone, and total joules
    agree within tolerance."""
    results = {}
    for engine in ("events", "barrier"):
        fleet = _fleet(PORT, n=2)
        trace = _poisson(PORT, 10, rate=200.0)
        done = sorted(fleet.run_trace(trace, engine=engine), key=lambda r: r.ledger.arrival_s)
        results[engine] = ([r.output for r in done], fleet.total_energy_j())
    ev, ba = results["events"], results["barrier"]
    assert len(ev[0]) == 10 and ev[0] == ba[0]
    assert ev[1] == pytest.approx(ba[1], rel=0.2)


def test_event_replay_is_deterministic(weights):
    def fingerprint():
        fleet = _fleet(PORT, n=2)
        return _blob(fleet.run_trace(_poisson(PORT, 10, rate=200.0)), fleet)

    assert fingerprint() == fingerprint()


# ------------------------------------------------------------------ overlap
def _burst(side):
    """One long-decode request, then a burst of LONG prompts landing while
    it decodes: the barrier serialises each admission prefill against the
    decode step, the event engine runs the two timelines concurrently."""
    return [_req(side, 8, 0.0, 24, seed=1)] + [
        _req(side, 480, 1e-4 * (i + 1), 4, seed=2 + i) for i in range(4)]


def _overlap_fleet(side):
    return _fleet(side, n=1, batch=4, max_seq_len=512, chunk=512)


def test_prefill_no_longer_stalls_decode(weights):
    """Overlap evidence: under the event engine some decode token is
    produced INSIDE another request's admission prefill window on the same
    replica; the barrier never does that."""
    def overlapped(engine):
        done = _overlap_fleet(PORT).run_trace(_burst(PORT), engine=engine)
        assert len(done) == 5
        windows = [(r.ledger.admitted_s, r.ledger.first_token_s) for r in done]
        stamps = [t for r in done for t in r.ledger.token_s]
        return any(a < t < f for t in stamps for (a, f) in windows)

    assert overlapped("events")
    assert not overlapped("barrier")


def test_burst_p99_ttft_strictly_better_than_barrier(weights):
    """Prefill-burst p99 TTFT under the event engine beats the barrier on
    the same trace, with the reference's figures on both engines."""
    p99 = {}
    for side in SIDES:
        for engine in ("events", "barrier"):
            done = _overlap_fleet(side).run_trace(_burst(side), engine=engine)
            p99[side["side"], engine] = summarize_latency(done).p99_ttft_s
    assert p99[1, "events"] < p99[1, "barrier"]
    assert (p99[1, "events"], p99[1, "barrier"]) == (p99[0, "events"], p99[0, "barrier"])


# -------------------------------------------------------- fused decode path
def test_fused_decode_token_identical_to_sequential(weights):
    """One fused dispatch over homogeneous decode events changes no token
    or joule: each pool still samples and accounts on its own."""
    trace = [_req(PORT, 16, 0.0, 6, seed=10 + i) for i in range(8)]

    def run(fast_min):
        fleet = _fleet(PORT, n=4)
        eng = S.EventDrivenFleet(fleet, fast_path_min=fast_min)
        done = eng.run(trace)
        return eng, _blob(done, fleet)

    fused_eng, fused = run(2)
    seq_eng, seq = run(99)
    assert fused == seq
    assert fused_eng.stats.fused_decode_calls > 0 and seq_eng.stats.fused_decode_calls == 0
    assert seq_eng.stats.serial_decode_calls == seq_eng.stats.decode_steps


# ------------------------------------------------------- fused admission path
def _mixed_trace(n=24, side=PORT):
    """Same-instant bursts with mixed temperatures (so the sampling order
    is load-bearing), plus staggered stragglers."""
    rng = np.random.default_rng(5)
    return [_req(side, int(rng.integers(4, 24)), (i // 8) * 0.002, 4, seed=100 + i,
                 temp=0.7 if i % 3 == 0 else 0.0) for i in range(n)]


def _aligned_backlog(n=16):
    return [_req(PORT, 16, 0.0, 4, seed=200 + i, temp=0.7 if i % 3 == 0 else 0.0)
            for i in range(n)]


def _run(trace, n=4, **opts):
    fleet = _fleet(PORT, n=n)
    done = fleet.run_trace(trace, engine_opts=opts)
    assert len(done) == len(trace)
    return fleet, _blob(done, fleet)


@pytest.mark.parametrize("which", ["mixed", "aligned_backlog"])
def test_fused_prefill_byte_identical_to_serial_admission(weights, which):
    """Grouping admission prefills into one dispatch changes nothing
    observable — tokens, stamps, modelled and measured joules — on a
    drifting mixed-length trace (single-tick groups) and an aligned backlog
    (tied multi-replica ADMIT groups), with sampled requests in both."""
    trace = _mixed_trace() if which == "mixed" else _aligned_backlog()
    fused_fleet, fused = _run(trace, fuse_prefill=True)
    serial_fleet, serial = _run(trace, fuse_prefill=False)
    assert fused == serial
    fs, ss = fused_fleet.last_engine_stats, serial_fleet.last_engine_stats
    assert fs.fused_prefill_reqs == len(trace)
    assert ss.fused_prefill_calls == 0 and ss.fused_prefill_reqs == 0
    assert fs.prefills == ss.prefills == len(trace)
    assert fs.jit_dispatches <= ss.jit_dispatches


def test_aligned_backlog_groups_prefills(weights):
    trace = _aligned_backlog()
    fs = _run(trace, fuse_prefill=True)[0].last_engine_stats
    ss = _run(trace, fuse_prefill=False)[0].last_engine_stats
    assert fs.fused_prefill_calls < fs.fused_prefill_reqs
    assert fs.jit_dispatches < ss.jit_dispatches


def test_engine_stats_accounting_is_consistent(weights):
    trace = _mixed_trace()
    st = _run(trace)[0].last_engine_stats
    assert st.placements == st.prefills == len(trace)
    assert st.fused_prefill_reqs + st.serial_prefill_calls == st.prefills
    assert 0.0 <= st.fused_prefill_coverage <= 1.0
    assert 0.0 <= st.fused_decode_coverage <= 1.0
    assert st.events == sum(st.events_by_kind.values())
    assert st.decode_steps > 0
    assert st.peak_heap < len(trace)            # lazy arrival feed
    d = st.as_dict()
    assert d["jit_dispatches"] == st.jit_dispatches
    json.dumps(d)


# ------------------------------------------------------------ fusion quantum
def test_quantum_zero_byte_identical_to_exact_tie(weights):
    trace = [_req(PORT, 16, 0.002 * (i % 5), 6, seed=20 + i) for i in range(12)]
    (base_f, base), (quant_f, quant) = _run(trace), _run(trace, fusion_quantum_s=0.0)
    assert base == quant
    s0, s1 = base_f.last_engine_stats, quant_f.last_engine_stats
    assert s0.fused_decode_calls == s1.fused_decode_calls and s0.events == s1.events


def test_quantum_window_fuses_drifted_heterogeneous_steps(weights):
    trace = [_req(PORT, 16, 1e-4 * i, 8, seed=30 + i) for i in range(8)]

    def run(q):
        fleet = _fleet(PORT, n=4)
        done = fleet.run_trace(trace, engine_opts={"fusion_quantum_s": q})
        return [r.output for r in sorted(done, key=lambda r: r.uid)], fleet.last_engine_stats

    outs0, st0 = run(0.0)
    outs1, st1 = run(0.5)
    assert outs1 == outs0
    assert (st1.fused_decode_calls + st1.serial_decode_calls
            <= st0.fused_decode_calls + st0.serial_decode_calls)
    assert st1.fused_decode_coverage >= st0.fused_decode_coverage


@pytest.mark.parametrize("q,seed", [(0.0005, 0), (0.003, 1), (0.07, 2), (0.25, 3)])
def test_random_quanta_never_change_token_streams(weights, q, seed):
    """Fusion grouping is pure dispatch policy: under any quantum the token
    streams equal the quantum-0 replay's."""
    rng = np.random.default_rng(seed)
    trace = [_req(PORT, int(rng.integers(4, 20)), float(rng.uniform(0, 0.01)),
                  int(rng.integers(2, 6)), seed=seed * 100 + i) for i in range(10)]
    base = _fleet(PORT, n=3)
    want = {r.uid: r.output for r in base.run_trace(trace)}
    fleet = _fleet(PORT, n=3)
    got = {r.uid: r.output for r in fleet.run_trace(trace, engine_opts={"fusion_quantum_s": q})}
    assert got == want


# ------------------------------------------------------------ autoscaler timers
@pytest.mark.parametrize("engine", ["events", "barrier"])
def test_valley_drain_fires_mid_gap(weights, engine):
    """Timer events at ``tick_interval_s`` evaluate the autoscaler inside an
    idle valley: the drain fires a hold window into the gap, not at the
    next arrival. The scale ledger equals the reference's."""
    ledgers = []
    for side in SIDES:
        m = side["mod"]
        scaler = m.AutoscalerSpec(policy="queue", min_replicas=1, warmup_s=0.0,
                                  queue_p95_target_s=0.001, slack=0.5, hold_s=0.05,
                                  window_s=0.2, tick_interval_s=0.01)
        burst = _poisson(side, 10, rate=500.0, max_new=3)
        t_end = max(t.arrival_s for t in burst)
        trace = burst + [dataclasses.replace(_poisson(side, 1, seed=9)[0],
                                             arrival_s=t_end + 1.0)]
        fleet = _fleet(side, n=2, autoscaler=scaler)
        done = fleet.run_trace(trace, engine=engine)
        assert len(done) == len(trace)
        ledgers.append([dataclasses.asdict(e) for e in fleet.scale_events])
    events = [e for e in ledgers[1]]
    ups = [e for e in events if e["action"] == "power_up"]
    assert ups
    drains = [e for e in events if e["action"] == "drain" and e["t_s"] > ups[0]["t_s"]]
    assert drains and drains[0]["t_s"] < t_end + 0.5
    assert ledgers[1] == ledgers[0]


# ------------------------------------------------------ batched replica axis
MODES = (
    ("batched", {"batch_replicas": True}),
    ("tuple", {"batch_replicas": False}),
    ("serial", {"batch_replicas": False, "fast_path_min": 99}),
)


def _modes(trace, n=4, archs=None, **opts):
    blobs, stats = {}, {}
    for mode, mopts in MODES:
        fleet = _fleet(PORT, n=n, archs=archs)
        o = dict({"fast_path_min": 2}, **opts, **mopts)
        done = fleet.run_trace(trace, engine_opts=o)
        assert len(done) == len(trace)
        blobs[mode], stats[mode] = _blob(done, fleet), fleet.last_engine_stats
    return blobs, stats


def test_batched_aligned_burst(weights):
    """Batched, tuple and serial dispatch replay byte-identically (sampled
    requests included); only the batched mode counts batched calls."""
    blobs, stats = _modes(_aligned(PORT, temps=True))
    assert blobs["batched"] == blobs["tuple"] == blobs["serial"]
    assert stats["batched"].batched_decode_calls > 0
    assert stats["batched"].fused_decode_calls == stats["tuple"].fused_decode_calls
    assert stats["tuple"].batched_decode_calls == 0 == stats["serial"].batched_decode_calls


def test_batched_drifted_quantum(weights):
    trace = [_req(PORT, 16, 1e-4 * i, 8, seed=30 + i, temp=0.7 if i % 4 == 0 else 0.0)
             for i in range(10)]
    blobs, stats = _modes(trace, n=6, fusion_quantum_s=0.5)
    assert blobs["batched"] == blobs["tuple"] == blobs["serial"]
    assert stats["batched"].batched_decode_calls > 0 and stats["batched"].pad_waste > 0


def test_batched_mixed_arch_fleet(weights):
    blobs, stats = _modes(_aligned(PORT, n=8, temps=True), archs=[ARCH, ARCH, ALT, ALT])
    assert blobs["batched"] == blobs["tuple"] == blobs["serial"]
    assert stats["batched"].batched_decode_calls > 0


def test_shard_map_layout_raises(weights):
    """Only an unknown layout raises. ``shard_map`` is accepted, from the
    engine and through ``FleetSpec.engine_opts``, and on one process (no
    group up) it steps the bank: the same replay as ``vmap``, batched calls
    and all (the reference's parity over it: ``PARITY["shard_map"]``)."""
    S.EventDrivenFleet(_fleet(PORT, n=2), batch_layout="shard_map")
    blobs, stats = [], []
    for layout in ("vmap", "shard_map"):
        fleet = _fleet(PORT, n=4, engine_opts={"batch_layout": layout, "fast_path_min": 2})
        blobs.append(_blob(fleet.run_trace(_aligned(PORT)), fleet))
        stats.append(_stats(fleet))
    assert blobs[0] == blobs[1] and stats[0] == stats[1]
    assert stats[1]["batched_decode_calls"] > 0
    with pytest.raises(ValueError, match="batch_layout"):
        S.EventDrivenFleet(_fleet(PORT, n=1), batch_layout="pmap")


def test_fused_cache_cap_is_refused(weights):
    """``fused_cache_cap`` caps the per-engine LRU of fused programs (at no
    less than 4), as the reference's does: ten synthetic inserts leave at
    most four entries and count ten ``fused_traces``; through
    ``FleetSpec.engine_opts`` the option reaches the engine."""
    eng = S.EventDrivenFleet(_fleet(PORT, n=2), fused_cache_cap=2)
    assert eng.fused_cache_cap == 4
    for i in range(10):
        eng._fused_fn(("decode", ("sig", i), 2), lambda: object())
    assert len(eng._fused_cache) <= 4 and eng.stats.fused_traces == 10
    assert list(eng._fused_cache)[-1] == ("decode", ("sig", 9), 2)
    fleet = _fleet(PORT, n=1, engine_opts={"fused_cache_cap": 4})
    assert len(fleet.run_trace(_aligned(PORT, n=1))) == 1


@pytest.mark.parametrize("seed,q", [(0, 0.0), (1, 0.001), (2, 0.01), (3, 0.25)])
def test_property_batched_equals_serial(weights, seed, q):
    rng = np.random.default_rng(seed)
    trace = [_req(PORT, int(rng.integers(4, 20)), float(rng.uniform(0, 0.005)),
                  int(rng.integers(2, 6)), seed=seed * 100 + i,
                  temp=0.7 if i % 3 == 0 else 0.0) for i in range(8)]
    serial = _run(trace, n=3, fast_path_min=99, batch_replicas=False)[1]
    batched = _run(trace, n=3, fast_path_min=2, fusion_quantum_s=q, batch_replicas=True)[1]
    assert batched == serial


def test_pad_waste_consistent_across_modes(weights):
    trace = [_req(PORT, 16, 1e-4 * i, 8, seed=30 + i) for i in range(10)]
    sts = {}
    for mode, opts in MODES[:2]:
        sts[mode] = _run(trace, n=6, fast_path_min=2, fusion_quantum_s=0.5,
                         **opts)[0].last_engine_stats
    b, t = sts["batched"], sts["tuple"]
    assert b.fused_decode_calls == t.fused_decode_calls and b.pad_waste == t.pad_waste
    assert b.batched_decode_calls == b.fused_decode_calls
    assert b.pad_waste < 6 * b.fused_decode_calls


def test_dispatch_wall_clock_ledger(weights):
    st = _run(_aligned(PORT), fast_path_min=2, time_dispatch=True)[0].last_engine_stats
    assert st.fused_decode_wall
    assert sum(int(v[0]) for v in st.fused_decode_wall.values()) == st.fused_decode_calls
    assert all(v[1] >= 0.0 for v in st.fused_decode_wall.values())
    assert all(int(k) > 0 and (int(k) & (int(k) - 1)) == 0 for k in st.fused_decode_wall)
    json.dumps(st.as_dict())


def test_batched_members_keep_their_caches(weights):
    """Members view rows of one bank and materialise into their own
    tensors: after batched fused steps every member's cache is a
    ``BankRow`` j of ONE bank (views of its rows, which the bank's tensors
    hold), while the pool's own cache tensors are the ones it was built
    with; a serial step copies the rows back into exactly those tensors."""
    fleet = _fleet(PORT, n=4)
    trace = _aligned(PORT, n=8, max_new=12)
    eng = S.EventDrivenFleet(fleet, fast_path_min=2)
    eng.run(trace[:4])
    pools = [r.decode_pool for r in fleet.replicas]
    own = [[t.data_ptr() for t in _tensors(p._own_cache)] for p in pools]
    eng = S.EventDrivenFleet(fleet, fast_path_min=2)
    eng.run(trace[4:])
    assert eng.stats.batched_decode_calls > 0
    rows = [p.cache for p in pools]
    assert all(isinstance(c, S.BankRow) for c in rows)
    assert len({id(c.bank) for c in rows}) == 1 and [c.index for c in rows] == [0, 1, 2, 3]
    bank = rows[0].bank
    assert set(bank.viewers) == set(pools)
    for j, c in enumerate(rows):
        for v, t in zip(_tensors(dict(c)), _tensors(bank.tree)):
            assert v.untyped_storage().data_ptr() == t.untyped_storage().data_ptr()
            assert torch.equal(v, t[:, j * 2:(j + 1) * 2])
    want = [[t.clone() for t in _tensors(dict(c))] for c in rows]
    for p, w, ptrs in zip(pools, want, own):
        before = p.jit_dispatches
        p.materialize_cache()
        assert p.cache is p._own_cache and p.jit_dispatches == before + 1
        assert [t.data_ptr() for t in _tensors(p.cache)] == ptrs
        assert all(torch.equal(a, b) for a, b in zip(_tensors(p.cache), w))
    assert not bank.viewers


@pytest.mark.parametrize("k", [2, 3])
def test_place_many_equals_sequential_place(weights, k):
    """``place_many`` scatters exactly its K rows in one dispatch (the
    reference pads K = 3 to 4 by a repeat of row 0): the cache, slots,
    lengths and next tokens equal those of K ``place`` calls."""
    cfg, params = reduced_config(ARCH), _weights()[ARCH][1]
    rng = np.random.default_rng(k)
    prompts = [rng.integers(1, 100, n).astype(np.int32) for n in (5, 11, 8)[:k]]
    pools = []
    for many in (True, False):
        pp, dp = (S.Pool(cfg, params, role=role, max_batch=4, max_seq_len=64,
                         clock=VirtualClock(), device="cpu")
                  for role in ("prefill", "decode"))
        items = []
        for i, prompt in enumerate(prompts):
            req = pool_mod.Request(uid=i, prompt=prompt, max_new_tokens=4)
            first, cache1 = pp.prefill_request(req)
            items.append((req, cache1, first, len(prompt), pp.clock.now_s))
        before = dp.jit_dispatches
        if many:
            slots = dp.place_many(items)
        else:
            slots = [dp.place(r, c, f, n, first_token_s=t) for r, c, f, n, t in items]
        pools.append((dp, slots, dp.jit_dispatches - before))
    (a, slots_a, calls_a), (b, slots_b, calls_b) = pools
    assert slots_a == slots_b == list(range(k)) and (calls_a, calls_b) == (1, k)
    assert all(torch.equal(x, y) for x, y in zip(_tensors(a.cache), _tensors(b.cache)))
    assert np.array_equal(a._host_lengths, b._host_lengths)
    assert np.array_equal(a._host_cur_token, b._host_cur_token)
    assert [r and r.uid for r in a.slot_req] == [r and r.uid for r in b.slot_req]


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


# ------------------------------------------------------------- params tokens
def test_params_token_is_stable_and_distinct():
    a, b = {"w": np.zeros(2)}, {"w": np.zeros(2)}
    ta, tb = S.params_token_for(a), S.params_token_for(b)
    assert ta != tb and S.params_token_for(a) == ta and S.params_token_for(b) == tb


def test_recycled_id_never_reuses_a_token():
    seen = set()
    for _ in range(50):
        p = {"w": np.zeros(1)}
        tok = S.params_token_for(p)
        assert tok not in seen
        seen.add(tok)
        del p


def test_params_registry_is_capped():
    keep = [{"i": i} for i in range(pool_mod._PARAMS_TOKEN_CAP + 16)]
    for p in keep:
        S.params_token_for(p)
    assert len(pool_mod._PARAMS_TOKENS) <= pool_mod._PARAMS_TOKEN_CAP
    t0 = S.params_token_for(keep[0])
    assert t0 == S.params_token_for(keep[0])


def test_params_registry_keeps_no_weights_alive():
    """The registry identifies a params tree by a weak reference to its
    first leaf, so a model's weights are freed with the model (the
    reference's registry holds up to 64 trees strongly), and a tree at a
    recycled id with other weights gets a fresh token."""
    import weakref

    params = {"embed": {"table": torch.zeros(4)}, "stages": []}
    tok = S.params_token_for(params)
    leaf = weakref.ref(params["embed"]["table"])
    key = id(params)
    del params
    gc.collect()
    assert leaf() is None
    assert pool_mod._PARAMS_TOKENS[key][0]() is None
    again = {"embed": {"table": torch.zeros(4)}, "stages": []}
    assert S.params_token_for(again) != tok


def test_freed_fleet_no_cache_cross_talk(weights):
    """Run fleet A, free it, build fleet B with other weights: B's fused
    replay equals B's own serial replay."""
    trace = _aligned(PORT, n=8, temps=True)
    fleet_a, _ = _run(trace, fast_path_min=2)
    del fleet_a
    gc.collect()
    jp = R.init_params(jax_reduced_config(ARCH), jax.random.PRNGKey(7))
    other = T.params_from_numpy(jax.tree.map(np.asarray, jp), reduced_config(ARCH),
                                device="cpu")
    blobs = []
    for opts in ({"fast_path_min": 2}, {"fast_path_min": 99, "batch_replicas": False}):
        spec = S.FleetSpec(replicas=tuple(
            S.ReplicaSpec(name=f"r{i}", arch=ARCH, clock=S.ClockSpec(mode="lock"),
                          decode=S.PoolSpec(batch=2), max_seq_len=64, prefill_chunk_tokens=64)
            for i in range(4)), router="jsq")
        fleet = S.Fleet.from_spec(spec, emodel=EnergyModel(H200_SXM),
                                  params_for={ARCH: other}, device="cpu")
        blobs.append(_blob(fleet.run_trace(trace, engine_opts=opts), fleet))
        if opts["fast_path_min"] == 2:
            assert fleet.last_engine_stats.batched_decode_calls > 0
    assert blobs[0] == blobs[1]


def test_pools_carry_the_token(weights):
    fleet = _fleet(PORT, n=2)
    toks = {p.params_token for r in fleet.replicas for p in r.pools().values()}
    assert toks == {S.params_token_for(_weights()[ARCH][1])}


# ------------------------------------------------------- engine options spec
def test_spec_opts_pin_the_mode_and_calls_override(weights):
    opts = {"batch_replicas": False, "fast_path_min": 2}
    trace = _aligned(PORT, n=6, max_new=4)
    fleet = _fleet(PORT, n=3, engine_opts=opts)
    fleet.run_trace(trace)
    assert fleet.last_engine_stats.fused_decode_calls > 0
    assert fleet.last_engine_stats.batched_decode_calls == 0
    fleet = _fleet(PORT, n=3, engine_opts=opts)
    fleet.run_trace(trace, engine_opts={"batch_replicas": True})
    assert fleet.last_engine_stats.batched_decode_calls > 0


def test_on_finish_streams_and_releases(weights):
    """``on_finish`` receives every finished request instead of the return
    list; releasing each one recycles it, and the stream equals a plain
    replay's."""
    trace = _poisson(PORT, 10, rate=200.0)
    fleet = _fleet(PORT, n=2)
    want = sorted((tuple(r.prompt), r.output) for r in fleet.run_trace(trace))
    seen = []

    def take(req):
        seen.append((tuple(req.prompt), list(req.output)))
        pool_mod.release_request(req)

    fleet = _fleet(PORT, n=2)
    assert fleet.run_trace(trace, engine_opts={"on_finish": take}) == []
    assert sorted(seen) == want
    assert pool_mod._REQUEST_FREELIST
    pool_mod._REQUEST_FREELIST.clear()


# ------------------------------------------------------------- the recipes
def test_serve_trace_smoke_replay_matches_reference(weights):
    """``serve_trace``'s smoke-size replay (60 requests, minicpm-2b, slo —
    the recipe's determinism replay) on the default engine: the port's row
    equals the reference's, so their sha256 are equal."""
    arch = "minicpm-2b"
    jp = R.init_params(jax_reduced_config(arch), jax.random.PRNGKey(0))
    tp = T.params_from_numpy(jax.tree.map(np.asarray, jp), reduced_config(arch), device="cpu")
    tbt_s, ttft_s, rate = j_serve_trace.slo_targets(j_serve_trace.h200_model(),
                                                    jax_get_config(arch))
    jtrace = j_serve_trace.generate_trace(
        jax_reduced_config(arch), 60, arrival="poisson", lengths="short_chat", rate_rps=rate,
        seed=j_serve_trace.TRACE_SEED, max_total_len=j_serve_trace.MAX_SEQ_LEN)
    ref, _ = j_serve_trace.replay(arch, "slo", jtrace, tbt_s, ttft_s)
    got, _, _ = t_serve_trace.replay(arch, "slo", t_serve_trace.make_trace(arch, 60, rate),
                                     tbt_s, ttft_s, params=tp, device="cpu")
    assert json.dumps(got, sort_keys=True) == json.dumps(ref, sort_keys=True)


def test_serve_events_smoke_matches_reference(weights):
    """``serve_events``' smoke recipe (16 replicas on one weight set, 2000
    requests in aligned waves, twice, then the burst trace on both engines)
    on the reference's weights: its assertions hold, and every row (the
    replay sha256, decode steps, fused calls, joules and p99 TTFT) equals
    the reference recipe's, apart from the wall-clock fields."""
    def strip(rows):
        return [(name, ";".join(f for f in derived.split(";") if not f.startswith(
            ("wall_s=", "slowest_replay_s=")))) for name, _, derived in rows]

    rows = t_serve_events.run(smoke=True, device="cpu", params_for={ARCH: _weights()[ARCH][1]})
    assert strip(rows) == strip(j_serve_events.run(smoke=True))
    assert ("serve_events/fused", "fused_calls=129;fused_step_pct=100.0") in strip(rows)
