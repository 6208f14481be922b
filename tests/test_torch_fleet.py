"""The port's fleet stack against the JAX one: traces, specs, routers,
the autoscaler, drain / power gating, and the refusals.

``generate_trace`` gives byte-identical traces for every arrival process and
length profile; a ``FleetSpec`` round-trips to the same JSON on both sides.
Fleets of reduced qwen3-4b (GQA), minitron-4b-mla (MLA) and gdn-4b (Gated
DeltaNet), weights from ``repro.models.init_params`` through numpy, each
replica on its own pair of ``VirtualClock``s (decode and prefill, as
``Fleet.from_spec`` builds them), replay a diurnal mixed trace with
``engine="barrier"`` on both sides behind every router: placements, token
streams, every ledger stamp, each replica's ``PhaseStats``, measured joules,
controller transitions and ``TrafficCounter``, the scheduler's migrations
and the ``ScaleEvent`` list must all be equal, also under the ``queue`` and
``schedule`` autoscalers (held against a live reference replay). Then the
drain / power-down / power-up behaviour of ``tests/test_fleet.py``, a fleet
of one against the ``Cluster``, ``ServingEngine.from_spec``, what the port
refuses (the event engine on a virtual clock, prefix sharing), and the two
benchmarks' ``--smoke`` recipes on the CPU, whose rows equal the reference
recipes' on the same weights.
"""
import dataclasses
import itertools
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.models as R
from repro.configs import reduced_config as jax_reduced_config
from repro.core.clock import VirtualClock as JVirtualClock
from repro.core.energy import EnergyModel as JEnergyModel
from repro.core.traces import generate_trace as jax_generate_trace
from repro.hw import H200_SXM as J_H200
from repro.serving import Cluster as JCluster
from repro.serving import Fleet as JFleet
from repro.serving import FleetSpec as JFleetSpec
from repro.serving import ReplicaSpec as JReplicaSpec
import repro_torch.models as T
from repro_torch.benchmarks import serve_cluster as t_serve_cluster
from repro_torch.benchmarks import serve_trace as t_serve_trace
from repro_torch.benchmarks.common import deterministic_fields
from repro_torch.configs import reduced_config
from repro_torch.core.clock import VirtualClock
from repro_torch.core.energy import EnergyModel
from repro_torch.core.latency import summarize_latency
from repro_torch.core.traces import ARRIVALS, LENGTHS, generate_trace
from repro_torch.hw import H200_SXM
from repro_torch.serving import (
    AutoscalerSpec,
    ClockSpec,
    Cluster,
    Fleet,
    FleetSpec,
    PoolSpec,
    Replica,
    ReplicaSpec,
    ServingEngine,
)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import benchmarks.serve_autoscale as j_serve_autoscale  # noqa: E402
import benchmarks.serve_cluster as j_serve_cluster  # noqa: E402
import benchmarks.serve_trace as j_serve_trace  # noqa: E402

HET = ("qwen3-4b", "minitron-4b-mla", "gdn-4b")
ROUTERS = ("jsq", "rr", "energy", "affinity", "prefix")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are tiny: torch's intra-op threads only spin
    on them (2.5x the CPU time for the same wall time here), which takes
    cores from the other workers of a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """arch -> (reference params, port params) of the reduced config."""
    out = {}
    for arch in HET + ("minicpm-2b", "mamba2-780m", "gemma-2b"):
        jp = R.init_params(jax_reduced_config(arch), jax.random.PRNGKey(0))
        out[arch] = (jp, T.params_from_numpy(jax.tree.map(np.asarray, jp),
                                             reduced_config(arch), device="cpu"))
    return out


def _rspec(name, arch, *, mode="lock", batch=4, paged=True, kv_blocks=48, **clock_kw):
    return ReplicaSpec(
        name=name, arch=arch,
        clock=ClockSpec(mode=mode, context_scale=256.0, fused=True, **clock_kw),
        decode=PoolSpec(batch=batch, paged=paged, kv_block_size=8,
                        kv_blocks=kv_blocks if paged else None),
        max_seq_len=128, prefill_chunk_tokens=64,
    )


def _trace(mod, n=12, *, seed=23, rate=40.0):
    return mod(jax_reduced_config("qwen3-4b") if mod is jax_generate_trace
               else reduced_config("qwen3-4b"), n, arrival="diurnal", lengths="mixed",
               mix_long=0.5, seed=seed, max_total_len=128, rate_rps=rate,
               arrival_kwargs={"period_s": n / rate / 2.0})


def _stamps(req):
    lg = req.ledger
    return (lg.arrival_s, lg.admitted_s, lg.first_token_s, list(lg.token_s), lg.finish_s)


def _fingerprint(fleet, done):
    done = sorted(done, key=lambda r: (r.ledger.arrival_s, r.replica, r.uid))
    return {
        "requests": [(r.uid, r.replica, r.bucket, r.output, _stamps(r), r.prefill_j,
                      r.decode_j, r.decode_read_bytes, r.decode_write_bytes, r.preemptions)
                     for r in done],
        "stats": {n: dataclasses.asdict(s) for n, s in fleet.stats_by_replica().items()},
        "prefill_stats": {r.name: dataclasses.asdict(r.prefill_stats) for r in fleet.replicas},
        "measured": fleet.measured_energy_j(),
        "total_j": fleet.total_energy_j(),
        "transitions": {r.name: [dataclasses.asdict(t) for t in r.controller.transitions]
                        for r in fleet.replicas},
        "traffic": {r.name: dataclasses.asdict(r.decode_pool.traffic) for r in fleet.replicas},
        "migrations": {r.name: r.scheduler.migrations for r in fleet.replicas},
        "powered": {r.name: r.powered for r in fleet.replicas},
        "scale_events": [dataclasses.asdict(e) for e in fleet.scale_events],
        "latency": dataclasses.asdict(summarize_latency(done)),
    }


def _replay_pair(weights, spec, jtrace, trace, *, drain=None):
    """(reference, port) fingerprints of one barrier replay of ``spec``."""
    jspec = JFleetSpec.from_json(spec.to_json())
    out = []
    for fleet_cls, model_cls, chip, s, tr, side, kw in (
            (JFleet, JEnergyModel, J_H200, jspec, jtrace, 0, {}),
            (Fleet, EnergyModel, H200_SXM, spec, trace, 1, {"device": "cpu"})):
        params = {r.arch: weights[r.arch][side] for r in spec.replicas}
        fleet = fleet_cls.from_spec(s, emodel=model_cls(chip), params_for=params, **kw)
        if drain:
            fleet.drain(drain)
        done = fleet.run_trace(tr, engine="barrier")
        out.append(_fingerprint(fleet, done))
    return out


# ------------------------------------------------------------ traces, specs
@pytest.mark.parametrize("arrival,lengths", list(itertools.product(ARRIVALS, LENGTHS)))
def test_generate_trace_bytes_equal(arrival, lengths):
    kw = dict(arrival=arrival, lengths=lengths, rate_rps=30.0, seed=5, max_total_len=96,
              mix_long=0.4)
    ref = jax_generate_trace(jax_reduced_config("gemma-2b"), 25, **kw)
    got = generate_trace(reduced_config("gemma-2b"), 25, **kw)
    assert len(got) == len(ref) == 25
    for a, b in zip(ref, got):
        assert b.prompt.dtype == a.prompt.dtype and b.prompt.tobytes() == a.prompt.tobytes()
        assert (b.arrival_s, b.max_new_tokens, b.bucket, b.temperature) == \
            (a.arrival_s, a.max_new_tokens, a.bucket, a.temperature)


def test_spec_json_roundtrip_is_the_same_on_both_sides():
    spec = FleetSpec(
        replicas=(_rspec("a", "qwen3-4b", mode="slo", slo_tbt_s=0.5, slo_ttft_s=5.0),
                  ReplicaSpec(name="b", arch="gdn-4b",
                              clock=ClockSpec(mode="cap", cap_w=450.0, fused=True),
                              decode=PoolSpec(batch=4, paged=True, kv_block_size=8,
                                              kv_blocks=48),
                              max_seq_len=64, prefill_chunk_tokens=32, rng_seed=7)),
        router="energy", router_args={"headroom": 0.75},
        autoscaler=AutoscalerSpec(policy="schedule", warmup_s=0.5, replica_rps=3.0),
    )
    blob = spec.to_json()
    assert FleetSpec.from_json(blob) == spec
    assert JFleetSpec.from_json(blob).to_json() == blob
    assert FleetSpec.from_json(JFleetSpec.from_json(blob).to_json()).to_json() == blob


# ----------------------------------------------------------- fleet replays
@pytest.mark.parametrize("router", ROUTERS)
def test_heterogeneous_fleet_matches_reference(weights, router):
    """``prefix`` finds no shared prefix on either side (sharing off), so it
    places as join-shortest-queue does."""
    spec = FleetSpec(replicas=tuple(_rspec(f"r{i}-{a}", a) for i, a in enumerate(HET)),
                     router=router,
                     router_args={"headroom": 0.75} if router == "energy" else {})
    ref, got = _replay_pair(weights, spec, _trace(jax_generate_trace), _trace(generate_trace))
    assert got == ref
    assert len(got["requests"]) == 12
    if router == "prefix":
        jsq = FleetSpec(replicas=spec.replicas, router="jsq")
        assert _replay_pair(weights, jsq, _trace(jax_generate_trace),
                            _trace(generate_trace))[1] == got


@pytest.mark.parametrize("policy", ["queue", "schedule"])
def test_autoscaled_fleet_matches_reference(weights, policy):
    """``serve_autoscale``'s fleet (four reduced qwen3-4b, ``jsq``) on a
    40-request diurnal trace: the ``ScaleEvent`` list equals a live
    reference replay's, as does everything else."""
    ja = j_serve_autoscale
    tbt_s, ttft_s, replica_rps, t_dec = ja.autoscale_targets(ja.h200_model())
    rate = ja.RATE_X * replica_rps
    period_s = 40 / rate / 2.0
    scaler = ja.autoscaler_spec(policy, t_dec=t_dec, replica_rps=replica_rps,
                                period_s=period_s, tbt_s=tbt_s)
    spec = FleetSpec.from_json(ja.fleet_spec("auto", tbt_s, ttft_s, scaler).to_json())
    jtrace = ja.make_trace(40, rate, period_s)
    trace = generate_trace(
        reduced_config(ja.ARCH), 40, arrival="diurnal", lengths="mixed", mix_long=ja.MIX_LONG,
        seed=ja.TRACE_SEED, max_total_len=ja.MAX_SEQ_LEN, rate_rps=rate,
        arrival_kwargs={"period_s": period_s, "depth": ja.DIURNAL_DEPTH})
    ref, got = _replay_pair(weights, spec, jtrace, trace)
    assert got == ref
    assert len(got["requests"]) == 40
    assert {e["action"] for e in got["scale_events"]} >= {"park", "power_up"}


def test_drained_replica_accrues_zero_joules(weights):
    spec = FleetSpec(replicas=(_rspec("live", "qwen3-4b"), _rspec("parked", "gdn-4b")))
    jtrace, trace = _trace(jax_generate_trace, 6), _trace(generate_trace, 6)
    ref, got = _replay_pair(weights, spec, jtrace, trace, drain="parked")
    assert got == ref
    assert all(r[1] == "live" for r in got["requests"])
    assert not got["powered"]["parked"]
    assert got["measured"]["parked"] == {"prefill": 0.0, "decode": 0.0}
    assert [e["action"] for e in got["scale_events"]] == ["drain", "power_down"]
    # control: without the drain the second replica burns idle-floor watts
    ref2, got2 = _replay_pair(weights, spec, jtrace, trace)
    assert got2 == ref2 and sum(got2["measured"]["parked"].values()) > 0


def test_power_down_refuses_busy_and_power_up_restores(weights):
    spec = FleetSpec(replicas=(_rspec("a", "qwen3-4b"), _rspec("b", "qwen3-4b")))
    fleet = Fleet.from_spec(spec, emodel=EnergyModel(H200_SXM),
                            params_for={"qwen3-4b": weights["qwen3-4b"][1]}, device="cpu")
    fleet.submit(np.arange(1, 9, dtype=np.int32), 4)
    busy = next(r for r in fleet.replicas if r.busy())
    with pytest.raises(RuntimeError, match="drain it first"):
        busy.power_down()
    idle = next(r for r in fleet.replicas if not r.busy())
    fleet.drain(idle.name)
    assert not idle.routable() and not idle.powered
    assert idle.decode_pool.idle_power_w == 0.0
    fleet.power_up(idle.name, warmup_s=0.25)
    assert idle.routable() and idle.warming()
    assert idle.decode_pool.idle_power_w == pytest.approx(H200_SXM.p_idle)
    assert [e.action for e in fleet.scale_events] == ["drain", "power_down", "power_up"]
    fleet.drain(busy.name)                  # busy: keeps serving, not parked
    assert busy.powered and fleet.route(prompt_len=8, max_new_tokens=2) is idle
    done = fleet.run_to_completion()
    assert len(done) == 1 and not busy.powered


def test_fleet_of_one_against_the_cluster(weights):
    """``tests/test_fleet.py``'s facade contract on the port, on its recipe
    (reduced gemma-2b, batch 2, six requests). The port's fleet of one
    (split decode / prefill clocks) and its ``Cluster`` (one shared clock)
    each equal the reference's barrier replay, measured joules included;
    between them tokens, modelled joules, measured prefill joules and the
    latency summary are equal. Their measured decode joules part under the
    barrier, in the reference too (``ROADMAP.md`` section 3: the byte
    identity of ``tests/test_fleet.py`` holds on the reference's event
    engine)."""
    trace = [dataclasses.replace(t, max_new_tokens=4) for t in generate_trace(
        reduced_config("gemma-2b"), 6, arrival="poisson", lengths="short_chat",
        rate_rps=50.0, seed=3, max_total_len=48)]
    rspec = ReplicaSpec(name="solo", arch="gemma-2b", clock=ClockSpec(mode="lock"),
                        decode=PoolSpec(batch=2), max_seq_len=64, prefill_chunk_tokens=64)
    jrspec = JReplicaSpec.from_dict(json.loads(json.dumps(dataclasses.asdict(rspec))))

    def blob(done, decode_j, prefill_j, measured):
        done = sorted(done, key=lambda r: r.uid)
        return {"outputs": [r.output for r in done], "decode_j": decode_j,
                "prefill_j": prefill_j, "measured": measured,
                "lat": dataclasses.asdict(summarize_latency(done))}

    runs = {}
    for side, cluster_cls, fleet_cls, fleet_spec_cls, model_cls, chip, clock_cls, rs, kw in (
            ("ref", JCluster, JFleet, JFleetSpec, JEnergyModel, J_H200, JVirtualClock,
             jrspec, {}),
            ("port", Cluster, Fleet, FleetSpec, EnergyModel, H200_SXM, VirtualClock, rspec,
             {"device": "cpu"})):
        params = weights["gemma-2b"][side == "port"]
        cluster = cluster_cls.from_spec(rs, emodel=model_cls(chip), params=params,
                                        clock=clock_cls(), **kw)
        cdone = cluster.run_trace(trace, engine="barrier")
        fleet = fleet_cls.from_spec(fleet_spec_cls(replicas=(rs,)), emodel=model_cls(chip),
                                    params_for={"gemma-2b": params}, **kw)
        fdone = fleet.run_trace(trace, engine="barrier")
        runs[side] = (blob(cdone, cluster.decode_stats.decode_j, cluster.prefill_stats.prefill_j,
                           cluster.measured_energy_j()),
                      blob(fdone, fleet.stats.decode_j, fleet.stats.prefill_j,
                           fleet.measured_energy_j()["solo"]))
        if side == "port":
            assert cluster.prefill_pool.clock is cluster.decode_pool.clock
            solo = fleet.replicas[0]
            assert solo.prefill_pool.clock is not solo.decode_pool.clock
    assert runs["port"] == runs["ref"]
    cl, fl = runs["port"]
    assert len(cl["outputs"]) == 6
    assert {k: v for k, v in cl.items() if k != "measured"} == \
        {k: v for k, v in fl.items() if k != "measured"}
    assert cl["measured"]["prefill"] == fl["measured"]["prefill"]


def test_engine_builds_from_spec(weights):
    eng = ServingEngine.from_spec(_rspec("eng", "qwen3-4b", batch=2),
                                  params=weights["qwen3-4b"][1], device="cpu")
    assert eng.max_batch == 2 and eng.max_seq_len == 128 and eng.pool.paged
    req = eng.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=3)
    eng.run_to_completion()
    assert req.done and len(req.output) == 3 and eng.stats.prefill_j > 0
    seeded = ServingEngine.from_spec(_rspec("eng", "qwen3-4b", batch=2), device="cpu")
    again = ServingEngine.from_spec(_rspec("eng", "qwen3-4b", batch=2), device="cpu")
    assert all(bool((a == b).all()) for a, b in zip(_leaves(seeded.params), _leaves(again.params)))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------- refusals
def test_event_engine_is_refused_on_a_virtual_clock(weights):
    """The event engine runs on a virtual clock, and refuses there, before
    anything runs, an unknown ``batch_layout`` and, as the reference, a
    fleet whose replicas have no controller. ``batch_layout="shard_map"``
    runs (on one process it steps the bank, as the reference runs ``vmap``
    on one device), through a ``Fleet`` and a ``Cluster``."""
    tp = weights["qwen3-4b"][1]
    rspec = _rspec("solo", "qwen3-4b")
    fleet = Fleet.from_spec(FleetSpec(replicas=(rspec,)), emodel=EnergyModel(H200_SXM),
                            params_for={"qwen3-4b": tp}, device="cpu")
    with pytest.raises(ValueError, match="batch_layout"):
        fleet.run_trace(_trace(generate_trace, 2), engine_opts={"batch_layout": "pmap"})
    cluster = Cluster.from_spec(rspec, params=tp, clock=VirtualClock(), device="cpu")
    with pytest.raises(ValueError, match="batch_layout"):
        cluster.run_trace(_trace(generate_trace, 2), engine="events",
                          engine_opts={"batch_layout": "pmap"})
    assert not fleet.busy() and not cluster.busy()                       # nothing ran
    assert len(fleet.run_trace(_trace(generate_trace, 2),
                               engine_opts={"batch_layout": "shard_map"})) == 2
    assert len(cluster.run_trace(_trace(generate_trace, 2), engine="events",
                                 engine_opts={"batch_layout": "shard_map"})) == 2
    bare = Fleet([Replica(reduced_config("qwen3-4b"), tp, max_seq_len=64, decode_batch=2,
                          clock=VirtualClock(), device="cpu")])
    with pytest.raises(ValueError, match="ClockController"):
        bare.run_trace(_trace(generate_trace, 2))
    assert not fleet.busy() and not cluster.busy() and not bare.busy()   # nothing ran


def test_prefix_sharing_is_refused(weights):
    """Prefix sharing is refused where the reference refuses it: on a dense
    decode pool and on a config with a block kind whose state is not
    position-addressable. A pool with sharing off shares nothing."""
    tp = weights["qwen3-4b"][1]
    with pytest.raises(ValueError, match="requires paged=True"):
        PoolSpec(batch=2, prefix_sharing=True)
    with pytest.raises(ValueError, match="requires paged=True"):
        Replica(reduced_config("qwen3-4b"), tp, max_seq_len=64, decode_batch=2,
                prefix_sharing=True, device="cpu")
    spec = ReplicaSpec(name="p", arch="qwen3-4b", decode=PoolSpec(batch=2), max_seq_len=64)
    gdn = ReplicaSpec(name="g", arch="gdn-4b",
                      decode=PoolSpec(batch=2, paged=True, kv_block_size=8,
                                      prefix_sharing=True),
                      max_seq_len=64)
    with pytest.raises(ValueError, match="attention-family blocks only"):
        Replica.from_spec(gdn, params=weights["gdn-4b"][1], device="cpu")
    replica = Replica.from_spec(spec, params=tp, device="cpu")
    req = replica.submit(np.arange(1, 9, dtype=np.int32), 2)
    pool = replica.decode_pool
    assert pool.prefix_acquire(req) is None and pool._peek_fitted(req.prompt) == (0, 0)
    assert pool.prefill_cost_tokens(req) == 8
    assert pool.occupancy() == 0 and req.ledger.admitted_s is None


def test_entry_points_default_to_cuda(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Cluster(reduced_config("qwen3-4b"), weights["qwen3-4b"][1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Replica.from_spec(_rspec("x", "qwen3-4b"))


# -------------------------------------------------------------- benchmarks
def test_serve_cluster_smoke_and_rows_match_reference(weights, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    rows = t_serve_cluster.run(smoke=True, device="cpu",
                               params_for={"minicpm-2b": weights["minicpm-2b"][1]})
    assert [r[0] for r in rows][:3] == [f"serve_cluster/minicpm-2b/{m}"
                                        for m in t_serve_cluster.MODES]
    ref = j_serve_cluster.serve_one("mamba2-780m", "lock")
    got = t_serve_cluster.serve_one("mamba2-780m", "lock", params=weights["mamba2-780m"][1],
                                    device="cpu")
    volatile = t_serve_cluster.VOLATILE
    assert deterministic_fields(got, volatile) == deterministic_fields(ref, volatile)
    assert got["run"]["graph_replays"] == 0 and got["run"]["decode_steps"] > 0


def test_serve_trace_smoke_and_rows_match_reference(weights, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    rows = t_serve_trace.run(smoke=True, write_json=True, device="cpu",
                             params_for={a: weights[a][1] for a in t_serve_trace.ARCHS})
    assert ("serve_trace/determinism" in [r[0] for r in rows]
            and (tmp_path / t_serve_trace.JSON_PATH).exists())
    arch, mode = "mamba2-780m", "slo"
    tbt_s, ttft_s, rate = j_serve_trace.slo_targets(j_serve_trace.h200_model(),
                                                    j_serve_trace.get_config(arch))
    jtrace = j_serve_trace.generate_trace(
        jax_reduced_config(arch), 60, arrival="poisson", lengths="short_chat",
        rate_rps=rate, seed=j_serve_trace.TRACE_SEED, max_total_len=j_serve_trace.MAX_SEQ_LEN)
    cluster = JCluster.from_spec(j_serve_trace.replica_spec(arch, mode, tbt_s, ttft_s),
                                 emodel=j_serve_trace.h200_model(),
                                 params=weights[arch][0], clock=JVirtualClock())
    done = cluster.run_trace(jtrace, engine="barrier")
    got, _, _ = t_serve_trace.replay(arch, mode, t_serve_trace.make_trace(arch, 60, rate),
                                  tbt_s, ttft_s, params=weights[arch][1], device="cpu")
    assert got["completed"] == len(done) == 60
    assert got["decode_j"] == cluster.decode_stats.decode_j
    assert got["p99_tbt_s"] == summarize_latency(done).p99_tbt_s
    assert got["measured_decode_j"] == cluster.measured_energy_j()["decode"]
    assert got["transitions"] == len(cluster.controller.transitions)
