"""The port's phase-disaggregated ``Cluster`` against the JAX one.

Reduced minicpm-2b (MHA) and reduced mamba2-780m (Mamba2 SSD), weights from
``repro.models.init_params`` through numpy, the ``serve_cluster`` prompt
recipe, under the controller modes default / cap / lock, dense, paged and
paged with a block budget that forces preemption, on a ``VirtualClock``:
greedy token streams, every ledger stamp, both pools' ``PhaseStats``, the
sampler's measured joules, the controller's transitions, the decode pool's
``TrafficCounter`` and the scheduler's migrations must all be equal. On a
wall clock the tokens and the traffic-derived decode joules must be. Trace
replays (``serve_trace``'s recipe, 20 requests) give the sha256 of the
reference's replay on each engine: the default (event) engine and the
barrier, which parts from the event engine in the last bits of the
measured joules (``ROADMAP.md`` section 3). Then the properties of
``tests/test_cluster.py`` held on the port, the request freelist and the
``Scheduler.tick`` hooks.
"""
import dataclasses
import hashlib
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.models as R
from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.core.clock import VirtualClock as JVirtualClock
from repro.core.energy import EnergyModel as JEnergyModel
from repro.hw import H200_SXM as J_H200
from repro.serving import ClockController as JController
from repro.serving import Cluster as JCluster
from repro.training import make_prompts
import repro_torch.models as T
from repro_torch.benchmarks import serve_trace as t_serve_trace
from repro_torch.benchmarks.common import deterministic_fields
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.clock import VirtualClock
from repro_torch.core.energy import EnergyModel
from repro_torch.hw import H200_SXM
from repro_torch.serving import ClockController, Cluster, ServingEngine
from repro_torch.serving import pool as tpool

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import benchmarks.serve_trace as j_serve_trace  # noqa: E402

ARCHS = ("minicpm-2b", "mamba2-780m")
MODES = ("default", "cap", "lock")
LAYOUTS = {"dense": (False, None), "paged": (True, 80), "paged_tight": (True, 12)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are tiny: torch's intra-op threads only spin
    on them (2.5x the CPU time for the same wall time here), which takes
    cores from the other workers of a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(arch):
    jcfg = jax_reduced_config(arch)
    jp = R.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced_config(arch)
    return jcfg, jp, cfg, T.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")


@pytest.fixture(scope="module")
def weights():
    return {arch: _weights(arch) for arch in ARCHS}


def _stamps(req):
    lg = req.ledger
    return (lg.arrival_s, lg.admitted_s, lg.first_token_s, list(lg.token_s), lg.finish_s)


def _fingerprint(cluster, reqs):
    ctl = cluster.controller
    return {
        "tokens": [r.output for r in reqs],
        "stamps": [_stamps(r) for r in reqs],
        "request_j": [(r.prefill_j, r.decode_j, r.decode_read_bytes, r.decode_write_bytes,
                       r.preemptions) for r in reqs],
        "prefill_stats": dataclasses.asdict(cluster.prefill_stats),
        "decode_stats": dataclasses.asdict(cluster.decode_stats),
        "measured": cluster.measured_energy_j(),
        "transitions": [dataclasses.asdict(t) for t in ctl.transitions] if ctl else None,
        "traffic": dataclasses.asdict(cluster.decode_pool.traffic),
        "migrations": cluster.scheduler.migrations,
        "peak_occupancy": cluster.decode_pool.peak_occupancy,
    }


def _run_pair(weights, arch, mode, paged, kv_blocks, *, virtual=True, n=8, max_new=8):
    """(reference fingerprint, port fingerprint) of one cluster run."""
    jcfg, jp, cfg, tp = weights[arch]
    prompts = make_prompts(jcfg, n, 8, 24, seed=11)
    kw = dict(decode_batch=4, max_seq_len=128, prefill_chunk_tokens=32, paged=paged,
              kv_block_size=8, kv_blocks=kv_blocks, meter_interval_s=0.01)
    out = []
    for cluster_cls, ctl_cls, model_cls, chip, clock_cls, c, full, p, extra in (
            (JCluster, JController, JEnergyModel, J_H200, JVirtualClock, jcfg,
             jax_get_config(arch), jp, {}),
            (Cluster, ClockController, EnergyModel, H200_SXM, VirtualClock, cfg,
             get_config(arch), tp, {"device": "cpu"})):
        ctl = ctl_cls(model_cls(chip), full, mode=mode)
        clock = {"clock": clock_cls()} if virtual else {}
        cluster = cluster_cls(c, p, controller=ctl, **clock, **kw, **extra)
        reqs = [cluster.submit(x, max_new_tokens=max_new) for x in prompts]
        cluster.run_to_completion()
        out.append(_fingerprint(cluster, reqs))
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cluster_matches_reference(weights, arch, mode, layout):
    paged, kv_blocks = LAYOUTS[layout]
    ref, got = _run_pair(weights, arch, mode, paged, kv_blocks)
    assert got == ref
    eos = weights[arch][2].eos_token_id
    assert all(len(r) == 8 or r[-1] == eos for r in got["tokens"])
    assert got["migrations"] == 8 + sum(r[-1] for r in got["request_j"])
    assert got["measured"]["decode"] > 0 and got["decode_stats"]["decode_j"] > 0
    if layout == "paged_tight":
        assert sum(r[-1] for r in ref["request_j"]) > 0      # preemption happened


@pytest.mark.parametrize("arch", ARCHS)
def test_cluster_on_a_wall_clock_matches_reference(weights, arch):
    """Wall-clock stamps differ run to run; tokens and the traffic-derived
    decode joules (bytes over bandwidth at the operating point) do not."""
    ref, got = _run_pair(weights, arch, "lock", True, 80, virtual=False)
    assert got["tokens"] == ref["tokens"]
    assert got["traffic"] == ref["traffic"]
    assert got["decode_stats"]["decode_j"] == ref["decode_stats"]["decode_j"]
    assert [r[1] for r in got["request_j"]] == [r[1] for r in ref["request_j"]]


def _sha(row) -> str:
    return hashlib.sha256(json.dumps(deterministic_fields(row), sort_keys=True)
                          .encode()).hexdigest()


def _trace_pair(arch, n=20):
    """(reference trace, port trace, tbt_s, ttft_s) of ``serve_trace``'s
    recipe at ``n`` requests, against the reduced config."""
    tbt_s, ttft_s, rate = j_serve_trace.slo_targets(j_serve_trace.h200_model(),
                                                    jax_get_config(arch))
    jtrace = j_serve_trace.generate_trace(
        jax_reduced_config(arch), n, arrival="poisson", lengths="short_chat",
        rate_rps=rate, seed=j_serve_trace.TRACE_SEED, max_total_len=j_serve_trace.MAX_SEQ_LEN)
    return jtrace, t_serve_trace.make_trace(arch, n, rate), tbt_s, ttft_s


@pytest.mark.parametrize("mode", ["lock", "slo"])
@pytest.mark.parametrize("arch", ARCHS)
def test_trace_replay_matches_reference(weights, arch, mode):
    """``serve_trace``'s replay (20 requests) through ``Cluster.from_spec``
    on one shared ``VirtualClock``, on the default engine of both sides
    (the event engine): every field equal and the same sha256."""
    _, jp, _, tp = weights[arch]
    jtrace, trace, tbt_s, ttft_s = _trace_pair(arch)
    got, _, cluster = t_serve_trace.replay(arch, mode, trace, tbt_s, ttft_s, params=tp,
                                           device="cpu")
    ref, _ = j_serve_trace.replay(arch, mode, jtrace, tbt_s, ttft_s)
    assert got["completed"] == 20
    assert cluster._fleet.last_engine_stats.decode_steps == cluster.decode_stats.decode_steps
    assert got == ref
    assert _sha(got) == _sha(ref)


def _replay_fields(cluster, done):
    """What ``serve_trace``'s metrics are read from: streams and ledger
    stamps by arrival, both phases' stats, measured joules, transitions."""
    done = sorted(done, key=lambda r: r.ledger.arrival_s)
    return {
        "outputs": [list(r.output) for r in done],
        "stamps": [[r.ledger.arrival_s, r.ledger.admitted_s, r.ledger.first_token_s,
                    list(r.ledger.token_s), r.ledger.finish_s] for r in done],
        "decode": dataclasses.asdict(cluster.decode_stats),
        "prefill": dataclasses.asdict(cluster.prefill_stats),
        "measured": cluster.measured_energy_j(),
        "transitions": len(cluster.controller.transitions),
    }


@pytest.mark.parametrize("mode", ["lock", "slo"])
@pytest.mark.parametrize("arch", ARCHS)
def test_trace_replay_barrier_matches_reference(weights, arch, mode):
    """``serve_trace``'s replay (20 requests) on the barrier engine, the
    port's ``Cluster`` and the reference's built from the recipe's spec:
    every stream, stamp, phase stat, measured joule and transition equal.
    The port's barrier replay equals its event replay in all of them but
    the measured joules, which agree to 1e-12 relative (the reference's two
    engines part in the last bits there: ``ROADMAP.md`` section 3)."""
    _, jp, _, tp = weights[arch]
    jtrace, trace, tbt_s, ttft_s = _trace_pair(arch)
    fields = {}
    for engine in ("barrier", "events"):
        cluster = Cluster.from_spec(
            t_serve_trace.replica_spec(arch, mode, tbt_s, ttft_s),
            emodel=t_serve_trace.h200_model(), params=tp, clock=VirtualClock(),
            device="cpu")
        fields[engine] = _replay_fields(cluster, cluster.run_trace(trace, engine=engine))
    cluster = JCluster.from_spec(
        j_serve_trace.replica_spec(arch, mode, tbt_s, ttft_s),
        emodel=j_serve_trace.h200_model(), params=jp, clock=JVirtualClock())
    ref = _replay_fields(cluster, cluster.run_trace(jtrace, engine="barrier"))
    assert len(ref["outputs"]) == 20
    assert fields["barrier"] == ref
    events = fields["events"]
    assert ({k: v for k, v in fields["barrier"].items() if k != "measured"}
            == {k: v for k, v in events.items() if k != "measured"})
    for k, v in fields["barrier"]["measured"].items():
        assert v == pytest.approx(events["measured"][k], rel=1e-12)


# ------------------------------------------- tests/test_cluster.py, on the port
@pytest.fixture(scope="module")
def setup(weights):
    _, _, cfg, tp = weights["minicpm-2b"]
    return cfg, tp


def _controller(mode="lock"):
    return ClockController(EnergyModel(H200_SXM), get_config("minicpm-2b"), mode=mode)


def _cluster(setup, **kw):
    cfg, tp = setup
    kw.setdefault("max_seq_len", 64)
    return Cluster(cfg, tp, device="cpu", **kw)


def test_cluster_matches_engine_greedy_outputs(setup):
    cfg, tp = setup
    prompts = make_prompts(cfg, 5, 4, 12, seed=1)
    eng = ServingEngine(cfg, tp, max_batch=2, max_seq_len=64, device="cpu")
    ereqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    eng.run_to_completion()
    cl = _cluster(setup, controller=_controller(), decode_batch=2, prefill_chunk_tokens=64)
    creqs = [cl.submit(p, max_new_tokens=6) for p in prompts]
    cl.run_to_completion()
    assert all(r.done for r in creqs)
    assert [r.output for r in creqs] == [r.output for r in ereqs]


def test_token_and_energy_totals_equal_per_request_sums(setup):
    cfg, _ = setup
    prompts = make_prompts(cfg, 6, 4, 14, seed=3)
    cl = _cluster(setup, controller=_controller(), decode_batch=3, prefill_chunk_tokens=64)
    reqs = [cl.submit(p, max_new_tokens=5) for p in prompts]
    cl.run_to_completion()
    assert cl.stats.prefill_tokens == sum(len(p) for p in prompts)
    assert cl.stats.prefill_calls == len(prompts)
    assert cl.stats.decode_tokens == sum(len(r.output) - 1 for r in reqs)
    assert cl.prefill_stats.decode_steps == 0
    assert cl.decode_stats.prefill_calls == 0
    np.testing.assert_allclose(cl.stats.prefill_j, sum(r.prefill_j for r in reqs), rtol=1e-9)
    np.testing.assert_allclose(cl.stats.decode_j, sum(r.decode_j for r in reqs), rtol=1e-9)
    assert cl.stats.energy_j > 0


def test_per_pool_clock_disaggregation(setup):
    cfg, _ = setup
    ctl = _controller("lock")
    cl = _cluster(setup, controller=ctl, decode_batch=2, prefill_chunk_tokens=64)
    for p in make_prompts(cfg, 3, 4, 10, seed=5):
        cl.submit(p, max_new_tokens=4)
    cl.run_to_completion()
    pre, dec = cl.prefill_stats, cl.decode_stats
    assert pre.actual_clock_mhz == ctl.row.prefill_clock
    assert dec.actual_clock_mhz < pre.actual_clock_mhz
    assert pre.clock_gap_mhz == 0.0 and dec.clock_gap_mhz == 0.0


def test_chunked_admission_spreads_prefill(setup):
    cfg, _ = setup
    cl = _cluster(setup, decode_batch=3, prefill_chunk_tokens=4)
    for p in make_prompts(cfg, 3, 10, 12, seed=6):
        cl.submit(p, max_new_tokens=3)
    assert cl.scheduler.tick(cl.waiting, cl.prefill_pool, cl.decode_pool) == []
    done = cl.run_to_completion()
    assert len(done) == 3 and cl.scheduler.migrations == 3


def test_oversized_request_rejected(setup):
    cl = _cluster(setup, decode_batch=1, max_seq_len=32, prefill_chunk_tokens=64)
    cl.submit(np.arange(1, 30, dtype=np.int32), max_new_tokens=10)
    ok = cl.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=3)
    with pytest.raises(ValueError, match="exceeds engine max_seq_len"):
        cl.step()
    done = cl.run_to_completion()
    assert [r.uid for r in done] == [ok.uid] and ok.done


def test_prefill_pool_never_allocates_decode_slots(setup):
    cfg, _ = setup
    cl = _cluster(setup, decode_batch=2, prefill_chunk_tokens=64)
    for p in make_prompts(cfg, 3, 4, 10, seed=10):
        cl.submit(p, max_new_tokens=3)
    cl.run_to_completion()
    assert cl.prefill_pool.cache is None
    assert cl.decode_pool.cache is not None


def test_submit_plumbs_temperature_and_eos(setup):
    cfg, _ = setup
    cl = _cluster(setup, decode_batch=2, prefill_chunk_tokens=64)
    prompt = make_prompts(cfg, 1, 4, 10, seed=31)[0]
    req = cl.submit(prompt, max_new_tokens=4, temperature=0.7, eos_token_id=-1)
    assert req.temperature == 0.7 and req.eos_token_id == -1
    done = cl.run_to_completion()
    assert done and len(req.output) == 4
    assert all(0 <= t < cfg.vocab_size for t in req.output)


def test_sampled_neighbour_leaves_greedy_slots_untouched(setup):
    cfg, _ = setup
    prompts = make_prompts(cfg, 3, 4, 10, seed=32)
    runs = []
    for temps in ((0.0, 0.0, 0.0), (0.0, 1.0, 0.0)):
        cl = _cluster(setup, decode_batch=3, prefill_chunk_tokens=64)
        reqs = [cl.submit(p, max_new_tokens=5, temperature=t) for p, t in zip(prompts, temps)]
        cl.run_to_completion()
        runs.append([r.output for r in reqs])
    assert runs[0][0] == runs[1][0] and runs[0][2] == runs[1][2]


def test_measured_energy_accumulates_across_runs(setup):
    cfg, _ = setup
    cl = _cluster(setup, controller=_controller(), decode_batch=2, prefill_chunk_tokens=64,
                  meter_interval_s=0.005, clock=VirtualClock())
    cl.submit(make_prompts(cfg, 1, 4, 10, seed=20)[0], max_new_tokens=6)
    cl.run_to_completion()
    first = cl.measured_energy_j()["decode"]
    cl.submit(make_prompts(cfg, 1, 4, 10, seed=21)[0], max_new_tokens=6)
    cl.run_to_completion()
    assert 0 < first < cl.measured_energy_j()["decode"]
    assert cl.decode_pool.gauge() == pytest.approx(H200_SXM.p_idle)


# ------------------------------------------------------ freelist and hooks
def test_barrier_replay_hands_out_fresh_requests(setup):
    """Only a streaming consumer releases requests; the barrier engine never
    does, so within a replay no request object serves twice. A request
    released before the replay is handed out blank and serves like a new
    one: the replay equals one made with an empty freelist."""
    _, tp = setup
    recycled = tpool.acquire_request(99, np.arange(1, 5, dtype=np.int32), bucket="long")
    recycled.output = [7, 7]
    recycled.ledger.mark_arrival(1.0)
    tpool.release_request(recycled)
    assert recycled.output == [] and recycled.ledger.arrival_s is None
    again = tpool.acquire_request(3, np.arange(1, 3, dtype=np.int32))
    assert again is recycled and again.uid == 3 and again.bucket == "mixed"
    assert not tpool._REQUEST_FREELIST

    def replay():
        cl = Cluster.from_spec(
            t_serve_trace.replica_spec("minicpm-2b", "lock", 1.0, 10.0), params=tp,
            clock=VirtualClock(), device="cpu")
        done = cl.run_trace(t_serve_trace.make_trace("minicpm-2b", 4, 50.0), engine="barrier")
        done.sort(key=lambda r: r.uid)
        return done, [(r.uid, r.output, _stamps(r), r.decode_j) for r in done]

    tpool.release_request(again)
    done, got = replay()
    assert recycled in done and not tpool._REQUEST_FREELIST
    assert len({id(r) for r in done}) == len(done) == 4
    assert got == replay()[1]


def test_scheduler_tick_hooks(setup):
    """The event engine's ``admit`` / ``gate`` / ``accrue`` hooks: the
    defaults are the barrier's handoff; a closed gate admits nothing and
    banks no credit; ``accrue=False`` spends credit without banking more;
    ``admit`` replaces the prefill-and-place handoff."""
    cfg, _ = setup
    prompts = make_prompts(cfg, 3, 4, 10, seed=40)

    def fresh():
        cl = _cluster(setup, decode_batch=3, prefill_chunk_tokens=64)
        for p in prompts:
            cl.submit(p, max_new_tokens=3)
        return cl

    cl = fresh()
    sch = cl.scheduler
    assert sch.tick(cl.waiting, cl.prefill_pool, cl.decode_pool,
                    gate=lambda r: False) == []
    assert sch._credit == 0.0 and len(cl.waiting) == 3
    assert sch.tick(cl.waiting, cl.prefill_pool, cl.decode_pool, accrue=False) == []
    taken = []
    admitted = sch.tick(cl.waiting, cl.prefill_pool, cl.decode_pool, admit=taken.append)
    assert admitted == taken and len(taken) == 3 and not cl.waiting
    assert cl.decode_pool.occupancy() == 0 and sch.migrations == 3

    cl = fresh()
    default = cl.scheduler.tick(cl.waiting, cl.prefill_pool, cl.decode_pool)
    assert [r.uid for r in default] == [0, 1, 2]
    assert cl.decode_pool.occupancy() == 3 and all(len(r.output) == 1 for r in default)
