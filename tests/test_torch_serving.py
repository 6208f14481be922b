"""Greedy serving replays: the port's ``ServingEngine`` against the JAX one.

Reduced gemma-2b, reduced minitron-4b (squared-ReLU GQA, the MLA
ablation's control), reduced minitron-4b-mla (absorbed MLA, latent cache)
and the reduced recurrent models mamba2-4b (Mamba2 SSD) and gdn-4b (Gated
DeltaNet), weights from ``repro.models.init_params`` through numpy,
the same ``make_prompts`` set, dense and paged (with a block budget tight
enough to force preemption). Token streams, ``PhaseStats`` token, step,
byte and (under a lock-mode ``ClockController``) joule counts, preemptions,
``TrafficCounter`` totals and the pool's dispatch count (prefills, places
and decode steps) must all be equal; on a virtual clock, so must every
latency stamp and the sampler's measured joules. On the CPU the pool calls
its decode-step function directly over its static buffers (no graph).
``run_serving``'s analytic fields must equal the JAX driver's at
``chip="h200-sxm"``. Sampling at temperature > 0 draws from a
``torch.Generator`` (other bits than ``jax.random``), so it is checked for
determinism per seed, not against the reference.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.models as R
from repro.configs import reduced_config as jax_reduced_config
from repro.core.clock import VirtualClock as JVirtualClock
from repro.core.energy import EnergyModel as JEnergyModel
from repro.hw import H200_SXM as J_H200
from repro.launch.serve import run_serving as jax_run_serving
from repro.serving import ClockController as JController
from repro.serving import ServingEngine as JEngine
from repro.training import make_prompts
import repro_torch.models as T
from repro_torch.configs import reduced_config
from repro_torch.core.clock import VirtualClock as TVirtualClock
from repro_torch.core.energy import EnergyModel as TEnergyModel
from repro_torch.hw import H200_SXM as T_H200
from repro_torch.launch.serve import run_serving
from repro_torch.serving import ClockController as TController
from repro_torch.serving import ServingEngine as TEngine

ANALYTIC = ("decode_power_w", "decode_mj_per_tok", "prefill_mj_per_tok",
            "recommended_decode_clock_mhz", "lever")


def _weights(arch):
    jcfg = jax_reduced_config(arch)
    jp = R.init_params(jcfg, jax.random.PRNGKey(0))
    cfg = reduced_config(arch)
    tp = T.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


@pytest.fixture(scope="module")
def weights():
    return _weights("gemma-2b")


@pytest.fixture(scope="module")
def ctrl_weights():
    return _weights("minitron-4b")


@pytest.fixture(scope="module")
def mla_weights():
    return _weights("minitron-4b-mla")


@pytest.fixture(scope="module", params=["mamba2-4b", "gdn-4b"])
def recurrent_weights(request):
    return _weights(request.param)


def _replay(engine_cls, controller, cfg, params, prompts, **kw):
    engine = engine_cls(cfg, params, max_batch=3, max_seq_len=128, controller=controller, **kw)
    reqs = [engine.submit(p, max_new_tokens=20) for p in prompts]
    done = engine.run_to_completion()
    st = engine.stats
    traffic = dataclasses.asdict(engine.pool.traffic)
    return {
        "finished": sorted(r.uid for r in done),
        "tokens": [r.output for r in reqs],
        "preemptions": [r.preemptions for r in reqs],
        "request_bytes": [(r.decode_read_bytes, r.decode_write_bytes) for r in reqs],
        "stats": (st.prefill_tokens, st.prefill_calls, st.decode_tokens, st.decode_steps,
                  st.decode_read_bytes, st.decode_write_bytes),
        "joules": (st.prefill_j, st.decode_j),
        "clock": (st.configured_clock_mhz, st.actual_clock_mhz, st.lever_engaged),
        "traffic": traffic,
        "dispatches": engine.pool.jit_dispatches,
    }


@pytest.mark.parametrize("paged,kv_blocks,metered", [
    (False, None, False),
    (True, None, True),
    (True, 9, False),          # 9 blocks of 16 for 3 slots: forces preemption
])
def test_engine_replay_matches_reference(weights, paged, kv_blocks, metered):
    _check_replay(weights, paged, kv_blocks, metered)


@pytest.mark.parametrize("paged,kv_blocks,metered", [
    (False, None, True),
    (True, None, True),
    (True, 9, True),           # 9 blocks of 16 for 3 slots: forces preemption
])
def test_ctrl_engine_replay_matches_reference(ctrl_weights, paged, kv_blocks, metered):
    """minitron-4b: squared-ReLU MLP and an untied table, through the same
    GQA decode kernels as gemma-2b."""
    _check_replay(ctrl_weights, paged, kv_blocks, metered)


@pytest.mark.parametrize("paged,kv_blocks,metered", [
    (False, None, True),
    (True, None, True),
    (True, 9, True),           # 9 blocks of 16 for 3 slots: forces preemption
])
def test_mla_engine_replay_matches_reference(mla_weights, paged, kv_blocks, metered):
    _check_replay(mla_weights, paged, kv_blocks, metered)


@pytest.mark.parametrize("paged,kv_blocks,metered", [
    (False, None, True),
    (True, None, True),
    (True, 9, True),           # 9 blocks of 16 for 3 slots: forces preemption
])
def test_recurrent_engine_replay_matches_reference(recurrent_weights, paged, kv_blocks,
                                                   metered):
    """O(1)-state models: the state rides in its slot (dense and paged),
    paged admission still gates on token blocks, and the prompt's bucket
    padding runs through the recurrence as in the reference, so the streams
    after the first token match the reference's only if the port pads alike."""
    _check_replay(recurrent_weights, paged, kv_blocks, metered)


def _check_replay(weights, paged, kv_blocks, metered):
    jcfg, jp, cfg, tp = weights
    prompts = make_prompts(jcfg, 6, 5, 40, seed=1)
    kw = dict(paged=paged, kv_block_size=16, kv_blocks=kv_blocks)
    jctl = JController(JEnergyModel(J_H200), jcfg, mode="lock") if metered else None
    tctl = TController(TEnergyModel(T_H200), cfg, mode="lock") if metered else None
    ref = _replay(JEngine, jctl, jcfg, jp, prompts, **kw)
    got = _replay(TEngine, tctl, cfg, tp, prompts, device="cpu", **kw)
    assert got == ref
    assert len(ref["finished"]) == len(prompts)
    if kv_blocks is not None:
        assert sum(ref["preemptions"]) > 0
    if metered:
        assert ref["joules"][1] > 0


@pytest.mark.parametrize("paged", [False, True])
def test_virtual_clock_replay_matches_reference(weights, paged):
    """On a virtual clock every stamp is modelled time, so latency ledgers
    and the sampler's measured joules must match the reference exactly."""
    jcfg, jp, cfg, tp = weights
    prompts = make_prompts(jcfg, 5, 5, 40, seed=4)
    runs = []
    for engine_cls, ctl_cls, model_cls, chip, clock_cls, c, p, kw in (
            (JEngine, JController, JEnergyModel, J_H200, JVirtualClock, jcfg, jp, {}),
            (TEngine, TController, TEnergyModel, T_H200, TVirtualClock, cfg, tp,
             {"device": "cpu"})):
        engine = engine_cls(c, p, max_batch=3, max_seq_len=128, paged=paged,
                            clock=clock_cls(), controller=ctl_cls(model_cls(chip), c,
                                                                  mode="lock"), **kw)
        reqs = [engine.submit(x, max_new_tokens=10) for x in prompts]
        engine.pool.start_metering()
        engine.run_to_completion()
        measured = engine.pool.stop_metering()
        runs.append(([r.output for r in reqs], measured, engine.clock(),
                     [(r.ledger.ttft_s, r.ledger.e2e_s, r.ledger.tbt_s) for r in reqs]))
    assert runs[1] == runs[0]
    assert runs[0][1] > 0


def test_temperature_sampling_is_seeded(weights):
    _, _, cfg, tp = weights
    prompts = make_prompts(cfg, 4, 5, 20, seed=3)

    def run(seed, temperature):
        e = TEngine(cfg, tp, max_batch=2, max_seq_len=64, rng_seed=seed, device="cpu")
        reqs = [e.submit(p, max_new_tokens=8, temperature=temperature) for p in prompts]
        e.run_to_completion()
        return [r.output for r in reqs]

    hot = run(0, 5.0)
    assert hot == run(0, 5.0)
    assert hot != run(1, 5.0)
    assert all(0 <= t < cfg.vocab_size for out in hot for t in out)
    assert run(0, 0.0) == run(1, 0.0)          # greedy ignores the seed


def test_prefix_sharing_is_refused(weights):
    """As in the reference: prefix sharing needs the paged cache."""
    jcfg, jp, cfg, tp = weights
    with pytest.raises(ValueError, match="requires paged=True") as ref:
        JEngine(jcfg, jp, prefix_sharing=True)
    with pytest.raises(ValueError, match="requires paged=True") as got:
        TEngine(cfg, tp, prefix_sharing=True, device="cpu")
    assert str(got.value) == str(ref.value)


def test_engine_defaults_to_cuda(weights):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    _, _, cfg, tp = weights
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine(cfg, tp)


def test_defrag_keeps_paged_decode_invariant(weights):
    """Compacting pages mid-run leaves the token streams unchanged."""
    _, _, cfg, tp = weights
    prompts = make_prompts(cfg, 5, 5, 40, seed=2)

    def run(defrag_at):
        e = TEngine(cfg, tp, max_batch=3, max_seq_len=128, paged=True, device="cpu")
        reqs = [e.submit(p, max_new_tokens=12) for p in prompts]
        step = 0
        while e.waiting or e.pool.occupancy():
            e.step()
            step += 1
            if step == defrag_at:
                e.pool.defrag()
                e.pool.allocator.assert_invariants()
        return [r.output for r in reqs]

    assert run(defrag_at=6) == run(defrag_at=-1)


def test_defrag_moves_pages_in_place(weights):
    """``defrag`` keeps every cache leaf's storage (a captured decode graph
    reads those addresses) and still moves the pages: the streams equal
    the run without defrag, and the live pages did move."""
    _, _, cfg, tp = weights
    prompts = make_prompts(cfg, 5, 5, 40, seed=2)

    def run(defrag_at):
        e = TEngine(cfg, tp, max_batch=3, max_seq_len=128, paged=True, device="cpu")
        reqs = [e.submit(p, max_new_tokens=12) for p in prompts]
        step, moved = 0, None
        while e.waiting or e.pool.occupancy():
            e.step()
            step += 1
            if step == defrag_at:
                leaves = [blk[key] for blk, key, _ in _pool_leaves(e.pool)]
                ptrs = [t.data_ptr() for t in leaves]
                tables = e.pool.block_tables.copy()
                e.pool.defrag()
                assert [t.data_ptr() for t in leaves] == ptrs
                assert all(a is blk[key] for a, (blk, key, _) in zip(leaves, _pool_leaves(e.pool)))
                moved = not np.array_equal(tables, e.pool.block_tables)
        return [r.output for r in reqs], moved

    got, moved = run(defrag_at=14)      # two live slots, holes below their pages
    assert moved
    assert got == run(defrag_at=-1)[0]


def _pool_leaves(pool):
    from repro_torch.serving.pool import _leaves
    return list(_leaves(pool.cache, pool._layout))


def test_run_serving_analytic_fields_match_reference():
    _check_run_serving("gemma-2b")


def test_mla_run_serving_analytic_fields_match_reference():
    _check_run_serving("minitron-4b-mla")


def _check_run_serving(arch):
    kw = dict(arch=arch, n_requests=2, max_new=4, max_batch=2)
    ref = jax_run_serving(chip="h200-sxm", **kw)
    got = run_serving(device="cpu", **kw)
    assert {k: got[k] for k in ANALYTIC} == {k: ref[k] for k in ANALYTIC}
    assert got["completed"] == ref["completed"] == 2
    assert got["prefill_tokens"] == ref["prefill_tokens"]


@pytest.mark.parametrize("arch", ["mamba2-4b", "gdn-4b"])
def test_recurrent_run_serving_analytic_fields_match_reference(arch):
    _check_run_serving(arch)
