"""The port's ``serve_fleet`` and ``serve_autoscale`` recipes against the
reference's ``benchmarks/serve_fleet.py`` and ``benchmarks/serve_autoscale.py``.

Reduced configs on the CPU, weights from ``repro.models.init_params``
(``jax.random.PRNGKey(0)``, the reference recipes' own) carried across
through numpy. Each recipe's smoke run holds every claim and yields the
reference's rows; one replay of each (``het/energy/slo`` and ``schedule``)
equals a live reference replay on the event engine in every deterministic
field, the autoscaler's ``ScaleEvent`` list included. Each replay refuses a
trace whose prompt ids pass a replica's vocabulary (at full width the
three fleet archs' vocabularies differ).
"""
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.models as R
from repro.configs import reduced_config as jax_reduced_config
import repro_torch.models as T
from repro_torch.benchmarks import serve_autoscale as t_autoscale
from repro_torch.benchmarks import serve_fleet as t_fleet
from repro_torch.benchmarks.common import check_vocab, deterministic_fields
from repro_torch.configs import get_config, reduced_config
from repro_torch.core.traces import generate_trace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import benchmarks.serve_autoscale as j_autoscale  # noqa: E402
import benchmarks.serve_fleet as j_fleet  # noqa: E402


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
    """arch -> (reference params, port params) of the reduced config."""
    out = {}
    for arch in t_fleet.HET_ARCHS:
        jp = R.init_params(jax_reduced_config(arch), jax.random.PRNGKey(0))
        out[arch] = (jp, T.params_from_numpy(jax.tree.map(np.asarray, jp),
                                             reduced_config(arch), device="cpu"))
    return out


def _port_params(weights, archs):
    return {a: weights[a][1] for a in archs}


def test_serve_fleet_smoke_holds_every_claim(weights, tmp_path, monkeypatch):
    """The whole smoke recipe: nine replays (six heterogeneous, the GQA
    monoculture, one replica drained, the determinism repeat), each
    reported through ``on_run``; every claim holds (``run`` raises
    otherwise) and the rows are the reference's, name for name."""
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    seen = []
    rows = t_fleet.run(smoke=True, write_json=True, device="cpu",
                       params_for=_port_params(weights, t_fleet.HET_ARCHS),
                       on_run=lambda m, wall, fleet: seen.append(
                           (m["routing"], m["mode"], m["drained"], len(fleet.replicas))))
    want = []
    for mode in j_fleet.MODES:
        want += [f"serve_fleet/het/{r}/{mode}" for r in j_fleet.ROUTERS]
        want.append(f"serve_fleet/energy_vs_jsq/{mode}")
    want += ["serve_fleet/homo-gqa/affinity/lock", "serve_fleet/het_vs_homo",
             "serve_fleet/het/jsq/lock/drain1", "serve_fleet/power_down_vs_underclock",
             "serve_fleet/determinism", "serve_fleet/json"]
    assert [r[0] for r in rows] == want
    assert len(seen) == 9 and seen[-1] == ("energy", "slo", "", 3)
    assert rows[-2] == ("serve_fleet/determinism", 0.0, "byte_identical=True;requests=120")
    blob = json.loads((tmp_path / t_fleet.JSON_PATH).read_text())
    assert blob["bench"] == "serve_fleet" and len(blob["results"]) == 8
    assert not (tmp_path / j_fleet.JSON_PATH).exists()


def test_serve_fleet_replay_matches_reference(weights):
    """``het/energy/slo`` of the smoke recipe, port against a live
    reference replay (its own ``params_for``: ``init_params`` of the reduced
    configs from ``PRNGKey(0)``): every deterministic field equal."""
    tbt_s, ttft_s, rate = j_fleet.fleet_targets(j_fleet.h200_model(), j_fleet.HET_ARCHS)
    assert (tbt_s, ttft_s, rate) == t_fleet.fleet_targets(t_fleet.h200_model(),
                                                          t_fleet.HET_ARCHS)
    ref, _ = j_fleet.replay(j_fleet.HET_ARCHS, "energy", "slo", j_fleet.make_trace(120, rate),
                            tbt_s, ttft_s)
    got, _, fleet = t_fleet.replay(t_fleet.HET_ARCHS, "energy", "slo",
                                   t_fleet.make_trace(120, rate), tbt_s, ttft_s,
                                   params_for=_port_params(weights, t_fleet.HET_ARCHS),
                                   device="cpu")
    assert deterministic_fields(got) == deterministic_fields(ref)
    assert got["completed"] == 120 and fleet.last_engine_stats is not None


def test_serve_autoscale_smoke_holds_every_claim(weights, tmp_path, monkeypatch):
    """The whole smoke recipe: static4, queue, schedule, the valley replay
    and the schedule repeat, each reported through ``on_run``; every claim
    holds (``run`` raises otherwise) and the rows are the reference's."""
    monkeypatch.setenv("REPRO_BENCH_OUT", str(tmp_path))
    monkeypatch.chdir(tmp_path)
    seen = []
    rows = t_autoscale.run(smoke=True, write_json=True, device="cpu",
                           params_for=_port_params(weights, (t_autoscale.ARCH,)),
                           on_run=lambda m, wall, fleet: seen.append((m["mode"], m["requests"])))
    assert [r[0] for r in rows] == [f"serve_autoscale/{k}" for k in (
        "static4", "queue", "schedule", "queue_vs_static", "schedule_vs_static",
        "schedule_vs_queue_ramp", "valley", "determinism", "wall_time", "json")]
    assert seen == [("static", 120), ("queue", 120), ("schedule", 120), ("queue", 30),
                    ("schedule", 120)]
    assert dict((r[0], r[2]) for r in rows)["serve_autoscale/determinism"] == \
        "byte_identical=True;requests=120"
    blob = json.loads((tmp_path / t_autoscale.JSON_PATH).read_text())
    assert sorted(blob["results"]) == ["queue", "schedule", "static4", "valley"]


def test_serve_autoscale_replay_matches_reference(weights):
    """``schedule`` of the smoke recipe, port against a live reference
    replay (no golden file): every deterministic field equal, the
    ``ScaleEvent`` list included, with power-ups and power-downs in it."""
    ja, ta = j_autoscale, t_autoscale
    tbt_s, ttft_s, replica_rps, t_dec = ja.autoscale_targets(ja.h200_model())
    assert (tbt_s, ttft_s, replica_rps, t_dec) == ta.autoscale_targets(ta.h200_model())
    rate = ja.RATE_X * replica_rps
    period_s = 120 / rate / 2.0
    scaler = ja.autoscaler_spec("schedule", t_dec=t_dec, replica_rps=replica_rps,
                                period_s=period_s, tbt_s=tbt_s)
    ref, _ = ja.replay("schedule", ja.make_trace(120, rate, period_s), tbt_s, ttft_s,
                       scaler, period_s)
    tscaler = ta.autoscaler_spec("schedule", t_dec=t_dec, replica_rps=replica_rps,
                                 period_s=period_s, tbt_s=tbt_s)
    got, _, _ = ta.replay("schedule", ta.make_trace(120, rate, period_s), tbt_s, ttft_s,
                          tscaler, period_s, params=weights[ta.ARCH][1], device="cpu")
    assert got["scale_events"] == ref["scale_events"]
    assert got["n_power_ups"] >= 1 and got["n_power_downs"] >= 1
    assert deterministic_fields(got) == deterministic_fields(ref)


def test_full_width_traces_fit_every_vocabulary():
    """At full width qwen3-4b and gdn-4b have 151 936 ids, minitron-4b-mla
    256 000: the recipes' traces are made against qwen3-4b and pass; a
    trace drawn against minitron-4b-mla's vocabulary does not."""
    tbt_s, ttft_s, rate = t_fleet.fleet_targets(t_fleet.h200_model(), t_fleet.HET_ARCHS)
    check_vocab(t_fleet.make_trace(120, rate, full_config=True), t_fleet.HET_ARCHS,
                full_config=True)
    check_vocab(t_autoscale.make_trace(120, 100.0, 0.5, full_config=True),
                (t_autoscale.ARCH,), full_config=True)
    wide = generate_trace(get_config("minitron-4b-mla"), 120, arrival="poisson",
                          lengths="mixed", rate_rps=rate, seed=t_fleet.TRACE_SEED,
                          max_total_len=t_fleet.MAX_SEQ_LEN)
    assert max(int(t.prompt.max()) for t in wide) >= get_config("qwen3-4b").vocab_size
    check_vocab(wide, ("minitron-4b-mla",), full_config=True)
    with pytest.raises(ValueError, match="past qwen3-4b's vocabulary of 151936"):
        check_vocab(wide, t_fleet.HET_ARCHS, full_config=True)


@pytest.mark.parametrize("recipe", ["serve_fleet", "serve_autoscale"])
def test_replay_refuses_ids_past_a_vocabulary(weights, recipe):
    """A reduced trace with one prompt id at the reduced vocabulary (512)
    is refused before any fleet is built."""
    trace = t_fleet.make_trace(4, 40.0)
    trace[2].prompt[0] = reduced_config("qwen3-4b").vocab_size
    with pytest.raises(ValueError, match="past qwen3-4b's vocabulary of 512"):
        if recipe == "serve_fleet":
            t_fleet.replay(t_fleet.HOMO_ARCHS, "jsq", "lock", trace, 0.1, 1.0,
                           params_for={}, device="cpu")
        else:
            t_autoscale.replay("static", trace, 0.1, 1.0, None, 1.0, params=None,
                               device="cpu")
