"""The port's ``serve_scale`` replay in tuple mode (``batch_replicas``
off: each member's own step, K batch-1 prefills) against the JAX
package's, on the recipe's 300-request cut (``aligned_trace(200)`` then
``drifted_trace(100)``, the 100-replica fleet, quantum 0.5 ms): the same
sha256 as the reference's (equal to its batched mode's,
``tests/test_torch_scale.py``) and ``EngineStats`` equal key for key.
Reduced configs on the CPU, the reference recipe's own weights
(``PRNGKey(0)``) carried across through numpy. Bitwise: the tuple
dispatch runs the same computations as serial steps.
"""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro_torch.models as T
from repro_torch.benchmarks import serve_scale as t_scale
from repro_torch.configs import reduced_config

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
import benchmarks.serve_scale as j_scale  # noqa: E402

CUT_SHA = "7ce14a8dc31b3b4d"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The reduced models' ops are tiny: intra-op threads only spin on them
    and take cores from the other workers of a parallel test run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_scale_cut_tuple_matches_reference():
    weights = {a: T.params_from_numpy(jax.tree.map(np.asarray, p), reduced_config(a),
                                      device="cpu")
               for a, p in j_scale.params_for().items()}
    traces = []
    for m in (j_scale, t_scale):
        a, _ = m.aligned_trace(200)
        traces.append(a + m.drifted_trace(100, t0=(len(a) // m.N_REPLICAS + 2) * m.WAVE_DT_S))
    ref, ref_sha, _ = j_scale.replay(traces[0], fusion_quantum_s=j_scale.QUANTUM_S,
                                     batch_replicas=False)
    got, sha, _, fleet = t_scale.replay(traces[1], weights, device="cpu",
                                        fusion_quantum_s=t_scale.QUANTUM_S,
                                        batch_replicas=False)
    assert sha == ref_sha and sha.startswith(CUT_SHA)
    for m in (ref, got):
        m["engine_stats"].pop("fused_decode_wall")
    assert got == ref
    st = got["engine_stats"]
    assert (st["batched_decode_calls"], st["batched_prefill_calls"], st["bank_gathers"],
            st["bank_rebuilds"], st["fused_traces"], st["pool_jit_dispatches"]) == (
        0, 0, 0, 0, 9, 300)
    assert fleet.last_batched_calls == {}
