"""Energy-aware clock controller: the policy table resolved online.

The paper's §6.4 artefact is a static table — one lock per (arch, pool,
regime). This controller closes the loop the deployment recipe (§7.1)
implies: every scheduler tick it observes each pool's batch occupancy and
context-length regime, picks the matching ``PolicyRow`` column, and applies
the lever through ``repro.core.dvfs.resolve`` so the pool's operating point
(power, energy/token, configured-vs-actual clock) is always current.

Two deliberate behaviours:

* The controller requests ``spec.effective_lock(column)`` rather than the
  raw column — it KNOWS about the firmware clamp (§5.2) and never issues a
  request that would be silently rewritten, so configured == actual for
  every lock it places (no "double disguise" inside our own stack).
* Every lever change is recorded as a ``Transition`` — the audit trail the
  paper's Table 1 methodology (configured vs actual) needs at serving time.

Modes mirror the benchmark grid: "default" (governor), "cap" (the industry
reflex; inert for decode), "lock" (the paper's fix), plus "slo" — the
closed loop: the policy table is only the *prior*; each tick the controller
walks the fine DVFS grid down from the table's decode lock while measured
p99 TBT and TTFT hold slack against their targets, and back up on
violation. The walk floors at the regime's min-energy clock (below it both
energy AND latency worsen — there is nothing to gain), and every move lands
in the same ``Transition`` audit trail as the static modes. Prefill pools
keep the table's prefill lock in slo mode: prefill genuinely needs the
high clock, and TTFT is regulated through admission, not by starving it.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Mapping, Optional, Sequence

from repro_torch.core.dvfs import ClockLock, Default, Lever, OperatingPoint, PowerCap, resolve
from repro_torch.core.energy import EnergyModel
from repro_torch.core.latency import percentile
from repro_torch.core.policy import PolicyRow, min_energy_clock, policy_row
from repro_torch.core.workload import decode_workload, prefill_workload
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Transition:
    """One lever change on one pool (the controller's audit trail).

    Fleet scale events land in the same trail (``note_scale_event``): a
    ``power_up``/``drain``/``power_down``/``warm``/``park`` lever with
    ``pool="replica"`` — so the joules a warm-up burns are auditable next
    to the DVFS moves that priced every other interval."""
    step: int
    pool: str
    regime: str
    lever: str                    # "lock" | "cap" | "default" | a scale action
    configured: float             # MHz for locks, W for caps, warm-up s for
                                  # power_up scale events
    actual_clock_mhz: float
    engaged: bool


class ClockController:
    """Per-pool lever selection from batch occupancy + context regime."""

    def __init__(
        self,
        emodel: EnergyModel,
        arch_cfg: ModelConfig,
        *,
        mode: str = "lock",                  # "lock" | "cap" | "default" | "slo"
        budget: float = 0.01,
        context: int = 1024,
        long_context: int = 16384,
        batch_hi_threshold: int = 8,         # occupancy at/above which the
                                             # pool maps to the BS=32 column
        prefill_seq: int = 4096,
        cap_w: Optional[float] = None,
        fused: bool = False,
        context_scale: float = 1.0,          # each live trace token stands
                                             # for this many production
                                             # tokens when pricing workloads
                                             # (miniature-trace replays)
        # ---- slo mode: p99 targets + walk dynamics -----------------------
        slo_ttft_s: float = 2.0,
        slo_tbt_s: float = 0.25,
        slo_slack: float = 0.9,              # descend only below this
                                             # fraction of the target
        slo_percentile: float = 99.0,
        slo_window: int = 512,               # observation deque length
        slo_min_obs: int = 48,               # fresh TBT samples per move
        slo_step_mhz: float = 60.0,          # walk granularity on the grid
    ):
        if mode not in ("lock", "cap", "default", "slo"):
            raise ValueError(f"unknown controller mode {mode!r}")
        self.emodel = emodel
        self.arch_cfg = arch_cfg
        self.mode = mode
        self.budget = budget
        self.context = context
        self.long_context = long_context
        self.batch_hi_threshold = batch_hi_threshold
        self.prefill_seq = prefill_seq
        self.cap_w = cap_w if cap_w is not None else min(emodel.spec.power_cap_levels)
        self.fused = fused
        if context_scale <= 0:
            raise ValueError("context_scale must be > 0")
        self.context_scale = context_scale
        self.slo_ttft_s = slo_ttft_s
        self.slo_tbt_s = slo_tbt_s
        self.slo_slack = slo_slack
        self.slo_percentile = slo_percentile
        self.slo_min_obs = slo_min_obs
        self.slo_step_mhz = slo_step_mhz
        # observation deques are PER REGIME (like the walk index): a regime
        # oscillation across the batch threshold must not wipe the other
        # regime's evidence, or the walk starves and never adapts
        self._ttft_obs: Dict[str, Deque[float]] = {}
        self._tbt_obs: Dict[str, Deque[float]] = {}
        self.slo_window = slo_window
        self._slo_grid_cache: Optional[List[float]] = None
        self._slo_idx: Dict[str, int] = {}   # per-regime walk state
        self._slo_regime: Optional[str] = None
        self._slo_floors: Dict[str, float] = {}
        self.transitions: List[Transition] = []
        self._row: Optional[PolicyRow] = None
        self._last: Dict[str, Lever] = {}    # pool name -> last applied lever

    # ------------------------------------------------------------ policy row
    @property
    def row(self) -> PolicyRow:
        """The arch's policy-table row, resolved once and cached."""
        if self._row is None:
            self._row = policy_row(
                self.emodel, self.arch_cfg.name, self.arch_cfg,
                budget=self.budget, context=self.context,
                long_context=self.long_context,
            )
        return self._row

    # -------------------------------------------------------------- regimes
    def regime_for(self, role: str, occupancy: int, mean_context: float) -> str:
        """Map live pool state to a policy-table column."""
        if role == "prefill":
            return "prefill"
        if mean_context >= self.long_context and occupancy >= self.batch_hi_threshold:
            return "bs32_long"
        if occupancy >= self.batch_hi_threshold:
            return "bs32"
        return "bs1"

    def lever_for(self, regime: str) -> Lever:
        if self.mode == "default":
            return Default()
        if self.mode == "cap":
            return PowerCap(self.cap_w)
        if self.mode == "slo" and regime != "prefill":
            return ClockLock(self.slo_clock_mhz(regime))
        # lock: request the clock the firmware will actually deliver — the
        # controller never issues a request above the clamp.
        requested = self.emodel.spec.effective_lock(self.row.clock_for(regime))
        return ClockLock(requested)

    # ------------------------------------------------------------- slo loop
    def _obs(self, store: Dict[str, Deque[float]], regime: str) -> Deque[float]:
        if regime not in store:
            store[regime] = deque(maxlen=self.slo_window)
        return store[regime]

    def observe(self, *, ttft_s: Sequence[float] = (),
                tbt_s: Sequence[float] = ()):
        """Feed measured request latencies (the cluster calls this every
        step); they are attributed to the regime the last tick resolved.
        Any mode accepts them; only ``mode="slo"`` acts on them."""
        regime = self._slo_regime or "bs1"
        self._obs(self._ttft_obs, regime).extend(float(x) for x in ttft_s)
        self._obs(self._tbt_obs, regime).extend(float(x) for x in tbt_s)

    def _slo_grid(self) -> List[float]:
        """Ascending, deduped ladder of deliverable locks (clamp applied).
        The policy table's decode clocks are grid members, so each regime's
        walk warm-starts at EXACTLY the lock mode's clock — the invariant
        behind "slo never spends more than lock while both meet the SLO"."""
        if self._slo_grid_cache is None:
            spec = self.emodel.spec
            vals = {spec.effective_lock(f)
                    for f in self.emodel.clock_grid(self.slo_step_mhz)}
            vals |= {spec.effective_lock(self.row.clock_for(r))
                     for r in ("bs1", "bs32", "bs32_long")}
            self._slo_grid_cache = sorted(vals)
        return self._slo_grid_cache

    def _slo_floor_mhz(self, regime: str) -> float:
        """The regime's min-energy clock: walking below it costs BOTH
        energy and latency, so the descent stops there."""
        if regime not in self._slo_floors:
            ctx = self.long_context if regime == "bs32_long" else self.context
            bs = 1 if regime == "bs1" else 32
            w = decode_workload(self.arch_cfg, bs, int(ctx), fused=self.fused)
            choice = min_energy_clock(self.emodel, w, clocks=self._slo_grid())
            self._slo_floors[regime] = choice.clock_mhz
        return self._slo_floors[regime]

    def slo_clock_mhz(self, regime: str) -> float:
        """The decode lock slo mode currently holds for ``regime``. The walk
        state is per regime, each warm-started at exactly the policy
        table's lock for that regime — the static table is the prior, the
        measured-latency walk only ever refines it downward (descent) or
        trades energy for a met SLO (ascent on violation)."""
        grid = self._slo_grid()
        if regime not in self._slo_idx:
            prior = self.emodel.spec.effective_lock(self.row.clock_for(regime))
            self._slo_idx[regime] = grid.index(prior)
        return grid[self._slo_idx[regime]]

    def _slo_update(self, regime: str):
        """One walk step for the live regime: up immediately on a p99
        violation, down one notch when p99 holds ``slo_slack`` headroom AND
        the regime's floor allows it. The regime's own observations clear
        on every move — latencies measured at the old clock say nothing
        about the new one; other regimes' evidence is untouched."""
        grid = self._slo_grid()
        self.slo_clock_mhz(regime)               # ensure warm-started index
        self._slo_regime = regime                # attribution for observe()
        tbt_obs = self._obs(self._tbt_obs, regime)
        ttft_obs = self._obs(self._ttft_obs, regime)
        if len(tbt_obs) < self.slo_min_obs:
            return
        p_tbt = percentile(list(tbt_obs), self.slo_percentile)
        p_ttft = (percentile(list(ttft_obs), self.slo_percentile)
                  if ttft_obs else 0.0)
        idx = self._slo_idx[regime]
        if p_tbt > self.slo_tbt_s or p_ttft > self.slo_ttft_s:
            if idx < len(grid) - 1:
                self._slo_idx[regime] = idx + 1
                ttft_obs.clear()
                tbt_obs.clear()
        elif (p_tbt <= self.slo_slack * self.slo_tbt_s
              and p_ttft <= self.slo_slack * self.slo_ttft_s
              and idx > 0
              and grid[idx - 1] >= self._slo_floor_mhz(regime) - 1e-9):
            self._slo_idx[regime] = idx - 1
            ttft_obs.clear()
            tbt_obs.clear()

    def note_scale_event(self, step: int, action: str, *,
                         configured: float = 0.0):
        """Record a fleet scale decision on this replica as a
        ``Transition`` (lever = the scale action, ``configured`` = the
        modelled warm-up seconds for a ``power_up``). Keeps the energy
        audit trail complete: warm-up joules are attributed to an explicit
        lever move, not silently folded into idle time."""
        self.transitions.append(Transition(
            step=step, pool="replica", regime="fleet", lever=action,
            configured=float(configured), actual_clock_mhz=0.0, engaged=True,
        ))

    def decode_lock_mhz(self, occupancy: int, mean_context: Optional[float] = None) -> float:
        """The lock (MHz) a decode pool at this occupancy would receive.

        Pure probe used by tests/benchmarks — no pool state is touched.
        """
        ctx = self.context if mean_context is None else mean_context * self.context_scale
        regime = self.regime_for("decode", occupancy, ctx)
        return self.emodel.spec.effective_lock(self.row.clock_for(regime))

    def request_energy_mj(self, prompt_tokens: int, decode_tokens: int,
                          bucket: str = "mixed") -> float:
        """Modelled millijoules to serve one request of this length profile
        at the bucket's policy column — the fleet router's arch-affinity
        signal. Prefill is priced at the prefill lock, decode at the batched
        column matching the bucket (``long`` -> the long-context regime,
        where the recurrent archs' flat energy curves win). Both phases
        count: an arch with cheap flat decode but a brutal prefill scan must
        not win long-prompt traffic on decode numbers alone. Contexts here
        are already absolute (production-scale), so ``context_scale`` does
        not apply."""
        regime = "bs32_long" if bucket == "long" else "bs32"
        ctx = self.long_context if bucket == "long" else self.context
        dec = resolve(
            self.emodel,
            decode_workload(self.arch_cfg, 32, int(ctx), fused=self.fused),
            self.lever_for(regime),
        )
        pre = resolve(
            self.emodel,
            prefill_workload(self.arch_cfg, 1, self.prefill_seq, fused=self.fused),
            self.lever_for("prefill"),
        )
        return (prompt_tokens * pre.profile.energy_per_token_mj
                + decode_tokens * dec.profile.energy_per_token_mj)

    # ----------------------------------------------------------- the closure
    def _resolve(self, role: str, occupancy: int, mean_context: float,
                 lever: Lever) -> OperatingPoint:
        """Resolve an already-chosen lever against the pool's live workload."""
        if role == "prefill":
            w = prefill_workload(self.arch_cfg, 1, self.prefill_seq, fused=self.fused)
        else:
            ctx = max(int(mean_context), 1) if mean_context else self.context
            w = decode_workload(self.arch_cfg, max(occupancy, 1), ctx, fused=self.fused)
        return resolve(self.emodel, w, lever)

    def operating_point(self, role: str, occupancy: int, mean_context: float) -> OperatingPoint:
        """Regime + lever + resolve in one call (probe/test convenience).
        ``mean_context`` is live (pool-scale) tokens; ``context_scale``
        converts it to the production-scale context being modelled."""
        ctx = mean_context * self.context_scale
        lever = self.lever_for(self.regime_for(role, occupancy, ctx))
        return self._resolve(role, occupancy, ctx, lever)

    def tick(self, pools: Mapping[str, "Pool"], step: int):  # noqa: F821
        """Apply the regime-matched lever to every pool; record transitions."""
        slo_walked = False
        for name, pool in pools.items():
            occ = pool.occupancy()
            ctx = pool.mean_context() * self.context_scale
            regime = self.regime_for(pool.role, occ, ctx)
            if self.mode == "slo" and regime != "prefill" and not slo_walked:
                # one walk step per tick, against the live decode regime
                self._slo_update(regime)
                slo_walked = True
            lever = self.lever_for(regime)
            op = self._resolve(pool.role, occ, ctx, lever)
            # keyed on the lever alone: a regime flip that resolves to the
            # same lever (batch-invariant archs, default mode) is not a
            # lever transition
            if self._last.get(name) != lever:
                self._last[name] = lever
                self.transitions.append(
                    Transition(
                        step=step,
                        pool=name,
                        regime=regime,
                        lever=op.lever,
                        configured=op.configured,
                        actual_clock_mhz=op.actual_clock_mhz,
                        engaged=op.engaged,
                    )
                )
            pool.idle_power_w = self.emodel.spec.p_idle
            # paged pools derive decode joules from measured block traffic:
            # give them the spec's achievable HBM bandwidth as denominator
            pool.hbm_bw_eff = self.emodel.hbm_bw_eff
            # a colocated pool (role "mixed") runs both phases at ONE lever
            # — the compromise disaggregation removes. Price its prefill
            # tokens at the prefill workload resolved under that same lever.
            prefill_op = None
            if pool.role not in ("prefill", "decode"):
                prefill_op = self._resolve("prefill", 1, ctx, lever)
            pool.set_operating_point(op, prefill_op)
