"""The policy autotuner: a closed loop from the serving signals to the
serving knobs.

The port of ``flyimg_tpu/runtime/autotuner.py``. Every policy constant (a
controller's batch size and flush deadline, the ``resample_kernel=auto``
band fraction, the reuse min-scale, the host stage pools' sizes) is set by
hand and serves every traffic mix alike; this module moves them within
bounds:

- **Envelopes**: every knob has a hard min and max and a step an
  adjustment may move (``ENVELOPES``; ``autotune_envelopes`` overrides a
  knob's). The tuner never leaves one, whatever the signals say.
- **Bounded exploration**: at most ONE in-envelope adjustment an
  evaluation period, chosen by the fixed-priority rules of
  :class:`DecisionEngine` (pure and clock-free). The objective before a
  change is kept; if the next window's objective regressed past
  ``regression_margin`` the knob reverts and cools down, else the value
  commits to the last-known-good table.
- **The SLO-burn guard rail**: when the normalized burn rates reach
  ``freeze_at`` (or the brownout engine reaches BROWNOUT) tuning freezes,
  every knob reverts to last-known-good, until the burn stays under the
  hysteresis gap for a dwell.
- **Audit**: every adjustment, revert, freeze and unfreeze is a history
  record (``/debug/autotune``), an ``autotune.*`` span event on the
  triggering request's trace, a ``flyimg.autotune`` log line and (for
  adjustments and reverts) a ``flyimg_autotune_adjustments_total{knob,
  direction}`` increment; ``flyimg_autotune_frozen`` gauges the guard rail.

``evaluate()`` rides the request path as the brownout engine's does
(service/app.py), rate-limited to ``interval_s`` under an injectable
clock; off (``autotune_enable`` false) it is one bool check, no metric
registers and no knob is written.

The knobs' write paths are thread-safe at their layers:
``BatchController.apply_policy`` swaps ``(max_batch, deadline_s)`` as one
tuple under the controller's lock, ``StagePool.resize`` resizes under its
lock, ``ops.resample.set_auto_band_frac`` steers the band selection only
(the chosen band widths stay part of every program key), and the handler's
``reuse_min_scale`` is one float store.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from flyimg_tpu_torch.runtime import tracing
from flyimg_tpu_torch.runtime.metrics import escape_label_value
from flyimg_tpu_torch.runtime.observatory import SignalWindow
from flyimg_tpu_torch.testing import faults

__all__ = [
    "Envelope",
    "KnobBinding",
    "DecisionEngine",
    "PolicyAutotuner",
    "ENVELOPES",
    "default_envelopes",
    "reuse_signal_fn",
]

AUTOTUNE_LOGGER = "flyimg.autotune"

#: decision directions (the adjustment counter's label vocabulary)
UP, DOWN, REVERT = "up", "down", "revert"


@dataclass(frozen=True)
class Envelope:
    """The safety contract for one knob: hard bounds the tuner can
    never leave, and the max step one adjustment period may move."""

    lo: float
    hi: float
    step: float
    kind: str = "float"  # or "int"

    def clamp(self, value: float) -> float:
        out = min(max(float(value), self.lo), self.hi)
        return float(int(round(out))) if self.kind == "int" else out

    def move(self, current: float, direction: str) -> float:
        """One bounded step from ``current``; returns the clamped
        target (== current when already pinned at the bound)."""
        delta = self.step if direction == UP else -self.step
        return self.clamp(float(current) + delta)


#: the declared knob families and their pinned safety envelopes
#: (docs/autotuning.md "The knob table"). Bounds are deliberately
#: conservative: every value inside an envelope is a configuration an
#: operator could have shipped by hand.
ENVELOPES: Dict[str, Envelope] = {
    "device.max_batch": Envelope(4, 64, 8, "int"),
    "device.deadline_ms": Envelope(0.5, 20.0, 1.0),
    "codec.max_batch": Envelope(4, 64, 8, "int"),
    "codec.deadline_ms": Envelope(0.25, 10.0, 0.5),
    "host.fetch_workers": Envelope(1, 16, 1, "int"),
    "host.decode_workers": Envelope(1, 16, 1, "int"),
    "host.encode_workers": Envelope(1, 16, 1, "int"),
    "reuse.min_scale": Envelope(1.5, 4.0, 0.25),
    "resample.auto_band_frac": Envelope(0.25, 1.0, 0.25),
}


def default_envelopes(
    overrides: Optional[Dict[str, Dict[str, float]]] = None,
) -> Dict[str, Envelope]:
    """The pinned envelope table with per-knob ``autotune_envelopes``
    overrides folded in ({knob: {lo, hi, step}} — unknown knobs and
    fields are ignored; an override can NARROW or shift a family's
    bounds but malformed values fall back to the pinned ones)."""
    out = dict(ENVELOPES)
    for name, spec in (overrides or {}).items():
        base = out.get(name)
        if base is None or not isinstance(spec, dict):
            continue
        try:
            out[name] = Envelope(
                lo=float(spec.get("lo", base.lo)),
                hi=float(spec.get("hi", base.hi)),
                step=float(spec.get("step", base.step)),
                kind=base.kind,
            )
        except (TypeError, ValueError):
            continue
    return out


@dataclass
class KnobBinding:
    """One live knob: how to read it and how to write it. The applier
    must be thread-safe at its own layer (each registered layer is)."""

    name: str
    envelope: Envelope
    getter: Callable[[], float]
    applier: Callable[[float], None]


@dataclass(frozen=True)
class Proposal:
    knob: str
    target: float
    direction: str
    reason: str


class DecisionEngine:
    """The deterministic decision core: pure functions of (signal window,
    current policy), no clocks, no IO, no randomness, so a replayed
    trajectory reproduces the decisions a live process made.

    Rule priorities (first applicable knob wins; one adjustment per
    period — bounded exploration, not a solver):

    1. a controller whose window runs FULL batches grows ``max_batch``
       (more room per launch);
    2. a controller whose queue-wait share dominates shortens its
       flush deadline (flush sooner, stop queueing);
    3. a controller running SPARSE (low occupancy, no queue wait)
       shortens its deadline too — holding a lone request buys nothing;
    4. a controller padding-heavy at moderate occupancy lengthens its
       deadline one step (let batches fill);
    5. a saturated host stage pool gains a worker; a cold one sheds one;
    6. a low reuse hit ratio under real attempt volume lowers the reuse
       min-scale toward its floor (admit nearer ancestors);
    7. in ``resample_kernel=auto``, compile churn (few batches per
       compile miss) lowers the band worth-it fraction (marginal
       geometries stay dense → fewer distinct K-bucket programs), and a
       warm compile cache raises it back toward 1.0.
    """

    # evidence floors and thresholds (documented in docs/autotuning.md)
    MIN_WINDOW_BATCHES = 8
    OCC_FULL = 0.9
    OCC_SPARSE = 0.35
    WAIT_HIGH = 0.25
    WAIT_LOW = 0.05
    PAD_HIGH = 0.5
    POOL_SATURATED = 0.75
    POOL_COLD_SAT = 0.05
    POOL_COLD_BUSY = 0.2
    REUSE_MIN_ATTEMPTS = 32
    REUSE_LOW_RATIO = 0.3
    COMPILE_CHURN = 4.0
    COMPILE_WARM = 32.0

    def objective(self, signals: Dict) -> float:
        """Scalar 'how well is the current policy doing' for the
        revert-on-regression check: batch occupancy minus queue-wait
        share minus a capped burn penalty. Higher is better; windows
        without launch evidence score neutral on the occupancy term."""
        controllers = signals.get("controllers", {}) or {}
        occ, n = 0.0, 0
        wait = 0.0
        for stats in controllers.values():
            if stats.get("window_batches", 0) >= 1:
                occ += float(stats.get("mean_occupancy", 0.0))
                wait += float(stats.get("queue_wait_share", 0.0))
                n += 1
        occ = occ / n if n else 0.0
        wait = wait / n if n else 0.0
        burn = min(float(signals.get("burn_fast_norm", 0.0) or 0.0), 2.0)
        return occ - wait - 0.5 * burn

    def freeze_pressure(self, signals: Dict) -> float:
        """The guard-rail scalar: worst normalized burn rate (>= 1.0 =
        burn over the brownout thresholds), or forced past 1.0 by the
        brownout engine itself sitting at BROWNOUT+."""
        pressure = max(
            float(signals.get("burn_fast_norm", 0.0) or 0.0),
            float(signals.get("burn_slow_norm", 0.0) or 0.0),
        )
        if int(signals.get("brownout_level", 0) or 0) >= 2:
            pressure = max(pressure, 1.0)
        return pressure

    def propose(
        self,
        signals: Dict,
        policy: Dict[str, float],
        envelopes: Dict[str, Envelope],
        *,
        blocked: Optional[set] = None,
    ) -> Optional[Proposal]:
        """The single bounded adjustment this window calls for, or None.
        ``policy`` maps knob name -> current value for the knobs that
        are actually bound; ``blocked`` knobs (cooldown after a revert)
        are skipped."""
        blocked = blocked or set()

        def step(knob: str, direction: str, reason: str
                 ) -> Optional[Proposal]:
            if knob in blocked or knob not in policy:
                return None
            env = envelopes.get(knob)
            if env is None:
                return None
            current = float(policy[knob])
            target = env.move(current, direction)
            if target == current:
                return None  # already pinned at the envelope bound
            return Proposal(knob, target, direction, reason)

        controllers = signals.get("controllers", {}) or {}
        for ctrl in ("device", "codec"):
            stats = controllers.get(ctrl)
            if not stats or (
                stats.get("window_batches", 0) < self.MIN_WINDOW_BATCHES
            ):
                continue
            occ = float(stats.get("mean_occupancy", 0.0))
            wait = float(stats.get("queue_wait_share", 0.0))
            pad = float(stats.get("padding_waste", 0.0))
            if occ >= self.OCC_FULL:
                got = step(
                    f"{ctrl}.max_batch", UP,
                    f"{ctrl} batches full (occupancy {occ:.2f})",
                )
                if got:
                    return got
            if wait >= self.WAIT_HIGH:
                got = step(
                    f"{ctrl}.deadline_ms", DOWN,
                    f"{ctrl} queue-wait share {wait:.2f} dominates",
                )
                if got:
                    return got
            if occ <= self.OCC_SPARSE and wait <= self.WAIT_LOW:
                got = step(
                    f"{ctrl}.deadline_ms", DOWN,
                    f"{ctrl} sparse (occupancy {occ:.2f}); stop paying "
                    "batching latency",
                )
                if got:
                    return got
            # padding_waste is 1 - occupancy over the window, so this
            # rule is gated ABOVE the sparse band: moderate occupancy
            # with wasteful padding means batches flush half-formed —
            # a longer deadline lets them fill. Below the sparse band
            # there is nothing to fill (the sparse rule owns that case).
            if (
                pad >= self.PAD_HIGH
                and self.OCC_SPARSE < occ < self.OCC_FULL
                and wait <= self.WAIT_LOW
            ):
                got = step(
                    f"{ctrl}.deadline_ms", UP,
                    f"{ctrl} padding waste {pad:.2f}; let batches fill",
                )
                if got:
                    return got
        # cold-pool shedding needs RECENT traffic evidence: on an idle
        # or trickle-traffic service every pool reads cold, and steadily
        # shedding workers would greet the next burst under-staffed.
        # launches_delta (launches since the previous evaluation) is the
        # recency signal; windows without it (offline replay rows) fall
        # back to the window depth.
        active = any(
            float(
                stats["launches_delta"]
                if "launches_delta" in stats
                else stats.get("window_batches", 0)
            ) >= self.MIN_WINDOW_BATCHES
            for stats in controllers.values()
        )
        for stage, pool in (signals.get("host", {}) or {}).items():
            sat = float(pool.get("saturation", 0.0))
            busy = float(pool.get("busy_frac", 0.0))
            if sat >= self.POOL_SATURATED:
                got = step(
                    f"host.{stage}_workers", UP,
                    f"host {stage} pool saturated ({sat:.2f})",
                )
                if got:
                    return got
            if (
                active
                and sat <= self.POOL_COLD_SAT
                and busy <= self.POOL_COLD_BUSY
            ):
                got = step(
                    f"host.{stage}_workers", DOWN,
                    f"host {stage} pool cold (busy {busy:.2f})",
                )
                if got:
                    return got
        reuse = signals.get("reuse") or {}
        attempts = float(reuse.get("attempts", 0.0) or 0.0)
        ratio = reuse.get("hit_ratio")
        if (
            ratio is not None
            and attempts >= self.REUSE_MIN_ATTEMPTS
            and float(ratio) < self.REUSE_LOW_RATIO
        ):
            got = step(
                "reuse.min_scale", DOWN,
                f"reuse hit ratio {float(ratio):.2f} over "
                f"{int(attempts)} attempts; admit nearer ancestors",
            )
            if got:
                return got
        if signals.get("kernel_mode") == "auto":
            device = controllers.get("device") or {}
            if device.get("window_batches", 0) >= self.MIN_WINDOW_BATCHES:
                per_miss = float(
                    device.get("batches_per_compile_miss", 0.0)
                )
                if 0 < per_miss < self.COMPILE_CHURN:
                    got = step(
                        "resample.auto_band_frac", DOWN,
                        f"compile churn ({per_miss:.1f} batches/miss); "
                        "keep marginal geometries dense",
                    )
                    if got:
                        return got
                if per_miss > self.COMPILE_WARM:
                    got = step(
                        "resample.auto_band_frac", UP,
                        f"compile cache warm ({per_miss:.1f} "
                        "batches/miss); re-admit banded savings",
                    )
                    if got:
                        return got
        return None


class PolicyAutotuner:
    """The online half: owns the knob bindings, the signal wiring, the
    guard-rail state machine (TUNING <-> FROZEN), the revert-on-
    regression bookkeeping, and the audit surface. ``evaluate()`` is
    called by the HTTP middleware next to ``BrownoutEngine.evaluate``;
    disabled it is one bool check."""

    def __init__(
        self,
        *,
        enabled: bool = False,
        interval_s: float = 30.0,
        regression_margin: float = 0.05,
        cooldown_periods: int = 2,
        freeze_at: float = 1.0,
        unfreeze_hysteresis: float = 0.75,
        freeze_dwell_s: float = 60.0,
        history: int = 64,
        envelopes: Optional[Dict[str, Dict[str, float]]] = None,
        metrics=None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.enabled = bool(enabled)
        self.interval_s = max(float(interval_s), 0.0)
        self.regression_margin = max(float(regression_margin), 0.0)
        self.cooldown_periods = max(int(cooldown_periods), 0)
        self.freeze_at = max(float(freeze_at), 1e-9)
        self.unfreeze_hysteresis = min(
            max(float(unfreeze_hysteresis), 0.0), 1.0
        )
        self.freeze_dwell_s = max(float(freeze_dwell_s), 0.0)
        self.envelopes = default_envelopes(envelopes)
        self.engine = DecisionEngine()
        self._metrics = metrics
        self._clock = clock
        self._lock = threading.Lock()
        self._knobs: Dict[str, KnobBinding] = {}
        self._known_good: Dict[str, float] = {}
        self._pending: Optional[Dict] = None
        self._cooldown: Dict[str, int] = {}
        self._frozen = False
        self._frozen_since: Optional[float] = None
        self._last_eval = float("-inf")
        self._last_signals: Dict = {}
        self._history: deque = deque(maxlen=max(8, int(history)))
        self._adjustments_total = 0
        # a window of its own: assemble() diffs recorded_total per call
        self._window = SignalWindow()

    @classmethod
    def from_params(cls, params, *, metrics=None) -> "PolicyAutotuner":
        # the object-passing `autotune_clock` (tests, the smoke) steps
        # intervals and dwells without sleeping
        clock = params.by_key("autotune_clock") or time.monotonic
        return cls(
            enabled=bool(params.by_key("autotune_enable", False)),
            interval_s=float(params.by_key("autotune_interval_s", 30.0)),
            regression_margin=float(
                params.by_key("autotune_regression_margin", 0.05)
            ),
            cooldown_periods=int(
                params.by_key("autotune_cooldown_periods", 2)
            ),
            freeze_at=float(params.by_key("autotune_freeze_at", 1.0)),
            unfreeze_hysteresis=float(
                params.by_key("autotune_unfreeze_hysteresis", 0.75)
            ),
            freeze_dwell_s=float(
                params.by_key("autotune_freeze_dwell_s", 60.0)
            ),
            history=int(params.by_key("autotune_history", 64)),
            envelopes=params.by_key("autotune_envelopes", {}) or {},
            metrics=metrics,
            clock=clock,
        )

    # -- knob wiring -------------------------------------------------------

    def bind(self, name: str, getter: Callable[[], float],
             applier: Callable[[float], None]) -> None:
        """Register one tunable knob. Only declared families (the
        ``ENVELOPES`` table) are accepted — an envelope-less knob is
        not tunable, by construction."""
        env = self.envelopes.get(name)
        if env is None:
            raise ValueError(f"no declared envelope for knob {name!r}")
        self._knobs[name] = KnobBinding(name, env, getter, applier)

    def register_knobs(self, *, batcher=None, codec_batcher=None,
                       host_pipeline=None, handler=None,
                       resample: bool = True) -> None:
        """Wire the serving layers' live-update surfaces
        (service/app.py). Each layer is optional; an absent layer's
        knobs simply never tune."""
        for name, ctrl in (("device", batcher), ("codec", codec_batcher)):
            if ctrl is None:
                continue
            self.bind(
                f"{name}.max_batch",
                lambda c=ctrl: float(c.policy()[0]),
                lambda v, c=ctrl: c.apply_policy(max_batch=int(v)),
            )
            self.bind(
                f"{name}.deadline_ms",
                lambda c=ctrl: c.policy()[1] * 1000.0,
                lambda v, c=ctrl: c.apply_policy(deadline_ms=float(v)),
            )
        if host_pipeline is not None and getattr(
            host_pipeline, "enabled", False
        ):
            for stage in ("fetch", "decode", "encode"):
                pool = host_pipeline.pool(stage)
                if pool is None:
                    continue
                self.bind(
                    f"host.{stage}_workers",
                    lambda p=pool: float(p.workers),
                    lambda v, p=pool: p.resize(int(v)),
                )
        if handler is not None and getattr(handler, "reuse_enable", False):
            self.bind(
                "reuse.min_scale",
                lambda h=handler: float(h.reuse_min_scale),
                lambda v, h=handler: setattr(
                    h, "reuse_min_scale", float(v)
                ),
            )
        if resample:
            from flyimg_tpu_torch.ops import resample as _resample

            if _resample.kernel_mode() == "auto":
                self.bind(
                    "resample.auto_band_frac",
                    _resample.auto_band_frac,
                    lambda v: _resample.set_auto_band_frac(float(v)),
                )

    def attach_signals(self, *, metrics=None, slo=None, brownout=None,
                       host_pipeline=None, flight_recorder=None,
                       reuse_fn: Optional[Callable[[], Dict]] = None
                       ) -> None:
        """Wire the observatory's read surfaces. All optional — a
        missing source contributes neutral signals (and therefore no
        adjustments that depend on it)."""
        self._window.attach(
            metrics=metrics, slo=slo, brownout=brownout,
            host_pipeline=host_pipeline, flight_recorder=flight_recorder,
            reuse_fn=reuse_fn,
        )

    def known_good(self) -> Dict[str, float]:
        """The last-known-good policy table (what a freeze reverts to;
        what warm start publishes for the next server to adopt)."""
        with self._lock:
            return dict(self._known_good)

    def seed_known_good(self, table: Dict[str, float]) -> Dict[str, float]:
        """Warm start (runtime/warmstart.py): adopt a published known-good
        policy table before any traffic. Only the knobs this server bound
        apply (a stored table may name layers this configuration does not
        run), each clamped to THIS server's envelopes. Applied values
        become the known-good floor, so a later freeze reverts to the
        seeded policy, not to the start's defaults. Returns the applied
        subset."""
        applied: Dict[str, float] = {}
        if not self.enabled:
            return applied
        with self._lock:
            now = self._clock()
            for name in sorted(table or {}):
                binding = self._knobs.get(name)
                if binding is None:
                    continue
                try:
                    value = binding.envelope.clamp(float(table[name]))
                    frm = float(binding.getter())
                    if value != frm:
                        binding.applier(value)
                except Exception:
                    continue  # one bad knob never blocks the rest
                self._known_good[name] = value
                applied[name] = value
                if value != frm:
                    self._record_locked(
                        "seed", name, frm, value, "seed",
                        "warm-start known-good table", now, None,
                    )
        return applied

    def register_metrics(self, registry) -> None:
        """The guard-rail gauge. No-op when disabled: with
        ``autotune_enable`` off the /metrics surface must be
        byte-identical to a tuner-less build (same posture as the SLO
        engine's gauges)."""
        if not self.enabled:
            return
        registry.gauge(
            "flyimg_autotune_frozen",
            "1 while the SLO-burn guard rail has tuning frozen at the "
            "last-known-good policy",
            fn=lambda: 1.0 if self._frozen else 0.0,
        )

    # -- signal assembly ---------------------------------------------------

    def _signals(self) -> Dict:
        return self._window.assemble()

    # -- evaluation --------------------------------------------------------

    def evaluate(self) -> None:
        """One guarded tuning step, riding the request path (rate
        limited to ``interval_s``). The ``autotune.signal`` fault point
        may return a full signal-window override dict — then every call
        evaluates (no rate limit), so the smoke and tests script exact
        decision sequences, same contract as ``brownout.signal``."""
        if not self.enabled or not self._knobs:
            return
        injected = faults.fire("autotune.signal")
        now = self._clock()
        with self._lock:
            if (
                injected is faults.PASS
                and now - self._last_eval < self.interval_s
            ):
                return
            self._last_eval = now
            if injected is not faults.PASS and injected is not None:
                signals = dict(injected)
            else:
                signals = self._signals()
            self._last_signals = signals
            if not self._known_good:
                # first evaluation: the boot policy IS the known-good
                self._known_good = self._current_policy_locked()
            pressure = self.engine.freeze_pressure(signals)
            if self._frozen:
                if (
                    pressure < self.freeze_at * self.unfreeze_hysteresis
                    and self._frozen_since is not None
                    and now - self._frozen_since >= self.freeze_dwell_s
                ):
                    self._unfreeze_locked(now, pressure)
                return
            if pressure >= self.freeze_at:
                self._freeze_locked(now, pressure)
                return
            objective = self.engine.objective(signals)
            self._settle_pending_locked(now, objective)
            proposal = self.engine.propose(
                signals,
                self._current_policy_locked(),
                {k.name: k.envelope for k in self._knobs.values()},
                blocked={
                    k for k, left in self._cooldown.items() if left > 0
                },
            )
            if proposal is not None:
                self._apply_locked(proposal, now, objective)
            # cooldowns decay AFTER this period's proposal, so a
            # reverted knob sits out exactly cooldown_periods evaluations
            self._decay_cooldowns_locked()

    # -- state transitions (caller holds the lock) -------------------------

    def _current_policy_locked(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, knob in self._knobs.items():
            try:
                out[name] = float(knob.getter())
            except Exception:
                continue
        return out

    def _apply_locked(self, proposal: Proposal, now: float,
                      objective: float) -> None:
        knob = self._knobs[proposal.knob]
        frm = float(knob.getter())
        try:
            knob.applier(proposal.target)
        except Exception:
            logging.getLogger(AUTOTUNE_LOGGER).warning(
                "autotune applier for %s failed", proposal.knob,
                exc_info=True,
            )
            return
        self._pending = {
            "knob": proposal.knob,
            "frm": frm,
            "to": proposal.target,
            "objective_before": objective,
            "at_s": now,
        }
        self._record_locked(
            "adjust", proposal.knob, frm, proposal.target,
            proposal.direction, proposal.reason, now, objective,
        )

    def _settle_pending_locked(self, now: float, objective: float) -> None:
        """Verdict on the previous period's adjustment: a regressed
        objective reverts the knob (and cools it down); a surviving one
        commits to the last-known-good table."""
        pending, self._pending = self._pending, None
        if pending is None:
            return
        before = float(pending["objective_before"])
        if objective < before - self.regression_margin:
            knob = self._knobs.get(pending["knob"])
            if knob is not None:
                try:
                    knob.applier(pending["frm"])
                except Exception:
                    logging.getLogger(AUTOTUNE_LOGGER).warning(
                        "autotune revert for %s failed", pending["knob"],
                        exc_info=True,
                    )
            # +1 because this same evaluation's end-of-pass decay
            # consumes one unit: the knob sits out exactly
            # cooldown_periods FULL evaluations after the revert
            self._cooldown[pending["knob"]] = self.cooldown_periods + 1
            self._record_locked(
                "revert", pending["knob"], pending["to"], pending["frm"],
                REVERT,
                f"objective regressed {before:.3f} -> {objective:.3f}",
                now, objective,
            )
            return
        self._known_good[pending["knob"]] = float(pending["to"])

    def _decay_cooldowns_locked(self) -> None:
        for name in list(self._cooldown):
            self._cooldown[name] -= 1
            if self._cooldown[name] <= 0:
                del self._cooldown[name]

    def _freeze_locked(self, now: float, pressure: float) -> None:
        """The guard rail: burn crossed the brownout thresholds —
        revert EVERYTHING to last-known-good and stop tuning until the
        burn clears. A system in SLO debt is the wrong lab."""
        self._frozen = True
        self._frozen_since = now
        self._pending = None
        reverted = []
        for name, value in self._known_good.items():
            knob = self._knobs.get(name)
            if knob is None:
                continue
            try:
                if float(knob.getter()) != value:
                    knob.applier(value)
                    reverted.append(name)
            except Exception:
                logging.getLogger(AUTOTUNE_LOGGER).warning(
                    "autotune freeze-revert for %s failed", name,
                    exc_info=True,
                )
        self._record_locked(
            "freeze", ",".join(reverted) or "-", None, None, "freeze",
            f"burn pressure {pressure:.2f} >= {self.freeze_at:.2f}; "
            "reverted to last-known-good",
            now, None,
        )

    def _unfreeze_locked(self, now: float, pressure: float) -> None:
        self._frozen = False
        self._frozen_since = None
        self._record_locked(
            "unfreeze", "-", None, None, "unfreeze",
            f"burn pressure {pressure:.2f} cleared the hysteresis gap "
            f"for {self.freeze_dwell_s:.0f}s",
            now, None,
        )

    def _record_locked(self, action: str, knob: str,
                       frm: Optional[float], to: Optional[float],
                       direction: str, reason: str, now: float,
                       objective: Optional[float]) -> None:
        """ONE audit record, emitted to every plane at once: history
        (the /debug/autotune document), span event (the triggering
        request's trace), structured log line, and — for adjustments
        and reverts — the per-knob counter."""
        entry = {
            "at_s": round(now, 3),
            "action": action,
            "knob": knob,
            "from": frm,
            "to": to,
            "direction": direction,
            "reason": reason,
            "objective": (
                round(objective, 4) if objective is not None else None
            ),
        }
        self._history.append(entry)
        tracing.add_event(
            f"autotune.{action}", knob=knob, direction=direction,
            reason=reason,
        )
        if direction in (UP, DOWN, REVERT):
            self._adjustments_total += 1
            if self._metrics is not None:
                self._metrics.counter(
                    "flyimg_autotune_adjustments_total"
                    f'{{knob="{escape_label_value(knob)}",'
                    f'direction="{escape_label_value(direction)}"}}',
                    "Online policy adjustments by knob and direction",
                ).inc()
        log = logging.getLogger(AUTOTUNE_LOGGER)
        log_fn = log.warning if action == "freeze" else log.info
        log_fn(
            "autotune %s %s (%s)", action, knob, reason,
            extra={
                "event": f"autotune.{action}",
                "knob": knob,
                "from_value": frm,
                "to_value": to,
                "direction": direction,
                "reason": reason,
            },
        )

    # -- read surface ------------------------------------------------------

    @property
    def frozen(self) -> bool:
        return self._frozen

    def snapshot(self) -> Dict[str, object]:
        """The /debug/autotune JSON document: live policy vs known-good,
        the full envelope table, guard-rail state, and the bounded
        decision history (newest last)."""
        with self._lock:
            policy = self._current_policy_locked()
            return {
                "enabled": self.enabled,
                "frozen": self._frozen,
                "interval_s": self.interval_s,
                "freeze_at": self.freeze_at,
                "regression_margin": self.regression_margin,
                "policy": policy,
                "known_good": dict(self._known_good),
                "envelopes": {
                    name: {
                        "lo": knob.envelope.lo,
                        "hi": knob.envelope.hi,
                        "step": knob.envelope.step,
                    }
                    for name, knob in self._knobs.items()
                },
                "pending": dict(self._pending) if self._pending else None,
                "cooldown": dict(self._cooldown),
                "adjustments_total": self._adjustments_total,
                "history": list(self._history),
                "last_signals": self._last_signals,
            }


def reuse_signal_fn(metrics) -> Callable[[], Dict]:
    """The reuse hit-ratio signal source (service/app.py wiring): reads
    the same ``flyimg_reuse_hits_total{outcome=}`` counters the handler
    increments, WINDOWED per call — each read reports the delta since
    the previous one, so the ratio describes the current evaluation
    period, not the lifetime average (a cold-start miss streak must not
    ratchet ``reuse_min_scale`` to its floor forever). Counter handles
    are get-or-create on the shared registry, so the families it
    touches are exactly the ones the reuse path already registers."""
    prev = {"hit": 0.0, "miss": 0.0, "unsafe": 0.0}

    def read() -> Dict:
        current = {
            outcome: metrics.counter(
                f'flyimg_reuse_hits_total{{outcome="{outcome}"}}',
                "Cache-miss reuse-rewriter decisions by outcome",
            ).value
            for outcome in ("hit", "miss", "unsafe")
        }
        delta = {k: current[k] - prev[k] for k in current}
        prev.update(current)
        attempts = sum(delta.values())
        return {
            "attempts": attempts,
            "hit_ratio": (
                delta["hit"] / attempts if attempts > 0 else None
            ),
        }

    return read
