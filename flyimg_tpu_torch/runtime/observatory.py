"""The observatory's signal window.

The port of ``SignalWindow`` from ``flyimg_tpu/runtime/observatory.py``:
one dict of the signals the policy autotuner (``runtime/autotuner.py``)
and the telemetry beat (``runtime/telemetry.py``) read. The rest of that
module, the fleet observatory, is not ported.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

__all__ = ["SignalWindow"]


class SignalWindow:
    """The signal assembly: the controllers' efficiency windows (with the
    launches since this window's previous call), the normalized SLO burn,
    the brownout level, the host pools' saturation, the reuse ratio, the
    flight recorder's recent summary and the resample kernel mode.
    ``attach()`` wires the read surfaces (each optional: a missing one
    gives neutral signals); ``assemble()`` returns one window.

    Not to be shared: ``assemble()`` diffs each controller's
    ``recorded_total`` against its own previous call, so two readers of
    one instance would each see part of the launches."""

    def __init__(self) -> None:
        self._prev_recorded: Dict[str, float] = {}
        self._slo = None
        self._brownout = None
        self._host_pipeline = None
        self._flight_recorder = None
        self._batch_stats_fn: Optional[Callable[[str], Dict]] = None
        self._reuse_fn: Optional[Callable[[], Dict]] = None

    def attach(self, *, metrics=None, slo=None, brownout=None,
               host_pipeline=None, flight_recorder=None,
               reuse_fn: Optional[Callable[[], Dict]] = None) -> None:
        if metrics is not None:
            self._batch_stats_fn = lambda name: metrics.batch_efficiency(name).stats()
        self._slo = slo
        self._brownout = brownout
        self._host_pipeline = host_pipeline
        self._flight_recorder = flight_recorder
        self._reuse_fn = reuse_fn

    def assemble(self) -> Dict:
        from flyimg_tpu_torch.ops.resample import kernel_mode

        out: Dict = {"controllers": {}, "host": {}}
        if self._batch_stats_fn is not None:
            for name in ("device", "codec"):
                try:
                    stats = dict(self._batch_stats_fn(name))
                except Exception:
                    continue
                # recency: the efficiency window is count-based and never
                # expires, so one old burst would read as live traffic
                total = float(stats.get("recorded_total", 0.0))
                prev = self._prev_recorded.get(name)
                stats["launches_delta"] = total - prev if prev is not None else 0.0
                self._prev_recorded[name] = total
                out["controllers"][name] = stats
        slo = self._slo
        if slo is not None and getattr(slo, "enabled", False):
            try:
                out["burn_fast_norm"] = slo.burn_rate("fast") / max(slo.burn_threshold_fast, 1e-9)
                out["burn_slow_norm"] = slo.burn_rate("slow") / max(slo.burn_threshold_slow, 1e-9)
            except Exception:
                pass
        if self._brownout is not None:
            try:
                out["brownout_level"] = int(self._brownout.level())
            except Exception:
                pass
        pipeline = self._host_pipeline
        if pipeline is not None and getattr(pipeline, "enabled", False):
            try:
                for stage, stats in pipeline.snapshot().items():
                    bound = max(stats.get("bound", 0.0), 1.0)
                    workers = max(stats.get("workers", 1.0), 1.0)
                    out["host"][stage] = {
                        "saturation": stats.get("pending", 0.0) / bound,
                        "busy_frac": stats.get("busy", 0.0) / workers,
                        "workers": workers,
                    }
            except Exception:
                pass
        if self._reuse_fn is not None:
            try:
                out["reuse"] = self._reuse_fn()
            except Exception:
                pass
        if self._flight_recorder is not None:
            try:
                out["flightrecorder"] = self._flight_recorder.recent_summary()
            except Exception:
                pass
        out["kernel_mode"] = kernel_mode()
        return out
