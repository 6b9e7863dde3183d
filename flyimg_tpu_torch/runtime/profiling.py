"""On-demand device profiling: arm a torch.profiler capture of the next N
batches over HTTP, without a redeploy.

The port of ``flyimg_tpu/runtime/profiling.py`` on ``torch.profiler`` (the
CPU activity, and the CUDA one where a card is visible). The wall-clock
``/debug/trace`` route captures whatever happens to run during its sleep;
this captures *work*: arming sets a batch budget, the capture starts at the
next batch launch and stops after N batches (or a deadline, whichever comes
first), so one request during an incident yields a timeline of exactly the
launches that matter, each inside a ``flyimg:batch:<id>`` range
(``torch.profiler.record_function`` in the batchers), with the kernels the
launch ran on the card's timeline.

Contract (the JAX module's):

- one capture at a time, process-wide (the profiler is process state);
  arming while armed or running raises, which the server answers 409;
- bounded: the batch budget by ``profiling_max_batches``, the duration by
  ``profiling_max_seconds`` (a watchdog stops an armed-but-idle or wedged
  capture). The first start of the profiler in a process loads CUPTI and
  can take seconds; the deadline counts from the arm, so allow for it;
- captures are Chrome-trace JSON (``trace.json``) under ``profiling_dir``
  (default ``<tmp_dir>/profiles``), one directory each, listed and
  downloadable as tar.gz from the debug-gated ``/debug/profile`` routes.

The batchers call ``on_batch_start`` and ``on_batch_end`` around every
launch; both are one attribute check when nothing is armed. Launches run on
the batchers' threads while the capture starts on one and stops on another,
so the session records every thread (``profile_all_threads``); a profiler
that cannot start records why in ``last_error`` and the batch runs on.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = ["DeviceProfiler", "ProfilerSession", "TRACE_FILE"]

PROFILER_LOGGER = "flyimg.profiler"
#: the Chrome-trace file of a capture directory
TRACE_FILE = "trace.json"


class ProfilerSession:
    """One ``torch.profiler.profile`` session writing ``TRACE_FILE`` into
    ``out_dir`` when it stops: CPU activity always, CUDA activity when a
    card is visible, every thread recorded."""

    def __init__(self, out_dir: str) -> None:
        self.out_dir = out_dir
        self._prof = None

    def start(self) -> None:
        import torch
        from torch._C._profiler import _ExperimentalConfig

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(self.out_dir, exist_ok=True)
        prof = torch.profiler.profile(
            activities=activities,
            experimental_config=_ExperimentalConfig(profile_all_threads=True),
        )
        prof.start()
        self._prof = prof

    def stop(self) -> str:
        """Stop and export; returns the trace file's path."""
        prof, self._prof = self._prof, None
        prof.stop()
        path = os.path.join(self.out_dir, TRACE_FILE)
        prof.export_chrome_trace(path)
        return path


class DeviceProfiler:
    """Batch-scoped torch.profiler capture with a single-flight arm."""

    def __init__(
        self,
        *,
        base_dir: str,
        max_batches: int = 16,
        max_seconds: float = 30.0,
        metrics=None,
    ) -> None:
        self.base_dir = base_dir
        self.max_batches = max(1, int(max_batches))
        self.max_seconds = max(1.0, float(max_seconds))
        self._metrics = metrics
        self._lock = threading.Lock()
        # `_armed` doubles as the hot-path gate: on_batch_start/end read
        # it unlocked (a stale read costs one lock round at worst)
        self._armed = False
        self._active = False          # the session has started
        self._session: Optional[ProfilerSession] = None
        self._remaining = 0
        self._capture_id = 0
        self._capture_dir: Optional[str] = None
        self._deadline = 0.0
        self._captures_total = 0
        self._last_error: Optional[str] = None

    @classmethod
    def from_params(cls, params, *, metrics=None) -> "DeviceProfiler":
        base_dir = str(params.by_key("profiling_dir", "") or "")
        if not base_dir:
            base_dir = os.path.join(
                str(params.by_key("tmp_dir", "var/tmp")), "profiles"
            )
        return cls(
            base_dir=base_dir,
            max_batches=int(params.by_key("profiling_max_batches", 16)),
            max_seconds=float(params.by_key("profiling_max_seconds", 30.0)),
            metrics=metrics,
        )

    # -- arming ------------------------------------------------------------

    @property
    def busy(self) -> bool:
        """True while a capture is armed or running: the wall-clock
        ``/debug/trace`` capture refuses (409) meanwhile, as both drive the
        one process-wide profiler."""
        with self._lock:
            return self._armed or self._active

    def arm(self, batches: int,
            max_s: Optional[float] = None) -> Dict[str, object]:
        """Arm a capture of the next ``batches`` batches. Returns the armed
        state; raises RuntimeError when a capture is armed or running."""
        batches = max(1, min(int(batches), self.max_batches))
        duration = min(
            float(max_s) if max_s else self.max_seconds, self.max_seconds
        )
        with self._lock:
            if self._armed or self._active:
                raise RuntimeError("a profiler capture is already in flight")
            self._capture_id += 1
            capture_id = self._capture_id
            self._armed = True
            self._active = False
            self._remaining = batches
            self._deadline = time.monotonic() + duration
            self._capture_dir = os.path.join(
                self.base_dir,
                time.strftime("capture-%Y%m%d-%H%M%S") + f"-{capture_id}",
            )
            self._last_error = None
        # the watchdog bounds an armed-but-idle or wedged capture; started
        # outside the lock (a thread start blocks)
        threading.Thread(
            target=self._watchdog, args=(capture_id, duration),
            name="flyimg-profiler-watchdog", daemon=True,
        ).start()
        logging.getLogger(PROFILER_LOGGER).info(
            "profiler armed for %d batches (max %.1fs) -> %s",
            batches, duration, self._capture_dir,
        )
        return self.snapshot()

    def _watchdog(self, capture_id: int, duration: float) -> None:
        time.sleep(duration)
        self._finish(capture_id, "deadline")

    # -- batcher hooks (hot path) -----------------------------------------

    def on_batch_start(self) -> None:
        """Called by a batcher before every launch: starts the armed
        capture on the first one. Never raises: a profiler failure must not
        take a batch down (it lands in ``last_error``)."""
        if not self._armed:
            return
        with self._lock:
            if not self._armed or self._active:
                return
            session = ProfilerSession(self._capture_dir)
            try:
                session.start()
            except Exception as exc:
                # another session (the /debug/trace capture) owns the
                # profiler, or this build has no such profiler
                self._armed = False
                self._remaining = 0
                self._last_error = f"{type(exc).__name__}: {exc}"
                logging.getLogger(PROFILER_LOGGER).warning(
                    "profiler start failed: %s", exc
                )
                return
            self._session = session
            self._active = True

    def on_batch_end(self) -> None:
        """Called by a batcher after every resolved launch; stops the
        capture when the batch budget is spent."""
        if not self._active:
            return
        capture_id = None
        with self._lock:
            if not self._active:
                return
            self._remaining -= 1
            if self._remaining <= 0:
                capture_id = self._capture_id
        if capture_id is not None:
            self._finish(capture_id, "batch_budget")

    def _finish(self, capture_id: int, reason: str) -> None:
        with self._lock:
            if self._capture_id != capture_id or not (
                self._armed or self._active
            ):
                return  # a newer capture owns the profiler, or done already
            was_active = self._active
            session, self._session = self._session, None
            if was_active and session is None:
                return  # another caller is stopping this capture
            self._armed = False
            self._remaining = 0
            capture_dir = self._capture_dir
        if not was_active:
            logging.getLogger(PROFILER_LOGGER).info(
                "profiler disarmed before any batch arrived (%s)", reason
            )
            return
        try:
            session.stop()
        except Exception as exc:
            with self._lock:
                self._active = False
                self._last_error = f"{type(exc).__name__}: {exc}"
            logging.getLogger(PROFILER_LOGGER).warning(
                "profiler stop failed: %s", exc
            )
            return
        with self._lock:
            # busy until the trace is on disk: a listed capture is whole
            self._active = False
            self._captures_total += 1
        if self._metrics is not None:
            self._metrics.counter(
                "flyimg_profiler_captures_total",
                "Completed on-demand device-profile captures",
            ).inc()
        logging.getLogger(PROFILER_LOGGER).info(
            "profiler capture complete (%s) -> %s", reason, capture_dir,
            extra={
                "event": "profiler.capture",
                "reason": reason,
                "capture_dir": capture_dir,
            },
        )

    # -- read surface ------------------------------------------------------

    def captures(self) -> List[Dict[str, object]]:
        """Completed capture directories under base_dir, newest first (the
        one being written is left out)."""
        with self._lock:
            writing = (os.path.basename(self._capture_dir or "")
                       if self._active else None)
        try:
            names = sorted(
                (n for n in os.listdir(self.base_dir)
                 if n.startswith("capture-") and n != writing),
                reverse=True,
            )
        except OSError:
            return []
        out = []
        for name in names:
            path = os.path.join(self.base_dir, name)
            size = 0
            for root, _dirs, files in os.walk(path):
                for fname in files:
                    try:
                        size += os.path.getsize(os.path.join(root, fname))
                    except OSError:
                        pass
            out.append({"name": name, "bytes": size})
        return out

    def capture_path(self, name: str) -> Optional[str]:
        """One listed capture's directory: names are checked against the
        listing, so a crafted path segment cannot leave base_dir."""
        if any(c["name"] == name for c in self.captures()):
            return os.path.join(self.base_dir, name)
        return None

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            state = {
                "armed": self._armed,
                "active": self._active,
                "remaining_batches": self._remaining,
                "capture_dir": (
                    self._capture_dir
                    if (self._armed or self._active) else None
                ),
                "captures_total": self._captures_total,
                "last_error": self._last_error,
                "max_batches": self.max_batches,
                "max_seconds": self.max_seconds,
            }
        state["captures"] = self.captures()
        return state
