"""Optional ``torch.profiler`` capture window for the serve loop (the
port's counterpart of ``repro/obs/profiling.py``, which wraps
``jax.profiler``).

``--profile-dir PATH`` on the launcher arms a ``ProfileWindow``: the first
serve step after arming starts a ``torch.profiler.profile`` over the CPU
and, on the card, the CUDA activity; the window stops it after N steps (or
at serve teardown, whichever comes first) and writes a Chrome trace into
``log_dir``.  The trace shows the device-side kernel times that the
host-side ``StepTracer`` cannot see; the two line up via step numbers.

Stop is idempotent: the scheduler calls ``stop()`` both when the window
elapses and unconditionally in its teardown, and a profiler that fails to
start leaves the window disarmed rather than wedging serving.
"""
from __future__ import annotations

import os
import time
from typing import Optional


class ProfileWindow:
    """Capture ``n_steps`` serve steps into a torch.profiler Chrome trace
    under ``log_dir``.  Inert when ``log_dir`` is empty.  ``cuda`` adds the
    CUDA activity (default: when a card is present); a CPU engine records
    the CPU activity only.  ``trace_path`` is the file written, once the
    window has stopped."""

    def __init__(self, log_dir: str = "", n_steps: int = 8, *, cuda: Optional[bool] = None):
        if n_steps < 1:
            raise ValueError(f"profile window needs n_steps >= 1, got {n_steps}")
        self.log_dir = log_dir
        self.n_steps = n_steps
        self.cuda = cuda
        self.steps_seen = 0
        self.active = False
        self.done = not log_dir
        self.trace_path = ""
        self._prof = None

    def on_step(self) -> None:
        """Called once per serve step; drives the start->capture->stop arc."""
        if self.done:
            return
        if not self.active:
            try:
                import torch

                cuda = torch.cuda.is_available() if self.cuda is None else self.cuda
                acts = [torch.profiler.ProfilerActivity.CPU]
                if cuda:
                    acts.append(torch.profiler.ProfilerActivity.CUDA)
                prof = torch.profiler.profile(activities=acts)
                prof.start()
            except Exception:
                self.done = True  # profiler unavailable: disarm, keep serving
                return
            self._prof = prof
            self.active = True
        self.steps_seen += 1
        if self.steps_seen >= self.n_steps:
            self.stop()

    def stop(self) -> None:
        if not self.active:
            self.done = True
            return
        self.active = False
        self.done = True
        prof, self._prof = self._prof, None
        try:
            prof.stop()
            os.makedirs(self.log_dir, exist_ok=True)
            path = os.path.join(self.log_dir,
                                f"serve_trace_{os.getpid()}_{time.time_ns()}.json")
            prof.export_chrome_trace(path)
            self.trace_path = path
        except Exception:
            pass


def make_profile_window(log_dir: str = "", n_steps: int = 8, *,
                        cuda: Optional[bool] = None) -> Optional[ProfileWindow]:
    """A window when ``log_dir`` is set, else None (scheduler skips the hook)."""
    return ProfileWindow(log_dir, n_steps, cuda=cuda) if log_dir else None
