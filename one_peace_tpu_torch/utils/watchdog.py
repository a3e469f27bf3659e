"""Hang watchdog.

Capability equivalent of fairseq's DistributedTimeoutWrapper
(ref: fairseq/distributed/distributed_timeout_wrapper.py:1-97): the
reference arms a timer around forward/backward and kills a rank that
stalls (a hung NCCL collective).  On TPU the failure mode is a wedged
remote dispatch; the watchdog wraps any blocking call and raises (or
kills the process) if it exceeds the timeout, so orchestration can
restart from the latest checkpoint.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Optional


class WatchdogTimeout(Exception):
    pass


class Watchdog:
    """Arm around blocking sections:

        wd = Watchdog(timeout=300, action="raise")
        with wd.guard("train_step"):
            metrics = trainer.train_step(batch)
    """

    def __init__(self, timeout: float, action: str = "raise"):
        assert action in ("raise", "kill")
        self.timeout = timeout
        self.action = action
        # a STACK of timers: nested guards on one watchdog must not
        # orphan the outer timer (it would fire after its section
        # completed and kill a healthy process)
        self._timers: list = []
        self._tripped = threading.Event()
        self._fired_at = 0.0
        self._section = ""

    def _fire(self):
        import time

        self._fired_at = time.monotonic()
        self._tripped.set()
        if self.action == "kill":
            # the reference sends SIGKILL to the hung rank (ref :88-97)
            os.kill(os.getpid(), signal.SIGKILL)
        else:
            # raise in the main thread at the next interpreter checkpoint
            import _thread

            _thread.interrupt_main()

    def guard(self, section: str = ""):
        return _Guard(self, section)

    @property
    def tripped(self) -> bool:
        return self._tripped.is_set()


class _Guard:
    def __init__(self, wd: Watchdog, section: str):
        self.wd = wd
        self.section = section

    def __enter__(self):
        self.wd._section = self.section
        self._timer = threading.Timer(self.wd.timeout, self.wd._fire)
        self._timer.daemon = True
        self._timer.start()
        self.wd._timers.append(self._timer)
        return self

    # a KeyboardInterrupt arriving this long after the timer fired is the
    # user's Ctrl-C, not the watchdog's interrupt_main still in flight —
    # without the window, a stale tripped flag from an earlier (handled)
    # timeout would convert a genuine Ctrl-C into WatchdogTimeout and
    # send orchestration back into its retry loop
    _CONVERT_WINDOW_S = 10.0

    def __exit__(self, exc_type, exc, tb):
        import time

        self._timer.cancel()
        if self._timer in self.wd._timers:
            self.wd._timers.remove(self._timer)
        if exc_type is KeyboardInterrupt and self.wd.tripped:
            recent = (time.monotonic() - self.wd._fired_at
                      < self._CONVERT_WINDOW_S)
            # consume the flag either way: the interrupt it flagged has
            # now been delivered
            self.wd._tripped.clear()
            if recent:
                raise WatchdogTimeout(
                    f"section {self.section or self.wd._section!r} exceeded "
                    f"{self.wd.timeout}s") from None
        # NOTE: if the timer fires in the same instant the section
        # completes, interrupt_main's KeyboardInterrupt can be delivered
        # after this cancel — it then surfaces inside the NEXT guard
        # (converted there by the recency check) or, with no guard active,
        # as a plain KeyboardInterrupt the caller must treat as fatal.
        return False
