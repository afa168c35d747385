"""Preemption-safe shutdown (port of ``apex_tpu.resilience.preemption``):
turn an asynchronous preemption notice into a save-then-clean-exit at the
next STEP BOUNDARY.

A scheduler that evicts a job sends SIGTERM some grace period before it
pulls the plug.  Killing the process mid-step would waste the work since
the last cadence checkpoint, and handling the signal inline would tear a
half-queued step, so :class:`PreemptionGuard` only RECORDS the notice (a
signal handler must do nearly nothing).  The training loop asks
``guard.check(step)`` once per step boundary, writes a final forced
checkpoint (``CheckpointManager.save``), waits for it to be durable and
returns.

``preempt_at_step=N`` gives the notice at step N with no signal at all
(the examples' ``--preempt-at-step``); ``notice()`` lets another thread
give it.
"""

from __future__ import annotations

import signal
import threading
import warnings
from typing import Optional, Sequence


class PreemptionGuard:
    """Record SIGTERM (or a custom signal set) and surface it at step
    boundaries.

    >>> with PreemptionGuard() as guard:
    ...     for step in range(start, total):
    ...         train_one(step)
    ...         mgr.maybe_save(step, optimizer=opt)
    ...         if guard.check(step):
    ...             mgr.save(step, optimizer=opt)   # forced, final
    ...             mgr.wait()
    ...             break
    """

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,),
                 preempt_at_step: Optional[int] = None):
        self.signals = tuple(signals)
        self.preempt_at_step = preempt_at_step
        self._flag = threading.Event()
        self._old: dict = {}
        self._installed = False

    # ---- lifecycle -------------------------------------------------------
    def install(self) -> "PreemptionGuard":
        """Install the signal handlers (idempotent).  Only the main
        thread may install handlers; elsewhere the guard degrades to
        its programmatic notices (``notice()`` / ``preempt_at_step``)
        with a warning rather than failing."""
        if self._installed:
            return self
        try:
            for s in self.signals:
                self._old[s] = signal.signal(s, self._on_signal)
            self._installed = True
        except ValueError:
            # roll back whatever DID install: a half-armed guard that
            # uninstall() won't touch would shadow SIGTERM forever
            for s, old in self._old.items():
                signal.signal(s, old)
            self._old.clear()
            if threading.current_thread() is threading.main_thread():
                raise   # an invalid signal set is a caller bug
            warnings.warn(   # off the main thread: expected, degrade
                "PreemptionGuard: signal handlers can only be "
                "installed from the main thread; falling back to "
                "programmatic notices only")
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for s, old in self._old.items():
            signal.signal(s, old)
        self._old.clear()
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # ---- notice ----------------------------------------------------------
    def _on_signal(self, signum, frame) -> None:
        # a signal handler must do (nearly) nothing: set the flag, let
        # the step boundary do the real work
        self._flag.set()

    def notice(self) -> None:
        """Programmatic preemption notice (host-agent integrations)."""
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def check(self, step: int) -> bool:
        """True once a notice has arrived (or ``step`` reached
        ``preempt_at_step``) — ask at every step boundary."""
        if self.preempt_at_step is not None \
                and step >= self.preempt_at_step:
            self._flag.set()
        return self.preempted
