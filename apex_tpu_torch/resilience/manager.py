"""Periodic checkpoints and resume from the newest valid one (port of the
single-process half of ``apex_tpu.resilience.manager``).

:class:`CheckpointManager` keeps a rotating window of checkpoints
(``step-<N>.ckpt``) written by an :class:`~apex_tpu_torch.checkpoint.
AsyncCheckpointer`, each fsynced before it is published and each checked
by its header, crc and checksum when read.  ``restore_latest`` walks them
newest first and resumes from the first valid one: a file cut short by
the crash that killed the job is skipped with a warning.

The multi-host agreement of the reference (``all_hosts=``, the allgather
of each host's steps and of each load's outcome, ``gc_dead_host_tmp``) is
not ported yet (ROADMAP Queue 1, slice 9); this manager is one process
writing one directory.
"""

from __future__ import annotations

import json
import os
import re
import warnings
from typing import Any, Optional, Set, Tuple

from apex_tpu_torch import checkpoint as _ckpt
from apex_tpu_torch.checkpoint import TemplateMismatchError

Tree = Any


class CheckpointManager:
    """Rotating asynchronous training checkpoints with crash-safe resume.

    >>> mgr = CheckpointManager(dir, keep=3, every=100)
    >>> for step in range(start, total):
    ...     ...train...
    ...     mgr.maybe_save(step, optimizer=opt, amp_state=amp_sd)
    >>> mgr.close()

    ``format="auto"`` writes the bucket-native v2 format whenever the
    optimizer runs bucketed; ``"v1"`` forces the per-leaf format."""

    def __init__(self, directory: str, keep: int = 3, every: int = 100,
                 format: str = "auto"):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        if every < 1:
            raise ValueError(f"every must be >= 1, got {every}")
        if format not in ("auto", "v1", "v2"):
            raise ValueError(f"unknown checkpoint format {format!r}")
        self.directory = directory
        self.keep = keep
        self.every = every
        self.format = format
        self._step_re = re.compile(r"^step-(\d+)\.ckpt$")
        # steps pinned against rotation while they age toward
        # last-known-good, and the last-known-good step itself
        self._pins: Set[int] = set()
        self._lkg: Optional[int] = self._read_lkg()
        self._async = _ckpt.AsyncCheckpointer()
        os.makedirs(directory, exist_ok=True)
        # a crash mid-write leaves step-N.ckpt.tmp behind (rotation only
        # matches published names); one from before this manager is
        # garbage by construction: the previous writer is dead
        tmp_re = re.compile(r"^step-\d+\.ckpt\.tmp$")
        for name in os.listdir(directory):
            if tmp_re.match(name):
                try:
                    os.remove(os.path.join(directory, name))
                except OSError:
                    pass

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step-{step}.ckpt")

    def steps_on_disk(self):
        try:
            names = os.listdir(self.directory)
        except FileNotFoundError:
            return []
        return sorted(int(m.group(1)) for m in map(self._step_re.match,
                                                   names) if m)

    # ---- last-known-good ---------------------------------------------------
    # A step stamped good is the rollback target: rotation never deletes
    # it, nor a pinned step still aging toward the stamp, and the stamp
    # survives restarts in lkg.ckpt.json beside the checkpoints.

    def _lkg_path(self) -> str:
        return os.path.join(self.directory, "lkg.ckpt.json")

    def _read_lkg(self) -> Optional[int]:
        try:
            with open(self._lkg_path(), encoding="utf-8") as f:
                return int(json.load(f)["step"])
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def pin(self, step: int) -> None:
        """Exempt ``step`` from rotation (until :meth:`unpin`)."""
        self._pins.add(int(step))

    def unpin(self, step: int) -> None:
        self._pins.discard(int(step))

    def mark_good(self, step: int) -> None:
        """Stamp ``step`` as the last-known-good checkpoint: rotation
        keeps it beyond ``keep`` until a newer stamp, ``restore_good``
        rolls back to it, and the stamp is written beside the
        checkpoints so a restarted job inherits it."""
        step = int(step)
        self._lkg = step
        self._pins.discard(step)
        tmp = self._lkg_path() + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump({"step": step}, f)
            os.replace(tmp, self._lkg_path())
        except OSError:
            # the stamp is an optimization (rollback falls back to the
            # newest valid file); failing to write it must not stop
            # training
            warnings.warn(f"mark_good: could not persist the last-known-"
                          f"good stamp for step {step}")

    def lkg_step(self) -> Optional[int]:
        """The last-known-good step (None before the first stamp)."""
        return self._lkg

    def restore_good(self, params_like: Tree, optimizer=None,
                     extra_like: Optional[Tree] = None,
                     device=None) -> Optional[Tuple]:
        """Resume from the newest valid checkpoint no newer than the
        last-known-good step (without a stamp: ``restore_latest``)."""
        return self.restore_latest(params_like, optimizer,
                                   extra_like=extra_like, device=device,
                                   max_step=self._lkg)

    # ---- saving ------------------------------------------------------------
    def due(self, step: int) -> bool:
        """True iff ``step`` is on the save cadence: THE predicate of
        ``maybe_save``, so a loop can skip building the save's arguments
        (``amp_state.state_dict()`` reads the device) on other steps."""
        return step % self.every == 0

    def maybe_save(self, step: int, params: Tree = None, optimizer=None,
                   amp_state=None, extra: Optional[Tree] = None,
                   force: bool = False) -> bool:
        """Save iff ``step`` is on the cadence (or ``force``); returns
        True if a save was scheduled.  ``params`` may be None with a
        bucketed optimizer (v2 snapshots its packed buffers)."""
        if not self.due(step) and not force:
            return False
        # the save first waits for the previous one (raising if it
        # failed), so every file on disk is durable; the one scheduled
        # here is not, and rotation keeps `keep` durable files besides it
        self._async.save_training_state(
            self._path(step), params, optimizer=optimizer,
            amp_state=amp_state, step=step, extra=extra, format=self.format)
        self._gc(in_flight=step)
        return True

    def save(self, step: int, params: Tree = None, optimizer=None,
             amp_state=None, extra: Optional[Tree] = None) -> bool:
        """Save now whatever the cadence (the preemption path's final
        save)."""
        return self.maybe_save(step, params, optimizer=optimizer,
                               amp_state=amp_state, extra=extra, force=True)

    def _gc(self, in_flight: Optional[int] = None) -> None:
        """Trim to the newest ``keep`` checkpoints, never counting or
        deleting the in-flight one (a failed write cannot shrink the
        durable window), the last-known-good step or a pinned one."""
        exempt = set(self._pins)
        if self._lkg is not None:
            exempt.add(self._lkg)
        steps = [s for s in self.steps_on_disk()
                 if s != in_flight and s not in exempt]
        for s in steps[:max(0, len(steps) - self.keep)]:
            try:
                os.remove(self._path(s))
            except OSError:
                pass

    # ---- restoring ---------------------------------------------------------
    def restore_latest(self, params_like: Tree, optimizer=None,
                       extra_like: Optional[Tree] = None, device=None,
                       max_step: Optional[int] = None) -> Optional[Tuple]:
        """Resume from the newest VALID checkpoint (at or below
        ``max_step`` when given), or None if there is none.

        A corrupt or truncated file is skipped with a warning and the
        next newest tried.  A template mismatch (an intact file that does
        not fit the caller's tree) raises.  Returns
        :func:`~apex_tpu_torch.checkpoint.load_training_state`'s tuple."""
        steps = sorted(self.steps_on_disk(), reverse=True)
        if max_step is not None:
            steps = [s for s in steps if s <= max_step]
        for step in steps:
            try:
                return _ckpt.load_training_state(
                    self._path(step), params_like, optimizer=optimizer,
                    extra_like=extra_like, device=device)
            except TemplateMismatchError:
                raise
            except (ValueError, OSError) as e:
                # loudly: a fault that walks past every good file
                # restarts training from scratch
                warnings.warn(f"restore_latest: skipping "
                              f"{self._path(step)}: {type(e).__name__}: "
                              f"{e}")
        return None

    def wait(self) -> None:
        """Block until the in-flight save is durable, then trim the
        window to ``keep``."""
        self._async.wait_until_finished()
        self._gc()

    def close(self) -> None:
        self._async.close()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
