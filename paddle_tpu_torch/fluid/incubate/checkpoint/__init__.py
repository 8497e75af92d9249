"""Preemption-aware checkpoints (counterpart of
``paddle_tpu/fluid/incubate/checkpoint``).

Fluid has no elastic recovery: a preempted job restarts by hand from a
checkpoint.  ``AutoCheckpoint`` saves the program's persistables every
``save_interval`` steps into step-stamped directories (a temp directory
renamed into place, the newest ``keep_max`` kept), snapshots on
SIGTERM / SIGINT before the process ends, and ``resume()`` restores the
newest complete checkpoint.

The executor's step counter.  ``Executor`` reseeds every random stream
(dropout's masks) from its step counter before each run
(``fluid/executor.py``, ``registry.RandomStreams``), so a resumed run
draws what the uninterrupted one draws only if the counter comes back
too.  It lives in the checkpoint's ``checkpoint_meta.json`` as
``executor_step`` (the count of runs the executor had made when the
checkpoint was saved, the step the next run draws at), and ``resume()``
sets ``executor._step`` from it.  A window restore (below) sets it to
the window's ``executor_step`` less one: the newest window entry is the
state before the executor's last run, which the caller runs again (one
executor run a training step, as ``step()`` assumes).

Captured graphs.  A captured CUDA graph reads the scope's tensors in
place, so ``resume()`` copies the loaded values into the scope's
tensors where they are there (``io.load_persistables(in_place=True)``):
a restore after the first run is read by the next replay.  ``save()``
synchronizes the device before it reads the state: the signal handler
runs between two bytecodes, after a replay has been enqueued.

The durable rollback window: with ``sentinel=`` (the lane's
``HealthSentinel``), the sentinel's snapshot ring goes through
``health.persist.WindowPersister`` — offloaded on
FLAGS_rollback_persist_interval_s's cadence from ``step()``, written
synchronously inside every ``save()`` (the signal path too), and
``resume()`` prefers the ring when it is newer than the last full
checkpoint: the scope becomes the newest window entry (the pre-state of
the returned step, which the caller runs again: the step's data must be
deterministic), the older entries re-arm the sentinel, and the
``@HEALTH@`` loss-scale state comes back bit for bit.  A ring older
than the checkpoint re-arms the sentinel only.

Not ported: the JAX package's ``distributed.recovery.note`` journal
(``distributed/recovery.py``, ROADMAP 1.8.9).
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import tempfile
import time

import torch

__all__ = ["AutoCheckpoint"]

_META = "checkpoint_meta.json"


class AutoCheckpoint:
    """Usage::

        ckpt = AutoCheckpoint(dirname, exe, main_program, save_interval=100,
                              keep_max=3)
        start_step = ckpt.resume()            # 0 if nothing to restore
        for step in range(start_step, n_steps):
            exe.run(...)
            ckpt.step(step)                   # saves every save_interval
        ckpt.save(step)                       # a last explicit snapshot

    With ``install_signal_handler=True`` (the default) SIGTERM and
    SIGINT snapshot the last step seen, then chain to the handler that
    was installed before (or end the process with the default
    action): the preemption path."""

    def __init__(self, dirname, executor, main_program=None, scope=None,
                 save_interval=100, keep_max=3, install_signal_handler=True,
                 sentinel=None, window_interval_s=None):
        self.dirname = str(dirname)
        self.executor = executor
        self.main_program = main_program
        self.scope = scope
        self.save_interval = int(save_interval)
        self.keep_max = int(keep_max)
        self._last_step = None
        self._last_saved = None
        self.sentinel = sentinel
        self._persister = None
        if sentinel is not None:
            from paddle_tpu_torch.health.persist import WindowPersister

            self._persister = WindowPersister(
                os.path.join(self.dirname, "health_window"), sentinel,
                interval_s=window_interval_s)
        os.makedirs(self.dirname, exist_ok=True)
        self._prev_handlers = {}
        if install_signal_handler:
            self._install()

    def _scope(self):
        from ...executor import global_scope

        return self.scope if self.scope is not None else global_scope()

    def _sync(self):
        device = getattr(self.executor, "device", None)
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)

    def _window_extra(self):
        return {"executor_step": int(self.executor._step)}

    # -- saving ---------------------------------------------------------
    def _ckpt_dir(self, step):
        return os.path.join(self.dirname, f"ckpt_{step:012d}")

    def save(self, step):
        """A snapshot written into a temp directory, its meta fsynced,
        then renamed into place."""
        from ... import io

        if self._last_saved == step:
            return self._ckpt_dir(step)
        self._sync()
        final = self._ckpt_dir(step)
        tmp = tempfile.mkdtemp(prefix=".ckpt_tmp_", dir=self.dirname)
        try:
            io.save_persistables(self.executor, tmp,
                                 main_program=self.main_program,
                                 scope=self.scope)
            meta = {"step": int(step), "time": time.time(),
                    "executor_step": int(self.executor._step),
                    "complete": True}
            with open(os.path.join(tmp, _META), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._last_saved = step
        self._gc()
        if self._persister is not None:
            # the ring is written on this thread: the signal path lands
            # here, and the ring must be on disk before the process ends
            self._persister.offload(self._scope(), step,
                                    trigger="checkpoint", wait=True,
                                    extra=self._window_extra())
        return final

    def step(self, step):
        """Note progress; save when the interval has elapsed.  With a
        sentinel, also offload the rollback window on its cadence (a
        clock read on the step's path)."""
        self._last_step = step
        if self.save_interval > 0 and step > 0 and \
                step % self.save_interval == 0:
            self.save(step)
        elif self._persister is not None:
            self._persister.maybe_offload(self._scope(), step,
                                          extra=self._window_extra())

    def flush_window(self, wait=True):
        """One offload of the sentinel's window at the last step seen (no
        full checkpoint).  False without a sentinel."""
        if self._persister is None or self._last_step is None:
            return False
        self._sync()
        return self._persister.offload(self._scope(), self._last_step,
                                       trigger="flush", wait=wait,
                                       extra=self._window_extra())

    def close(self):
        """Flush and stop the window persister's worker and restore the
        signal handlers.  Safe to call twice."""
        if self._persister is not None:
            self.flush_window(wait=True)
            self._persister.close()
        self.uninstall()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _gc(self):
        cks = self._list()
        for d, _meta in cks[:-self.keep_max] if self.keep_max > 0 else []:
            shutil.rmtree(os.path.join(self.dirname, d), ignore_errors=True)
        # temp directories of saves a hard kill interrupted
        for d in os.listdir(self.dirname):
            if d.startswith(".ckpt_tmp_"):
                shutil.rmtree(os.path.join(self.dirname, d),
                              ignore_errors=True)

    # -- resume ---------------------------------------------------------
    def _list(self):
        """Complete checkpoints as [(dirname, meta)] in step order."""
        out = []
        for d in sorted(os.listdir(self.dirname)):
            if not d.startswith("ckpt_"):
                continue
            try:
                with open(os.path.join(self.dirname, d, _META)) as f:
                    meta = json.load(f)
            except (OSError, json.JSONDecodeError):
                continue  # torn: ignored
            if meta.get("complete"):
                out.append((d, meta))
        out.sort(key=lambda x: x[1]["step"])
        return out

    def resume(self):
        """Restore the newest complete checkpoint (and the executor's
        step counter); returns the next step to run (0 without one).
        With a sentinel, a persisted window newer than the checkpoint
        wins (module docstring)."""
        from ... import io

        cks = self._list()
        start = 0
        if cks:
            d, meta = cks[-1]
            io.load_persistables(self.executor,
                                 os.path.join(self.dirname, d),
                                 main_program=self.main_program,
                                 scope=self.scope, in_place=True)
            self._last_saved = self._last_step = meta["step"]
            if "executor_step" in meta:
                self.executor._step = int(meta["executor_step"])
            start = int(meta["step"]) + 1
        if self._persister is not None:
            wstep = self._persister.manifest_step()
            if wstep is not None and wstep >= start:
                m = self._persister.restore_into(self._scope())
                if m is not None:
                    start = self._last_step = wstep
                    exe_step = m.get("extra", {}).get("executor_step")
                    if exe_step is not None:
                        self.executor._step = int(exe_step) - 1
            elif wstep is not None:
                self._persister.restore_into(self._scope(),
                                             rearm_scope=False)
        return start

    # -- the preemption hook --------------------------------------------
    def _install(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev_handlers[sig] = signal.signal(sig,
                                                         self._on_signal)
            except ValueError:  # not the main thread
                break

    def uninstall(self):
        """Put back the handlers that were there before this hook.  Safe
        to call twice; from another thread than the main one it keeps
        them for a later call."""
        for sig in list(self._prev_handlers):
            prev = self._prev_handlers[sig]
            try:
                signal.signal(sig, prev if prev is not None
                              else signal.SIG_DFL)
            except ValueError:
                break
            self._prev_handlers.pop(sig)

    def _on_signal(self, signum, frame):
        if self._last_step is not None:
            try:
                self.save(self._last_step)
            except Exception:  # best effort on the way down
                pass
        prev = self._prev_handlers.get(signum)
        if prev is signal.SIG_IGN:
            # ignored before: snapshot taken, keep running
            signal.signal(signum, signal.SIG_IGN)
            return
        if callable(prev):
            # chain to the handler installed before (a launcher's own
            # teardown); this hook stays, so a later signal snapshots too
            prev(signum, frame)
            return
        # the default action (or a handler not set from Python): deliver
        # the signal again with it, so the process ends
        signal.signal(signum, signal.SIG_DFL)
        signal.raise_signal(signum)
