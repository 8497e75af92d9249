"""The durable rollback window: the health sentinel's snapshot ring kept
across a preemption (counterpart of ``paddle_tpu/health/persist.py``).

The sentinel's rollback window (sentinel.py) is a deque of device
clones of the program's state, taken before each step under
``FLAGS_health_action=rollback``: it dies with the process, so a
preempted job could only resume at its last full checkpoint even where
the window held later states.  This module folds the window into the
checkpoint (``fluid.incubate.checkpoint.AutoCheckpoint(sentinel=)``):

- **Offload off the step** (:class:`WindowPersister`): the training loop
  hands over references to the window's device clones (no copy, no
  sync); one worker thread copies them to the host and writes the ring,
  on a time cadence (FLAGS_rollback_persist_interval_s) or on demand (a
  full checkpoint's save, the preemption signal path, which write on
  the calling thread).  An offload that arrives while the worker is busy
  replaces the pending one: the persister never queues without bound
  and always writes the newest ring it was handed.
- **Temp+rename, manifest last**: the payload lands as a
  generation-stamped ``window-<gen>.npz`` named by
  ``window_manifest.json`` (format ``PTHWIN1``), each written to a temp
  name and renamed; the manifest's rename is the commit, and it names
  the exact payload written with it, so a kill at any instant leaves
  the previous (manifest, payload) pair whole.  A torn payload reads as
  absent.  Superseded generations and orphaned temps are swept after
  the commit (a failed unlink books
  ``pt_resilience_events_total{event="window_sweep_failures"}``).
- **Bit-exact re-arm**: :func:`load_window` and
  ``HealthSentinel.restore_state`` bring back the window entries
  (pre-step states), the ``@HEALTH@`` scope state (the dynamic loss
  scale resumes at its value before the kill) and the host detector
  state.  A restored value is copied into the scope's tensor where one
  of its shape and dtype is there, so a captured CUDA graph reads it on
  its next replay.

Tensors: the ring holds the scope's tensors as numpy arrays; a
bfloat16 tensor is kept as its raw 16-bit words and named in the
manifest's ``bfloat16`` list (numpy has no bfloat16).
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np
import torch

__all__ = ["WindowPersister", "save_window", "load_window",
           "manifest_step", "WINDOW_FORMAT"]

WINDOW_FORMAT = "PTHWIN1"
_MANIFEST = "window_manifest.json"
_PAYLOAD = "window.npz"
_META_KEYS = ("ema", "emvar", "good_samples", "bad_total_seen",
              "steps_seen", "keep")
_FLOAT_META = ("ema", "emvar", "bad_total_seen")


def _m_persists():
    from paddle_tpu_torch import observability as obs

    return obs.counter(
        "pt_rollback_window_persists_total",
        "Durable offloads of the health sentinel's rollback window "
        "(device-to-host copy + temp+rename write), by trigger",
        labels=("trigger",))


def _m_restores():
    from paddle_tpu_torch import observability as obs

    return obs.counter(
        "pt_rollback_window_restores_total",
        "Restarted processes that re-armed a persisted rollback window "
        "(AutoCheckpoint.resume past the last full checkpoint)")


def _host(v, bf16, key):
    """A window value as a numpy array (a bf16 tensor as its int16 words,
    its key added to ``bf16``)."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.dtype == torch.bfloat16:
            bf16.append(key)
            t = t.view(torch.int16)
        return t.cpu().numpy()
    return np.asarray(v)


def _to_tensor(arr, key, bf16):
    """A ring array back as a CPU tensor (bf16 where the manifest says)."""
    t = torch.from_numpy(np.array(arr, copy=True))
    return t.view(torch.bfloat16) if key in bf16 else t


def save_window(dirname, state, step, trigger="explicit", extra=None):
    """Write one sentinel state (``export_state``'s) as the durable ring:
    a generation-stamped payload first, then ``window_manifest.json``
    naming it, both temp+rename, the manifest's rename the commit.  The
    manifest must name the exact payload it was written with: a kill
    between two renames of one shared payload file would pair the old
    manifest's step with the new payload's state, and the restored job
    would run steps again on parameters that already hold them.
    ``extra`` (a JSON-able dict) rides in the manifest.  Returns the
    manifest."""
    os.makedirs(dirname, exist_ok=True)
    arrays, entries, bf16 = {}, [], []
    for i, snap in enumerate(state.get("window", ())):
        names = sorted(snap)
        entries.append(names)
        for j, n in enumerate(names):
            arrays[f"w{i}.{j}"] = _host(snap[n], bf16, f"w{i}.{j}")
    health = state.get("scope_health", {})
    health_names = sorted(health)
    for j, n in enumerate(health_names):
        arrays[f"h.{j}"] = _host(health[n], bf16, f"h.{j}")
    prev = _read_manifest(dirname)
    gen = (int(prev.get("generation", 0)) + 1) if prev else 1
    payload_name = f"window-{gen:012d}.npz"
    payload = os.path.join(dirname, payload_name)
    tmp = f"{payload}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, payload)
    manifest = {
        "format": WINDOW_FORMAT,
        "step": int(step),
        "generation": gen,
        "payload": payload_name,
        "time": time.time(),
        "entries": entries,           # each entry's var names, oldest first
        "health_names": health_names,
        "bfloat16": bf16,
        "meta": {k: (None if state.get(k) is None
                     else float(state[k]) if k in _FLOAT_META
                     else int(state[k])) for k in _META_KEYS},
        **({"extra": extra} if extra else {}),
    }
    mpath = os.path.join(dirname, _MANIFEST)
    tmp = f"{mpath}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, mpath)
    # committed: sweep superseded generations and orphaned temps, so
    # repeated preemption cannot fill the volume
    for name in os.listdir(dirname):
        if name in (payload_name, _MANIFEST):
            continue
        if name.startswith("window-") or ".tmp" in name:
            try:
                os.unlink(os.path.join(dirname, name))
            except OSError:
                from paddle_tpu_torch.distributed import resilience

                resilience.record("window_sweep_failures")
    _m_persists().labels(trigger=trigger).inc()
    return manifest


def _read_manifest(dirname):
    try:
        with open(os.path.join(dirname, _MANIFEST)) as f:
            m = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if m.get("format") != WINDOW_FORMAT:
        return None  # a format this code does not know reads as absent
    return m


def manifest_step(dirname):
    """The step stamped on the persisted ring (the step whose pre-state
    is the newest window entry), or None where no usable ring exists."""
    m = _read_manifest(dirname)
    return None if m is None else int(m["step"])


def load_window(dirname):
    """(state, manifest) that ``HealthSentinel.restore_state`` re-arms
    from (values as CPU tensors), or (None, None) when absent or torn: a
    torn ring is worse than none, so resume falls back to the last full
    checkpoint."""
    m = _read_manifest(dirname)
    if m is None:
        return None, None
    bf16 = set(m.get("bfloat16", ()))
    try:
        with np.load(os.path.join(dirname,
                                  m.get("payload", _PAYLOAD))) as z:
            window = [{n: _to_tensor(z[f"w{i}.{j}"], f"w{i}.{j}", bf16)
                       for j, n in enumerate(names)}
                      for i, names in enumerate(m["entries"])]
            scope_health = {n: _to_tensor(z[f"h.{j}"], f"h.{j}", bf16)
                            for j, n in enumerate(m["health_names"])}
    except (OSError, KeyError, ValueError, EOFError):
        return None, None
    return {"window": window, "scope_health": scope_health,
            **m.get("meta", {})}, m


class WindowPersister:
    """The offload pump between a live ``HealthSentinel`` and the ring on
    disk.  One worker thread, one pending slot: the per-step hook
    (:meth:`maybe_offload`) reads the clock and, when due, takes
    references; a busy worker means the next offload replaces the
    pending one."""

    def __init__(self, dirname, sentinel, interval_s=None):
        from paddle_tpu_torch.fluid import flags as _flags

        self.dirname = str(dirname)
        self.sentinel = sentinel
        self.interval_s = float(
            _flags.flag("rollback_persist_interval_s")
            if interval_s is None else interval_s)
        # reentrant: AutoCheckpoint's signal handler runs on the main
        # thread and calls save() -> offload(wait=True), maybe above a
        # frame inside offload() that holds this lock
        self._lock = threading.RLock()
        # orders the disk writes of the worker and of the synchronous
        # path by sequence; held only around save_window
        self._io_lock = threading.Lock()
        self._pending = None          # (state, step, trigger, seq, extra)
        self._seq = 0
        self._written_seq = 0
        self._wake = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._stop = False
        self._thread = None
        self._last = 0.0              # monotonic time of the last offload
        self.persisted_steps = 0

    def due(self):
        return (self.interval_s > 0
                and time.monotonic() - self._last >= self.interval_s)

    def maybe_offload(self, scope, step, extra=None):
        """The per-step hook: offload when the cadence has elapsed."""
        if self.due():
            self.offload(scope, step, trigger="interval", extra=extra)

    def offload(self, scope, step, trigger="explicit", wait=False,
                extra=None):
        """Offload the sentinel's current state.  ``wait=False`` queues it
        for the worker thread; ``wait=True`` writes it on the calling
        thread and returns with the ring on disk (the full checkpoint's
        save and the signal handler, which may run above a frame that
        holds ``self._lock``, so it must not wait on the worker)."""
        if self.sentinel is None:
            return False
        state = self.sentinel.export_state(scope)
        self._last = time.monotonic()
        if wait:
            with self._lock:
                self._seq += 1
                seq = self._seq
                self._pending = None  # older than this export
                self._idle.set()
            return self._write(state, int(step), trigger, seq, extra)
        with self._lock:
            self._seq += 1
            self._pending = (state, int(step), trigger, self._seq, extra)
            self._idle.clear()
            self._ensure_thread()
        self._wake.set()
        return True

    def _write(self, state, step, trigger, seq, extra=None):
        """One serialized disk write; an older payload never lands after
        a newer one."""
        with self._io_lock:
            if seq <= self._written_seq:
                return True
            try:
                save_window(self.dirname, state, step, trigger=trigger,
                            extra=extra)
            except Exception:  # a full disk must not end the training loop
                from paddle_tpu_torch.distributed import resilience

                resilience.record("window_persist_failures")
                return False
            self._written_seq = seq
            self.persisted_steps = step
        return True

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._run, name="pt-window-persist", daemon=True)
            self._thread.start()

    def _run(self):
        while True:
            self._wake.wait(timeout=1.0)
            with self._lock:
                item, self._pending = self._pending, None
                self._wake.clear()
                if item is None:
                    self._idle.set()
                    if self._stop:
                        return
                    continue
            self._write(*item)
            with self._lock:
                if self._pending is None:
                    self._idle.set()

    def close(self, flush=True):
        """Drain the pending offload (``flush``) and stop the worker."""
        if flush:
            self._idle.wait(timeout=60)
        with self._lock:
            self._stop = True
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def manifest_step(self):
        return manifest_step(self.dirname)

    def restore_into(self, scope, sentinel=None, rearm_scope=True):
        """Re-arm ``sentinel`` (default: this persister's) from the ring;
        with ``rearm_scope`` the newest window entry also becomes the
        scope's state (the resume past the checkpoint), copied into the
        scope's tensors.  Returns the manifest only when the scope was
        restored, else None: an empty ring (a skip-action run persists
        health state without entries) must never move the caller's
        resume step past state it did not restore.  The loss-scale and
        detector state are re-armed on either path."""
        sentinel = self.sentinel if sentinel is None else sentinel
        state, m = load_window(self.dirname)
        if state is None or sentinel is None:
            return None
        window = state["window"]
        restored_scope = False
        if rearm_scope and window:
            # the newest entry is the pre-state of manifest["step"]: it
            # becomes the live state (the caller runs that step again),
            # and the older entries re-arm the window
            for n, v in window[-1].items():
                sentinel.put(scope, n, v)
            state = dict(state, window=window[:-1])
            restored_scope = True
        sentinel.restore_state(state, scope, rearm_scope=rearm_scope)
        if not restored_scope:
            return None
        _m_restores().inc()
        return m
