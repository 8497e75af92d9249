"""The response to a bad step (counterpart of
``paddle_tpu/health/sentinel.py``): raise | skip | rollback.

The step itself already found the bad gradient and masked its state
writes (transpile.py, gating.py).  The ``HealthSentinel`` is the host
side of one runner: it reads the two scalars the step left
(``@HEALTH@found_inf``, and ``@HEALTH@bad_steps_total`` after a
run_steps chain or a bad step), runs the loss-spike detector over the
fetched loss (a z-score against its EMA), books ``pt_health_*`` and
acts:

  raise     RuntimeError naming the step: the FLAGS_check_nan_inf
            contract, from one scalar instead of a scan of every tensor.
  skip      a non-finite step was masked inside the step (the loss
            scale already halved); it is booked and training goes on.
            A spike under skip is booked and its update stands.
  rollback  restore the parameters and optimizer state from the rolling
            window of device clones (FLAGS_health_rollback_keep steps
            deep) and replay the same feed.  The fault countdowns are
            health state, so a planted fault does not fire again on the
            replay; the executor runs the replay at the same step (the
            same random draws, dropout's included) and counts the step
            once, so the run equals one that never met the fault.  A
            replay that is bad again is skipped.

The window's snapshots are device clones taken before each step, only
under ``rollback``; a restore copies them back into the scope's tensors
in place, so a captured graph goes on reading the same storage.
``export_state`` and ``restore_state`` carry the window, the
``@HEALTH@`` state and the detector's state across a restart
(health/persist.py, the durable window).
"""

from __future__ import annotations

import collections

import numpy as np
import torch

__all__ = ["HealthSentinel", "attach", "run_guarded"]

_ACTIONS = ("raise", "skip", "rollback")
_EMA_BETA = 0.9
_EPS = 1e-12


def _m_bad_steps():
    from paddle_tpu_torch import observability as obs

    return obs.counter(
        "pt_health_bad_steps_total",
        "Training steps the health sentinel flagged, by detection kind "
        "(grad=non-finite gradient, loss=non-finite loss, "
        "spike=loss-spike z-score) and the action applied",
        labels=("kind", "action"))


def _m_rollbacks():
    from paddle_tpu_torch import observability as obs

    return obs.counter(
        "pt_health_rollbacks_total",
        "State restores performed by the health sentinel's rollback "
        "action (each followed by a same-feed replay)")


def _m_loss_scale():
    from paddle_tpu_torch import observability as obs

    return obs.gauge(
        "pt_health_loss_scale",
        "Live dynamic loss scale (@HEALTH@loss_scale) observed after "
        "the most recent step, per runner lane", labels=("lane",))


def run_guarded(sentinel, scope, fetch_names, attempt, chain=False):
    """The sentinel's step protocol: seed the health state, snapshot,
    run one ``attempt()`` (the runner's dispatch of the step, or of a
    run_steps chain with ``chain``), evaluate it, and run it once more
    when the sentinel rolled back.  ``attempt()`` itself when
    ``sentinel`` is None."""
    if sentinel is None:
        return attempt()
    for _try in range(2):
        sentinel.ensure_state(scope)
        sentinel.pre_step(scope)
        fetches = attempt()
        if sentinel.post_step(scope, fetch_names, fetches,
                              chain=chain) != "replay":
            break
        from paddle_tpu_torch.observability import profiling as _profiling

        _profiling.flight_recorder().record(
            {"kind": "health", "event": "rollback_replay",
             "lane": sentinel.lane})
    return fetches


def attach(program, loss_name=None, lane="default", enable=None,
           device=None):
    """The hook a runner calls once a program: with FLAGS_health_sentinel
    on (or ``enable``), insert the sentinel into ``program`` (idempotent)
    and return a HealthSentinel whose health state lives on ``device``;
    None when it is off or the program has nothing to guard."""
    from paddle_tpu_torch.fluid import flags as _flags

    if enable is None:
        enable = _flags.flag("health_sentinel")
    if not enable:
        return None
    from .transpile import insert_health_sentinel

    plan = insert_health_sentinel(program, loss_name=loss_name)
    if plan is None:
        return None
    return HealthSentinel(program, lane=lane, device=device)


class HealthSentinel:
    """The host side of one runner; see the module docstring.

    The runner's protocol (``run_guarded``)::

        for _attempt in range(2):
            sent.ensure_state(scope)
            sent.pre_step(scope)
            out = <run one step, or one chain>
            if sent.post_step(scope, fetch_names, out) != "replay":
                break
    """

    def __init__(self, program, lane="default", action=None, keep=None,
                 spike_zscore=None, spike_warmup=None, device=None):
        from paddle_tpu_torch.fluid import flags as _flags

        self.program = program
        self.plan = program._health_plan
        self.lane = lane
        self.device = torch.device(device if device is not None else "cpu")
        self.action = action or _flags.flag("health_action")
        if self.action not in _ACTIONS:
            raise ValueError(
                f"FLAGS_health_action must be one of {_ACTIONS}, got "
                f"{self.action!r}")
        self.keep = max(1, int(keep if keep is not None
                               else _flags.flag("health_rollback_keep")))
        self.spike_zscore = float(
            spike_zscore if spike_zscore is not None
            else _flags.flag("health_spike_zscore"))
        self.spike_warmup = int(
            spike_warmup if spike_warmup is not None
            else _flags.flag("health_spike_warmup"))
        self._window = collections.deque(maxlen=self.keep)
        self._ema = None
        self._emvar = 0.0
        self._good_samples = 0
        self._replaying = False
        self._bad_total_seen = 0.0
        self._cum_scope = None  # the scope the seen-count is synced to
        self._snapshot_names = None
        self._steps_seen = 0

    # -- state -----------------------------------------------------------
    def ensure_state(self, scope):
        """Seed the ``@HEALTH@`` variables the program reads (loss scale,
        counts, fault countdowns) as tensors on the sentinel's device,
        where the scope lacks them; sync the bad-step baseline to this
        scope's total, so a fresh sentinel on a scope with history books
        no phantom bad step."""
        for name, default in self.plan["state"].items():
            if scope.get(name) is None:
                scope.set(name, torch.as_tensor(
                    np.array(default, copy=True), device=self.device))
        if self._cum_scope is not scope:
            self._cum_scope = scope
            cum = self._scalar(scope, self.plan["bad_total_var"])
            self._bad_total_seen = cum if cum is not None else 0.0

    def _stateful_names(self, scope):
        """The program's persistables present in the scope — parameters,
        optimizer state, batch-norm statistics — without the health
        state (a restore must not undo the scale's halving or re-arm a
        fired fault)."""
        if self._snapshot_names is None:
            from .transpile import HEALTH_PREFIX

            block = self.program.global_block()
            self._snapshot_names = [
                n for n, v in block.vars.items()
                if v.persistable and not n.startswith(HEALTH_PREFIX)]
        return [n for n in self._snapshot_names
                if isinstance(scope.get(n), torch.Tensor)]

    def pre_step(self, scope):
        """Push a snapshot (device clones) onto the rolling window; only
        under ``rollback``."""
        if self.action != "rollback":
            return
        with torch.no_grad():
            self._window.append({n: scope.get(n).clone()
                                 for n in self._stateful_names(scope)})

    def restore(self, scope):
        """Restore the newest snapshot (the state before the step being
        rolled back), in place where the scope's tensor still fits it;
        a second restore in a row walks one entry deeper."""
        if not self._window:
            return False
        snap = self._window.pop()
        with torch.no_grad():
            for n, v in snap.items():
                cur = scope.get(n)
                if (isinstance(cur, torch.Tensor) and cur.shape == v.shape
                        and cur.dtype == v.dtype and cur.device == v.device):
                    cur.copy_(v)
                else:
                    scope.set(n, v)
        _m_rollbacks().inc()
        return True

    # -- the durable window (health/persist.py, AutoCheckpoint) ---------
    def export_state(self, scope):
        """What a restarted process needs to re-arm this sentinel bit for
        bit: the rollback window (references to its device clones: no
        copy under the step loop; persist.py's worker copies them to the
        host), device clones of the ``@HEALTH@`` scope state (loss
        scale, counts, fault countdowns) and the host detector's state
        (loss EMA, warm-up count, the bad-step baseline)."""
        names = set(self.plan["state"]) | {
            self.plan["found_var"], self.plan["scale_var"],
            self.plan["bad_total_var"]}
        health = {}
        with torch.no_grad():
            for n in sorted(names):
                v = scope.get(n)
                if isinstance(v, torch.Tensor):
                    health[n] = v.detach().clone()
                elif v is not None:
                    health[n] = np.array(v, copy=True)
        return {
            "window": [dict(snap) for snap in self._window],
            "scope_health": health,
            "ema": self._ema,
            "emvar": self._emvar,
            "good_samples": self._good_samples,
            "bad_total_seen": self._bad_total_seen,
            "steps_seen": self._steps_seen,
            "keep": self.keep,
        }

    def put(self, scope, name, value):
        """Put a restored value into the scope: copied into the scope's
        tensor where it has the same shape and dtype (a captured graph
        reads that storage), else as a tensor on the sentinel's
        device."""
        src = value if isinstance(value, torch.Tensor) \
            else torch.as_tensor(np.array(value, copy=True))
        cur = scope.get(name)
        with torch.no_grad():
            if isinstance(cur, torch.Tensor) and cur.shape == src.shape \
                    and cur.dtype == src.dtype:
                cur.copy_(src)
            else:
                scope.set(name, src.to(self.device, copy=True))

    def restore_state(self, state, scope, rearm_scope=True):
        """Re-arm from an ``export_state`` payload (as persist.py loads
        it): the window oldest to newest (its entries stay valid
        pre-step states, so a rollback after the restart can walk past a
        bad step from before the kill), with ``rearm_scope`` the
        ``@HEALTH@`` scope state (the loss scale resumes where it was),
        and the detector's state.  Returns the window's depth."""
        with torch.no_grad():
            self._window = collections.deque(
                ({n: (v if isinstance(v, torch.Tensor)
                      else torch.as_tensor(np.array(v, copy=True)))
                  .to(self.device, copy=True) for n, v in snap.items()}
                 for snap in state.get("window", ())), maxlen=self.keep)
        if rearm_scope:
            for n, v in state.get("scope_health", {}).items():
                self.put(scope, n, v)
        ema = state.get("ema")
        self._ema = None if ema is None else float(ema)
        self._emvar = float(state.get("emvar", 0.0))
        self._good_samples = int(state.get("good_samples", 0))
        self._bad_total_seen = float(state.get("bad_total_seen", 0.0))
        self._steps_seen = int(state.get("steps_seen", 0))
        # with rearm_scope the baseline above is the restored scope's
        # bad_steps_total, which ensure_state must not re-sync away;
        # without it (a ring older than the restored checkpoint) it must
        # re-sync, or the first step would book the difference as bad
        # steps
        self._cum_scope = scope if rearm_scope else None
        return len(self._window)

    # -- scalar reads ----------------------------------------------------
    @staticmethod
    def _scalar(scope, name):
        v = scope.get(name)
        if v is None:
            return None
        if isinstance(v, torch.Tensor):
            return float(v.reshape(-1)[0])
        return float(np.asarray(v).reshape(-1)[0])

    def _loss_value(self, fetch_names, fetches):
        loss_var = self.plan.get("loss_var")
        if not loss_var or not fetch_names:
            return None
        for n, v in zip(fetch_names, fetches):
            if n == loss_var:
                try:
                    if isinstance(v, torch.Tensor):
                        return float(v.detach().float().mean())
                    return float(np.mean(np.asarray(v, np.float32)))
                except (TypeError, ValueError):
                    return None
        return None

    # -- the decision ----------------------------------------------------
    def _classify(self, scope, loss, chain):
        """(kind, events) of the step, (None, 0) when healthy.  After a
        chain the bad-step total is read (only the last iteration's
        found_inf reaches the host); after one step found_inf alone
        answers, and the total is read only when it fired."""
        found = self._scalar(scope, self.plan["found_var"])
        delta = 0
        if chain or (found is not None and found > 0):
            cum = self._scalar(scope, self.plan["bad_total_var"])
            if cum is not None:
                delta = max(0, int(round(cum - self._bad_total_seen)))
                self._bad_total_seen = cum
        if delta or (found is not None and found > 0):
            return "grad", max(1, delta)
        if loss is not None and not np.isfinite(loss):
            return "loss", 1
        if (loss is not None and self.spike_zscore > 0
                and self._ema is not None
                and self._good_samples >= self.spike_warmup):
            z = abs(loss - self._ema) / ((self._emvar + _EPS) ** 0.5)
            if z > self.spike_zscore:
                return "spike", 1
        return None, 0

    def _observe_good(self, loss):
        self._good_samples += 1
        if loss is None:
            return
        if self._ema is None:
            self._ema, self._emvar = loss, 0.0
            return
        dev = loss - self._ema
        self._ema += (1.0 - _EMA_BETA) * dev
        self._emvar = _EMA_BETA * (self._emvar
                                   + (1.0 - _EMA_BETA) * dev * dev)

    def post_step(self, scope, fetch_names=None, fetches=None,
                  chain=False):
        """Evaluate the step (with ``chain``, the run_steps chain) that
        just ran: "ok", "skip" or "replay" (the caller runs the same
        feed once more); under ``raise`` a bad step raises RuntimeError
        naming it."""
        self._steps_seen += 1
        loss = self._loss_value(fetch_names, fetches or [])
        if self.plan.get("loss_scaling"):
            scale = self._scalar(scope, self.plan["scale_var"])
            if scale is not None:
                _m_loss_scale().labels(lane=self.lane).set(scale)
        kind, n_events = self._classify(scope, loss, chain)
        replaying, self._replaying = self._replaying, False
        if kind is None:
            self._observe_good(loss)
            return "ok"
        _m_bad_steps().labels(kind=kind, action=self.action).inc(
            max(1, n_events))
        # the flight recorder's evidence: the bad step lands in its ring
        # and dumps the postmortem
        from paddle_tpu_torch.observability import events
        from paddle_tpu_torch.observability import profiling as _profiling

        _profiling.note_health_event(kind, self.action, self.lane,
                                     step=self._steps_seen,
                                     replay=replaying)
        if events.enabled():
            events.emit("health_bad_step", kind=kind, action=self.action,
                        lane=self.lane, step=self._steps_seen,
                        loss=loss, replay=replaying)
        if self.action == "raise":
            raise RuntimeError(
                f"health sentinel: non-finite/anomalous step detected at "
                f"step {self._steps_seen} (kind={kind}, lane={self.lane}) "
                f"— FLAGS_health_action=raise preserves the "
                f"FLAGS_check_nan_inf fail-fast contract")
        if self.action == "rollback" and not replaying:
            if self.restore(scope):
                self._replaying = True
                return "replay"
        return "skip"
