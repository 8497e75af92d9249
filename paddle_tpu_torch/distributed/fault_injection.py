"""Deterministic fault injection (the port's copy of
``paddle_tpu/distributed/fault_injection.py``: a spec string parses to
the same rules in both packages).

A `FaultPlan` says exactly which RPC (the Nth of a command), which
training step or round, which served request or which decode step
fails, so recovery paths run reproducibly.  Plans come from code
(`install(FaultPlan(...))`) or from the environment (`PT_FAULT_PLAN`).
The port's serving fleet calls `on_serve` (the router's dispatch edge)
and `on_replica_step` (DecodeEngine's decode step); the RPC, step and
round hooks parse and fire as in the JAX package although no port lane
calls them yet, and the injected RPC errors derive from this module's
own `PSConnectionError` / `PSServerError` (the port has no PS runtime).

Spec grammar — semicolon-separated rules:

    drop:<cmd>:<n>            Nth RPC of <cmd> raises a connection error
                              BEFORE hitting the wire (a dropped packet;
                              the retry layer sees a transport failure)
    delay:<cmd>:<n>:<secs>    sleep <secs> before the Nth <cmd>
    error:<cmd>:<n>           Nth <cmd> raises a non-retryable server error
    flaky:<cmd>:<p>:<seed>    seeded Bernoulli drop of every <cmd> with
                              probability <p> (deterministic sequence)
    kill:step:<k>             SIGKILL this process when on_step(k) fires
                              (trainer loops call on_step per step)
    kill:round:<k>            SIGKILL when on_round(k) fires (the pserver
                              sync loop calls on_round per completed round)
    preempt:step:<k>          SIGTERM at step k — the GRACEFUL exit class
                              (a drain handler finishes the in-flight
                              round, snapshots, announces LEAVE, exits);
                              kill: stays the hard SIGKILL class
    preempt:round:<k>         SIGTERM after pserver sync round k
    join:step:<k>             fire the registered `join` membership hook
                              at step k (elastic scale-up choreography)
    join:round:<k>            ... at completed round k
    leave:step:<k>            fire the registered `leave` hook at step k
                              (graceful departure WITHOUT a signal)
    leave:round:<k>           ... at completed round k
    drill:<mode>:step:<k>[:<target>]
                              ORCHESTRATED recovery drill (read by a
                              recovery harness through drill_rules(),
                              never fired from on_step/on_rpc): at job step/
                              round <k> the DRILL HARNESS delivers the
                              signal to the target role and supervises
                              the relaunch, booking the recovery phases
                              into pt_recovery_seconds.  <mode> is
                              `preempt+restore` (SIGTERM — the graceful
                              drain class, harness respawns after the
                              drain) or `kill+restore` (SIGKILL — the
                              supervisor's restart budget relaunches).
                              <target> names a spawned role (e.g.
                              `trainer1`, `pserver0`); omitted = the
                              harness's default target.
    drill:<mode>:round:<k>[:<target>]
                              ... both spellings key on the WATCHED
                              pserver round counter (sync-lane trainer
                              steps advance in lockstep with rounds;
                              the harness cannot observe a trainer's
                              private step count from outside)
    nan:grad:step:<k>         NUMERIC fault class (health sentinel):
                              corrupt one raw
                              parameter gradient to NaN INSIDE the
                              compiled step, at exactly the k-th
                              executed step of the health-transpiled
                              program (1-based; counted by an in-graph
                              countdown, so it is deterministic under
                              step chains and does not re-fire on a
                              rollback replay)
    inf:grad:step:<k>         same, +Inf
    nan:loss:step:<k>         corrupt the LOSS value (the gradient path
    inf:loss:step:<k>         stays clean — exercises the host-side
                              loss detector, not the found_inf scalar)
    spike:loss:step:<k>[:<x>] multiply the loss by <x> (default 1000)
                              at step k — the loss-spike detector's
                              deterministic trigger
    serve_error:<model>:req:<n>
                              SERVING class (serving/router.py): the Nth
                              serve request for <model> (or `*`) raises
                              an injected server error at the router's
                              dispatch edge (`on_serve(model)`) — the
                              deterministic breaker/retry trigger.
                              Counts are per model name.
    serve_delay:<model>:req:<n>:<ms>
                              sleep <ms> milliseconds before the Nth
                              serve request for <model> — the
                              deterministic hedge trigger (a slow
                              primary loses to its hedge)
    replica_kill:step:<n>     kill the DECODE SCHEDULER of whichever
                              replica's decode-step counter reaches
                              <n> first: `on_replica_step(name, step)`
                              (called by DecodeEngine inside each
                              decode step) raises a fatal injected
                              error, the scheduler fans it to every
                              live future (`_fail_all`) and dies — the
                              router observes the death and fails the
                              victim sequences over, exactly the
                              mid-decode death class the serve drill
                              measures
    replica_kill:<name>:step:<n>
                              same, but only the replica whose engine
                              name is <name>

Numeric rules are declarative: they do not fire from on_rpc/on_step; a
health sentinel reads them through `numeric_rules()` when a runner
builds its program (the port has no health sentinel yet).

`<cmd>` is an RPC name (send_grad, get_param, send_barrier, fetch_barrier,
send_param, lookup_rows, checkpoint_notify, stop, lease, join, leave,
commit_epoch) or
`*`.  Counts are 1-based and per-process; a retried RPC re-enters the
count, so `drop:...:3` fails exactly one attempt and the retry succeeds.

The join:/leave: actions dispatch to hooks a trainer loop registers via
`set_membership_hooks(join=fn, leave=fn)` (each called with the step or
round number); without a registered hook they are no-ops, so one
PT_FAULT_PLAN can choreograph an elastic scenario in whatever runner
replays it.

The supervisor strips PT_FAULT_PLAN (and sets PADDLE_RESTART_COUNT) when it
relaunches a child, so faults are injected once per job, not once per
incarnation.
"""

from __future__ import annotations

import os
import random
import signal
import sys
import threading

__all__ = ["FaultPlan", "FaultInjected", "InjectedServeError",
           "InjectedReplicaDeath", "PSConnectionError", "PSServerError",
           "install", "uninstall", "active", "on_rpc", "on_step",
           "on_round", "on_serve", "on_replica_step",
           "set_membership_hooks"]

# lifecycle actions fired from on_step/on_round (vs per-RPC actions)
_LIFECYCLE = ("kill", "preempt", "join", "leave")
# declarative numeric-fault actions consumed by the health sentinel's
# program transpile (never fired from on_rpc/on_step/on_round)
_NUMERIC = ("nan", "inf", "spike")
# orchestrated recovery drills read through drill_rules()
# (never fired from the runtime hooks — the harness owns the signal)
_DRILL_MODES = ("preempt+restore", "kill+restore")
# serving-class actions fired from on_serve/on_replica_step (the router
# dispatch edge and the decode step), never from on_rpc
_SERVING = ("serve_error", "serve_delay", "replica_kill")

_ENV = "PT_FAULT_PLAN"


class FaultInjected(IOError):
    """Marker base for injected failures (also lets tests tell an injected
    fault from a real one)."""


class InjectedServeError(FaultInjected):
    """`serve_error:` rule fired at the router's dispatch edge — the
    serving analog of `_server_error` (non-retryable; the breaker counts
    it as a replica failure)."""


class InjectedReplicaDeath(FaultInjected):
    """`replica_kill:` rule fired inside a decode step — fatal to the
    replica's scheduler thread (fanned to every live future), simulating
    mid-decode replica death without losing the test process."""


class _Rule:
    __slots__ = ("action", "cmd", "n", "arg", "_rng")

    def __init__(self, action, cmd, n, arg=None):
        self.action = action
        self.cmd = cmd
        self.n = n
        self.arg = arg
        self._rng = (random.Random(int(arg) if arg is not None else 0)
                     if action == "flaky" else None)

    def __repr__(self):
        return f"_Rule({self.action}:{self.cmd}:{self.n}" + (
            f":{self.arg})" if self.arg is not None else ")")


class PSError(IOError):
    """Base of the RPC failures an injected RPC fault raises."""


class PSConnectionError(PSError):
    """Transport broken / peer unreachable: retryable."""


class PSServerError(PSError):
    """The server answered with an error status: not retryable."""


def _conn_error(msg):
    err = type("InjectedConnectionError",
               (FaultInjected, PSConnectionError), {})
    return err(msg)


def _server_error(msg):
    err = type("InjectedServerError", (FaultInjected, PSServerError), {})
    return err(msg)


class FaultPlan:
    """A parsed, counting fault plan.  Thread-safe; counters are
    per-process."""

    def __init__(self, spec=""):
        self.spec = spec or ""
        self._lock = threading.Lock()
        self._counts = {}
        self.rules = []
        for part in self.spec.split(";"):
            part = part.strip()
            if not part:
                continue
            bits = part.split(":")
            action = bits[0]
            if action in ("drop", "error") and len(bits) == 3:
                self.rules.append(_Rule(action, bits[1], int(bits[2])))
            elif action == "delay" and len(bits) == 4:
                self.rules.append(
                    _Rule(action, bits[1], int(bits[2]), float(bits[3])))
            elif action == "flaky" and len(bits) == 4:
                self.rules.append(
                    _Rule(action, bits[1], float(bits[2]), bits[3]))
            elif action in _LIFECYCLE and len(bits) == 3 and \
                    bits[1] in ("step", "round"):
                self.rules.append(_Rule(action, bits[1], int(bits[2])))
            elif action in _NUMERIC and len(bits) in (4, 5) and \
                    bits[1] in ("grad", "loss") and bits[2] == "step":
                self.rules.append(_Rule(
                    action, bits[1], int(bits[3]),
                    float(bits[4]) if len(bits) == 5 else None))
            elif action == "drill" and len(bits) in (4, 5) and \
                    bits[1] in _DRILL_MODES and bits[2] in ("step", "round"):
                self.rules.append(_Rule(
                    "drill", bits[2], int(bits[3]),
                    (bits[1], bits[4] if len(bits) == 5 else None)))
            elif action == "serve_error" and len(bits) == 4 and \
                    bits[2] == "req":
                self.rules.append(_Rule(action, bits[1], int(bits[3])))
            elif action == "serve_delay" and len(bits) == 5 and \
                    bits[2] == "req":
                self.rules.append(
                    _Rule(action, bits[1], int(bits[3]), float(bits[4])))
            elif action == "replica_kill" and len(bits) == 3 and \
                    bits[1] == "step":
                self.rules.append(_Rule(action, "*", int(bits[2])))
            elif action == "replica_kill" and len(bits) == 4 and \
                    bits[2] == "step":
                self.rules.append(_Rule(action, bits[1], int(bits[3])))
            else:
                raise ValueError(f"bad fault rule {part!r} in {spec!r}")

    @classmethod
    def from_env(cls, env=_ENV):
        return cls(os.environ.get(env, ""))

    def _record(self):
        from paddle_tpu_torch.distributed import resilience
        resilience.record("injected_faults")

    def on_rpc(self, cmd_name):
        """Called by the RPC client before each attempt; may sleep or
        raise.  A retried attempt counts again."""
        if not self.rules:
            return
        with self._lock:
            n = self._counts[cmd_name] = self._counts.get(cmd_name, 0) + 1
            fire = [r for r in self.rules
                    if r.cmd in (cmd_name, "*") and
                    r.action not in _LIFECYCLE and
                    r.action not in _NUMERIC and
                    r.action not in _SERVING and
                    (r.action == "flaky" or r.n == n)]
        for r in fire:
            if r.action == "flaky":
                if r._rng.random() >= r.n:  # n is the probability here
                    continue
                self._record()
                raise _conn_error(
                    f"fault-injection: flaky-dropped {cmd_name} rpc")
            if r.action == "delay":
                self._record()
                import time
                time.sleep(r.arg)
            elif r.action == "drop":
                self._record()
                raise _conn_error(
                    f"fault-injection: dropped {cmd_name} rpc #{r.n}")
            elif r.action == "error":
                self._record()
                raise _server_error(
                    f"fault-injection: injected server error on "
                    f"{cmd_name} rpc #{r.n}")

    def _fire_lifecycle(self, kind, k):
        for r in self.rules:
            if r.cmd != kind or r.n != int(k) or r.action not in _LIFECYCLE:
                continue
            if r.action == "kill":
                # observability: allow — last words before SIGKILL
                print(f"fault-injection: SIGKILL pid {os.getpid()} at "
                      f"{kind} {k}", file=sys.stderr, flush=True)
                os.kill(os.getpid(), signal.SIGKILL)
            elif r.action == "preempt":
                # the graceful class: SIGTERM, so an installed drain
                # handler (distributed.elastic.DrainHandler) finishes the
                # in-flight round, snapshots, LEAVEs, then exits
                self._record()
                # observability: allow — deterministic-preemption banner
                print(f"fault-injection: SIGTERM pid {os.getpid()} at "
                      f"{kind} {k}", file=sys.stderr, flush=True)
                os.kill(os.getpid(), signal.SIGTERM)
            else:  # join / leave → registered membership hooks
                hook = _hooks.get(r.action)
                if hook is not None:
                    self._record()
                    hook(int(k))

    def _maybe_kill(self, kind, k):  # old name kept for callers/tests
        self._fire_lifecycle(kind, k)

    def drill_rules(self):
        """The orchestrated recovery-drill rules (recovery-harness class):
        [{"mode": preempt+restore|kill+restore, "at": step|round,
        "n": k, "target": role-or-None}], in spec order.  Consumed by
        a recovery harness, never fired from the runtime
        hooks — the harness owns signal delivery so the kill instant is
        a measured anchor, not a guess."""
        return [{"mode": r.arg[0], "at": r.cmd, "n": r.n,
                 "target": r.arg[1]}
                for r in self.rules if r.action == "drill"]

    def numeric_rules(self):
        """The declarative numeric-fault rules (health sentinel class):
        [{"kind": nan|inf|spike, "target": grad|loss, "step": k,
        "scale": x|None}], in spec order.  Consumed at program-build
        time by a health sentinel, not fired from the runtime hooks."""
        return [{"kind": r.action, "target": r.cmd, "step": r.n,
                 "scale": r.arg}
                for r in self.rules if r.action in _NUMERIC]

    def on_serve(self, model):
        """Serving-side hook: the router calls this once per request it
        dispatches for `model` (and the promotion prober once per probe).
        May sleep (`serve_delay`) or raise (`serve_error`).  Counts are
        1-based and per model name; `*` rules match every model but
        still count per model."""
        rules = [r for r in self.rules if r.action in ("serve_error",
                                                       "serve_delay")]
        if not rules:
            return
        key = f"serve::{model}"
        with self._lock:
            n = self._counts[key] = self._counts.get(key, 0) + 1
            fire = [r for r in rules
                    if r.cmd in (model, "*") and r.n == n]
        for r in fire:
            self._record()
            if r.action == "serve_delay":
                import time
                time.sleep(r.arg / 1000.0)
            else:
                raise InjectedServeError(
                    f"fault-injection: injected serve error on "
                    f"{model} request #{r.n}")

    def on_replica_step(self, name, step):
        """Decode-replica hook: `DecodeEngine` calls this inside each
        decode step with its engine name and 1-based step count.  A
        matching `replica_kill` rule raises `InjectedReplicaDeath` —
        the scheduler's fan-out (`_fail_all`) turns it into exactly the
        mid-decode replica death the router must fail over."""
        for r in self.rules:
            if r.action != "replica_kill":
                continue
            if r.cmd not in (name, "*") or r.n != int(step):
                continue
            self._record()
            raise InjectedReplicaDeath(
                f"fault-injection: replica {name!r} killed at decode "
                f"step {step}")

    def on_step(self, step):
        """Trainer-side hook: call once per training step."""
        self._fire_lifecycle("step", step)

    def on_round(self, rnd):
        """Pserver-side hook: the sync serve loop calls this after each
        completed round (absolute round id, snapshot-continuous)."""
        self._fire_lifecycle("round", rnd)


_plan = None
_plan_resolved = False
_plan_lock = threading.Lock()
_hooks: dict = {"join": None, "leave": None}


def set_membership_hooks(join=None, leave=None):
    """Register the callables `join:`/`leave:` rules dispatch to (each
    receives the step/round number).  A trainer loop wires these to its
    elastic join/leave so one PT_FAULT_PLAN replays a whole membership
    scenario deterministically.  Pass None to clear."""
    _hooks["join"] = join
    _hooks["leave"] = leave


def install(plan):
    """Install `plan` (a FaultPlan or spec string) for this process."""
    global _plan, _plan_resolved
    with _plan_lock:
        _plan = FaultPlan(plan) if isinstance(plan, str) else plan
        _plan_resolved = True
    return _plan


def uninstall():
    global _plan, _plan_resolved
    with _plan_lock:
        _plan = None
        _plan_resolved = True


def active():
    """The process's fault plan: the installed one, else PT_FAULT_PLAN
    (resolved once), else None."""
    global _plan, _plan_resolved
    with _plan_lock:
        if not _plan_resolved:
            spec = os.environ.get(_ENV, "")
            _plan = FaultPlan(spec) if spec else None
            _plan_resolved = True
        return _plan


def on_rpc(cmd_name):
    p = active()
    if p is not None:
        p.on_rpc(cmd_name)


def on_step(step):
    p = active()
    if p is not None:
        p.on_step(step)


def on_round(rnd):
    p = active()
    if p is not None:
        p.on_round(rnd)


def on_serve(model):
    p = active()
    if p is not None:
        p.on_serve(model)


def on_replica_step(name, step):
    p = active()
    if p is not None:
        p.on_replica_step(name, step)
