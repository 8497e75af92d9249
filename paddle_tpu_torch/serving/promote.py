"""Canary weight promotion with automatic rollback (counterpart of
``paddle_tpu/serving/promote.py``).

A checkpoint's parameters are published into a running decode replica
group one replica at a time, the canary first, with a probe window
between steps and a rollback when a gate fails.  A replica's sequence:

  hold      ``router.set_held(name)``: out of rotation; live traffic
            goes to the other replicas
  quiesce   wait for its live sequences to finish
  swap      copy its current values out (``capture_weights``), then
            ``WeightSet.apply`` the new ones under its ``_exec_lock``
  probe     greedy-decode the probe prompts on it and gate on the error
            rate, the latency against its own pre-swap probes and the
            token drift against its pre-swap streams (a
            ``serve_error:<replica>`` FaultPlan rule plants a regression)
  verdict   pass: release the hold and go on; fail: apply the old values
            back, release the hold, book
            ``pt_serve_promotions_total{outcome="rolled_back"}`` and
            stop.  All replicas through: one ``{outcome="promoted"}``.

A swap costs no capture: the scope's tensors are the storage a replica's
captured decode graphs read, and ``apply`` copies the new values into
them in place (``_ScopeBinding.adopt`` would otherwise copy a replaced
tensor in at the next replay), so ``pt_compile_cache_total`` misses stay
flat.  For the same reason ``capture_weights`` copies the values out:
a set of references into the scope would hold the new weights after the
swap, and a rollback would restore nothing.

As in the JAX package the drift gate compares greedy token streams, so
it sees a change of distribution only where the argmax flips.
"""

from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["WeightSet", "PromotionGates", "promote", "capture_weights"]


def _m_promotions():
    from paddle_tpu_torch import observability as obs

    return obs.counter(
        "pt_serve_promotions_total",
        "Canary weight promotions by outcome: `promoted` (gates passed "
        "on every replica, whole group converged on the new weights) "
        "vs `rolled_back` (a probe gate failed; the canary's old "
        "arrays were restored)", labels=("router", "outcome"))


def _copy(value):
    if isinstance(value, torch.Tensor):
        return value.detach().clone()
    return torch.from_numpy(np.array(value, copy=True))


class WeightSet:
    """Named parameter values, the unit a promotion publishes: copies,
    never references (``arrays``: {name: tensor}).  Build one
    ``from_scope`` (a trainer's live parameters, or a scope a checkpoint
    was loaded into) or from a {name: tensor or ndarray} dict.
    ``apply(scope)`` writes them into the scope's tensors in place, so
    programs, plans and captured graphs are untouched."""

    def __init__(self, arrays):
        self.arrays = {str(k): _copy(v) for k, v in arrays.items()}

    @classmethod
    def from_scope(cls, scope, names):
        missing = [n for n in names if scope.get(n) is None]
        if missing:
            raise KeyError(
                f"WeightSet.from_scope: {len(missing)} names not in "
                f"scope (first: {missing[:3]})")
        return cls({n: scope.get(n) for n in names})

    def names(self):
        return sorted(self.arrays)

    def apply(self, scope):
        """Write each value into ``scope``: into its tensor in place
        where the shape matches (on that tensor's device, in its dtype),
        else as a new tensor on the device and in the dtype of the one
        it replaces."""
        with torch.no_grad():
            for n, a in self.arrays.items():
                cur = scope.get(n)
                if not isinstance(cur, torch.Tensor):
                    scope.set(n, a.clone())
                elif cur.shape == a.shape:
                    cur.copy_(a)
                else:
                    scope.set(n, a.to(cur.device, cur.dtype))

    def __len__(self):
        return len(self.arrays)


def capture_weights(scope, names):
    """Copy ``names`` out of ``scope`` as a WeightSet (the rollback's
    save, or a trainer publishing its current parameters)."""
    return WeightSet.from_scope(scope, names)


class PromotionGates:
    """The canary verdict thresholds.

    max_error_rate     fraction of probe requests that may fail
                       (default 0.0 — any probe error rolls back)
    max_latency_ratio  canary mean probe latency / pre-swap mean probe
                       latency ceiling (None = don't gate; the default
                       8.0 is lenient — it catches a pathological swap,
                       not noise)
    max_drift          fraction of probe TOKENS that may differ from
                       the pre-swap streams (None = don't gate — the
                       right setting when the new weights are a real
                       training delta; 0.0 gates a same-weights
                       republish bit-exact)
    """

    def __init__(self, max_error_rate=0.0, max_latency_ratio=8.0,
                 max_drift=None):
        self.max_error_rate = float(max_error_rate)
        self.max_latency_ratio = (None if max_latency_ratio is None
                                  else float(max_latency_ratio))
        self.max_drift = None if max_drift is None else float(max_drift)

    def verdict(self, probe, baseline):
        """(ok, reasons) for a post-swap `probe` vs the pre-swap
        `baseline` (both from `_run_probes`)."""
        reasons = []
        if probe["error_rate"] > self.max_error_rate:
            reasons.append(
                f"error_rate {probe['error_rate']:.3f} > "
                f"{self.max_error_rate:.3f}")
        if self.max_latency_ratio is not None \
                and baseline["mean_latency_s"] > 0:
            ratio = probe["mean_latency_s"] / baseline["mean_latency_s"]
            if ratio > self.max_latency_ratio:
                reasons.append(
                    f"latency ratio {ratio:.2f} > "
                    f"{self.max_latency_ratio:.2f}")
        if self.max_drift is not None:
            drift = _token_drift(baseline["streams"], probe["streams"])
            if drift > self.max_drift:
                reasons.append(
                    f"token drift {drift:.3f} > {self.max_drift:.3f}")
        return not reasons, reasons


def _token_drift(ref_streams, new_streams):
    """Fraction of positions where the greedy streams disagree (a
    failed probe counts every position as drifted)."""
    total = mismatch = 0
    for ref, new in zip(ref_streams, new_streams):
        if ref is None or new is None:
            n = max(len(ref or ()), len(new or ()), 1)
            total += n
            mismatch += n
            continue
        n = max(len(ref), len(new))
        total += max(n, 1)
        mismatch += sum(1 for i in range(n)
                        if i >= len(ref) or i >= len(new)
                        or ref[i] != new[i])
    return mismatch / max(total, 1)


def _run_probes(rep, prompts, max_new_tokens, timeout_s):
    """Greedy-decode every probe prompt directly on `rep` (bypassing
    the router — the canary is held out of rotation).  Each probe
    passes the `fault_injection.on_serve` gate under the REPLICA name,
    so a `serve_error:<replica>:req:N` rule lands deterministically in
    this window."""
    from paddle_tpu_torch.distributed import fault_injection as _fault

    streams, latencies, errors = [], [], 0
    for prompt in prompts:
        t0 = time.monotonic()
        try:
            _fault.on_serve(rep.name)
            fut = rep.engine.submit(prompt, max_new_tokens)
            streams.append(list(fut.result(timeout=timeout_s)))
            latencies.append(time.monotonic() - t0)
        except Exception:
            errors += 1
            streams.append(None)
    return {
        "streams": streams,
        "errors": errors,
        "error_rate": errors / max(len(prompts), 1),
        "mean_latency_s": (sum(latencies) / len(latencies)
                           if latencies else 0.0),
    }


def _quiesce(rep, timeout_s):
    deadline = time.monotonic() + timeout_s
    while rep.load() > 0:
        if time.monotonic() > deadline:
            return False
        time.sleep(0.005)
    return True


def promote(router, weights, *, probe_prompts, probe_max_new_tokens=8,
            gates=None, quiesce_timeout_s=30.0, probe_timeout_s=60.0,
            order=None):
    """Publish `weights` (a WeightSet) into `router`'s decode replica
    group one replica at a time with probe gates and auto-rollback.

    Returns a report dict: ``outcome`` (`promoted` / `rolled_back`),
    ``replicas`` (per-replica probe/verdict records in promotion
    order), and on rollback ``rolled_back_on`` + ``reasons``.  Books
    one `pt_serve_promotions_total{outcome}` sample either way.

    ``order``: replica names, canary first (default: enrollment order).
    Raises TimeoutError if a replica never quiesces (nothing was
    swapped on that replica; earlier replicas KEEP the new weights —
    re-run or roll back explicitly)."""
    gates = gates if gates is not None else PromotionGates()
    prompts = [list(p) for p in probe_prompts]
    if not prompts:
        raise ValueError("promote: probe_prompts must be non-empty — "
                         "the gates need a measured probe window")
    reps = {r.name: r for r in router.replicas("decode")}
    if not reps:
        raise ValueError(f"router {router.name!r} has no decode replicas")
    names = list(order) if order is not None else list(reps)
    unknown = [n for n in names if n not in reps]
    if unknown:
        raise KeyError(f"promote: unknown replicas {unknown}")

    report = {"outcome": None, "replicas": [], "weights": len(weights)}
    for name in names:
        rep = reps[name]
        router.set_held(name, True)
        try:
            if not _quiesce(rep, quiesce_timeout_s):
                raise TimeoutError(
                    f"promote: replica {name!r} did not quiesce within "
                    f"{quiesce_timeout_s}s (load={rep.load()}) — no swap "
                    f"performed on it")
            baseline = _run_probes(rep, prompts, probe_max_new_tokens,
                                   probe_timeout_s)
            old = capture_weights(rep.engine.scope, weights.names())
            # swap under the replica's dispatch lock: no decode step may
            # read a half-applied parameter set
            with rep.engine._exec_lock:
                weights.apply(rep.engine.scope)
            probe = _run_probes(rep, prompts, probe_max_new_tokens,
                                probe_timeout_s)
            ok, reasons = gates.verdict(probe, baseline)
            rec = {"replica": name, "ok": ok, "reasons": reasons,
                   "baseline": {k: baseline[k] for k in
                                ("error_rate", "mean_latency_s")},
                   "probe": {k: probe[k] for k in
                             ("error_rate", "mean_latency_s")}}
            report["replicas"].append(rec)
            if not ok:
                with rep.engine._exec_lock:
                    old.apply(rep.engine.scope)
                report["outcome"] = "rolled_back"
                report["rolled_back_on"] = name
                report["reasons"] = reasons
                _m_promotions().labels(router=router.name,
                                       outcome="rolled_back").inc()
                return report
        finally:
            router.set_held(name, False)
    report["outcome"] = "promoted"
    _m_promotions().labels(router=router.name, outcome="promoted").inc()
    return report
