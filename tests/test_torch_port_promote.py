"""Canary weight promotion in the port (paddle_tpu_torch/serving/
promote.py and ``drill.promotion_drill``) against the JAX package's.

``PromotionGates.verdict`` must give the JAX package's verdict and
reasons on the same probe dicts; tests/test_serving_resilience.py's
fake-replica promotions (converge, drift rollback, an injected probe
error, bad inputs) run through both packages' ``promote`` and must give
the same reports.  ``promotion_drill`` runs on the CPU over a tiny
2-replica GPT group, clean and regress, and its report must have the
JAX package's keys and outcomes; the JAX drill runs in a child
(tests/torch_port_promote_oracle.py; its decode lane wants a fresh
process), started when the module starts.  Nothing here gates on wall
time or a sleep race: the gates run with ``max_latency_ratio=None``, the
routers without a probe thread.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import concurrent.futures
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import fault_injection as jfi
from paddle_tpu.fluid.executor import Scope as JScope
from paddle_tpu.serving import promote as jpromote
from paddle_tpu.serving.router import Router as JRouter

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.distributed import fault_injection as tfi
from paddle_tpu_torch.distributed.resilience import RetryPolicy
from paddle_tpu_torch.serving import drill as tdrill
from paddle_tpu_torch.serving import promote as tpromote
from paddle_tpu_torch.serving.router import Router as TRouter

HERE = os.path.dirname(os.path.abspath(__file__))

PKGS = {"jax": (jpromote, JRouter, jfi, JScope, np.asarray),
        "torch": (tpromote, TRouter, tfi, tfluid.Scope, torch.as_tensor)}


@pytest.fixture(scope="module")
def jax_drill():
    """The JAX package's promotion_drill reports (clean, regress), from
    a child started at the module's first use."""
    proc = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_port_promote_oracle.py")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(HERE))
    holder = {}

    def result():
        if "out" not in holder:
            out, err = proc.communicate(timeout=600)
            lines = [ln for ln in out.splitlines()
                     if ln.startswith("PROMOTE_ORACLE ")]
            assert lines, f"oracle rc={proc.returncode}\n{err[-3000:]}"
            holder["out"] = json.loads(lines[-1][len("PROMOTE_ORACLE "):])
        return holder["out"]

    yield result
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


class FakeServedModel:
    """A decode replica whose greedy stream is a pure function of its
    scope's "w": a swap changes the stream, which the drift gate reads."""

    def __init__(self, name, pkg):
        self.name = name
        self.scope = PKGS[pkg][3]()
        self.scope.set("w", PKGS[pkg][4](np.zeros(2, np.float32)))
        self._exec_lock = threading.Lock()

    def healthy(self):
        return True

    def load(self):
        return 0

    def submit_request(self, *a, **kw):  # its kind tag only
        raise NotImplementedError

    def submit(self, prompt, max_new_tokens, eos_id=None, tenant="default"):
        fut = concurrent.futures.Future()
        w = int(np.asarray(self.scope.get("w")).sum())
        fut.set_result([w] * int(max_new_tokens))
        return fut


def _router(pkg, reps):
    if pkg == "jax":
        from paddle_tpu.distributed.resilience import RetryPolicy as JRetry

        retry = JRetry(times=2, backoff_ms=1, jitter=0.0)
    else:
        retry = RetryPolicy(times=2, backoff_ms=1, jitter=0.0)
    return PKGS[pkg][1](reps, retry=retry, hedge_ms=0, auto_probe=False)


def _report(rep):
    """A promote report without its latencies (wall time)."""
    out = {k: v for k, v in rep.items() if k != "replicas"}
    out["replicas"] = [{k: v for k, v in r.items()
                        if k not in ("baseline", "probe")}
                       | {"errors": (r["baseline"]["error_rate"],
                                     r["probe"]["error_rate"])}
                       for r in rep["replicas"]]
    return out


_BASE = {"streams": [[1, 2], [3, 4, 5]], "error_rate": 0.0,
         "mean_latency_s": 0.01}
VERDICT_CASES = {
    "clean": ({}, dict(_BASE)),
    "errors": ({"max_error_rate": 0.0}, dict(_BASE, error_rate=0.5)),
    "errors_allowed": ({"max_error_rate": 0.5},
                       dict(_BASE, error_rate=0.5)),
    "slow": ({"max_latency_ratio": 2.0}, dict(_BASE, mean_latency_s=1.0)),
    "slow_ungated": ({"max_latency_ratio": None},
                     dict(_BASE, mean_latency_s=1.0)),
    "drift": ({"max_drift": 0.0}, dict(_BASE, streams=[[1, 9], [3, 4, 5]])),
    "drift_ceiling": ({"max_drift": 0.2},
                      dict(_BASE, streams=[[1, 9], [3, 4, 5]])),
    "failed_probe": ({"max_drift": 0.5, "max_error_rate": 0.0},
                     dict(_BASE, streams=[None, [3, 4, 5]],
                          error_rate=0.5)),
    "shorter": ({"max_drift": 0.0}, dict(_BASE, streams=[[1], [3, 4, 5]])),
    "everything": ({"max_error_rate": 0.0, "max_latency_ratio": 1.5,
                    "max_drift": 0.0},
                   dict(_BASE, error_rate=1.0, mean_latency_s=0.5,
                        streams=[None, None])),
}


@pytest.mark.parametrize("case", sorted(VERDICT_CASES))
def test_gates_verdict_matches_jax(case):
    kw, probe = VERDICT_CASES[case]
    got = {pkg: PKGS[pkg][0].PromotionGates(**kw).verdict(dict(probe),
                                                          dict(_BASE))
           for pkg in PKGS}
    assert got["torch"] == got["jax"]


def test_weightset_copies_values_and_applies_in_place():
    s = tfluid.Scope()
    s.set("a", torch.arange(4, dtype=torch.float32))
    s.set("b", torch.ones(2, 2))
    ws = tpromote.capture_weights(s, ["a", "b"])
    assert ws.names() == ["a", "b"] and len(ws) == 2
    held = s.get("a")
    held.add_(10)  # the scope moves on: the captured copy must not
    assert torch.equal(ws.arrays["a"], torch.arange(4, dtype=torch.float32))
    ws.apply(s)
    assert s.get("a") is held  # in place: the storage a graph reads
    assert torch.equal(held, torch.arange(4, dtype=torch.float32))
    s.set("c", torch.zeros(3, dtype=torch.float64))
    tpromote.WeightSet({"c": np.ones(5, np.float32)}).apply(s)
    assert s.get("c").shape == (5,) and s.get("c").dtype == torch.float64
    with pytest.raises(KeyError, match="not in scope"):
        tpromote.WeightSet.from_scope(s, ["a", "missing"])


def _promote_both(plan, gates_kw, check):
    got = {}
    for pkg, (promote, _router_cls, fi, _scope, _arr) in PKGS.items():
        reps = [FakeServedModel("r0", pkg), FakeServedModel("r1", pkg)]
        if plan:
            fi.install(plan)
        router = _router(pkg, reps)
        try:
            rep = promote.promote(
                router, promote.WeightSet({"w": np.ones(2, np.float32)}),
                probe_prompts=[[1]], probe_max_new_tokens=2,
                gates=promote.PromotionGates(**gates_kw))
            check(rep, reps)
            assert all(not r.held for r in router.replicas())
            got[pkg] = _report(rep)
        finally:
            fi.uninstall()
            router.close()
    assert got["torch"] == got["jax"]
    return got["torch"]


def _w(rep):
    return int(np.asarray(rep.scope.get("w")).sum())


def test_promote_converges_group():
    def check(rep, reps):
        assert rep["outcome"] == "promoted"
        assert [r["replica"] for r in rep["replicas"]] == ["r0", "r1"]
        assert [_w(r) for r in reps] == [2, 2]

    _promote_both(None, dict(max_drift=None, max_latency_ratio=None), check)


def test_promote_drift_gate_rolls_back_canary():
    def check(rep, reps):
        assert rep["outcome"] == "rolled_back"
        assert rep["rolled_back_on"] == "r0"
        assert "drift" in rep["reasons"][0]
        assert [_w(r) for r in reps] == [0, 0]

    _promote_both(None, dict(max_drift=0.0, max_latency_ratio=None), check)


def test_promote_injected_probe_error_rolls_back():
    def check(rep, reps):
        assert rep["outcome"] == "rolled_back"
        assert _w(reps[0]) == 0

    # the baseline probe takes count 1; the post-swap probe is count 2
    _promote_both("serve_error:r0:req:2",
                  dict(max_error_rate=0.0, max_drift=None,
                       max_latency_ratio=None), check)


def test_promote_validates_inputs():
    for pkg, (promote, *_rest) in PKGS.items():
        router = _router(pkg, [FakeServedModel("r0", pkg)])
        try:
            ws = promote.WeightSet({"w": np.ones(2, np.float32)})
            with pytest.raises(ValueError, match="non-empty"):
                promote.promote(router, ws, probe_prompts=[])
            with pytest.raises(KeyError, match="unknown replicas"):
                promote.promote(router, ws, probe_prompts=[[1]],
                                order=["nope"])
        finally:
            router.close()


def _promotions(outcome):
    fam = tobs.snapshot().get("pt_serve_promotions_total") or {}
    return fam.get("samples", {}).get(("promo", outcome), 0.0)


@pytest.mark.parametrize("regress", [False, True],
                         ids=["clean", "regress"])
def test_promotion_drill_matches_jax(jax_drill, regress):
    before = _promotions("rolled_back" if regress else "promoted")
    rep = tdrill.promotion_drill(regress=regress, place=tfluid.CPUPlace())
    want = jax_drill()["regress" if regress else "clean"]
    keys = set(rep) - {"promote_s"}  # the port also reports its seconds
    assert keys == set(want["keys"])
    for k in ("mode", "outcome", "compile_miss_delta", "traffic_completed",
              "traffic_errors", "canary_restored_bit_exact",
              "group_converged", "ok"):
        assert rep[k] == want["report"][k], k
    assert [r["replica"] for r in rep["replicas"]] == want["replicas"]
    assert [r["ok"] for r in rep["replicas"]] == want["replica_ok"]
    assert rep["ok"] and rep["compile_miss_delta"] == 0
    assert _promotions(rep["outcome"]) == before + 1.0
