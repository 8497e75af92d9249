"""The port's health sentinel (paddle_tpu_torch/health/, ops/amp_ops.py,
ops/health_ops.py and the executor's hooks) against the JAX package's
on the CPU.

Every training case builds tests/test_health.py's program — fc(4 -> 1),
square error, SGD 0.05 or Adam — in both packages, starts the port from
the JAX package's initial parameters, feeds both the same seeded numpy
batches and installs the same FaultPlan in each package's
fault_injection.  Per-step losses, the loss scales and the final state
must agree within 1e-6 (the same fp32 math summed in another order);
within one package, a skipped step's state is bit-unchanged and a
rolled-back run bit-equal to the uninjected one.

The first test pins the fault this slice repairs: with
FLAGS_health_sentinel on, the port's Executor ignored the flag, so a NaN
batch poisoned the weights where the JAX package skips the step.

The five ops are held against the JAX registry's lowerings at 0 (the
same elementwise math on the same values); the transpile's op sequence,
its ``@HEALTH@`` variables and its plan against the JAX package's on the
same programs.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu import health as jhealth
from paddle_tpu import observability as jobs
from paddle_tpu.distributed import fault_injection as jfi
from paddle_tpu.fluid import registry as jreg
from paddle_tpu.fluid.executor import Scope as JScope
from paddle_tpu.fluid.executor import scope_guard as jscope_guard

import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.ops  # noqa: F401  (registers the port's lowerings)
from paddle_tpu_torch import health as thealth
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.distributed import fault_injection as tfi
from paddle_tpu_torch.fluid import registry as treg
from paddle_tpu_torch.health.transpile import (BAD_TOTAL_VAR, FOUND_INF_VAR,
                                               HEALTH_PREFIX, LOSS_SCALE_VAR)

N_STEPS = 8
BAD_STEP = 3  # 1-based
TOL = dict(rtol=1e-6, atol=1e-6)
PARAMS = ("fc_0.w_0", "fc_0.b_0")

HEALTH_FLAGS = ["FLAGS_health_sentinel", "FLAGS_health_action",
                "FLAGS_health_rollback_keep", "FLAGS_health_spike_zscore",
                "FLAGS_health_spike_warmup", "FLAGS_health_loss_scaling",
                "FLAGS_health_loss_scale_init",
                "FLAGS_health_scale_growth_steps", "FLAGS_check_nan_inf"]

PKGS = {"jax": (jfluid, jfi), "torch": (tfluid, tfi)}


@pytest.fixture
def health_flags():
    """``arm(**flags)`` sets the sentinel on with ``flags`` in both
    packages; every health flag and the FaultPlans restored after."""
    prior = {k: fluid.get_flags(HEALTH_FLAGS)
             for k, (fluid, _) in PKGS.items()}

    def arm(**kw):
        for fluid, _ in PKGS.values():
            fluid.set_flags({"FLAGS_health_sentinel": True, **kw})

    yield arm
    for k, (fluid, fi) in PKGS.items():
        fluid.set_flags(prior[k])
        fi.uninstall()


def _build(fluid, opt="sgd", lr=0.05, dropout=False):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = x
        if dropout:
            h = fluid.layers.dropout(fluid.layers.fc(x, size=8, act="tanh"),
                                     dropout_prob=0.5)
        pred = fluid.layers.fc(h, size=1)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        {"sgd": lambda: fluid.optimizer.SGD(learning_rate=lr),
         "adam": lambda: fluid.optimizer.Adam(learning_rate=lr)}[opt]() \
            .minimize(loss)
    main.random_seed = 11
    return main, startup, loss


def _batches(n=N_STEPS, batch=8, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.uniform(-1, 1, (4, 1)).astype("float32")
    out = []
    for _ in range(n):
        xb = rng.uniform(-1, 1, (batch, 4)).astype("float32")
        out.append({"x": xb, "y": xb @ w})
    return out


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _scalar(scope, name):
    v = scope.get(name)
    return None if v is None else float(_np(v).ravel()[0])


def _state_names(main, scope):
    return [n for n, v in main.global_block().vars.items()
            if v.persistable and not n.startswith(HEALTH_PREFIX)
            and scope.get(n) is not None]


class _Run:
    """One package's training run: the program, a scope started from
    ``init`` (the JAX package's initial parameters) and an executor."""

    def __init__(self, pkg, opt="sgd", plan=None, init=None, dropout=False):
        fluid, fi = PKGS[pkg]
        self.pkg, self.fluid = pkg, fluid
        if plan:
            fi.install(plan)
        else:
            fi.uninstall()
        self.main, startup, self.loss = _build(fluid, opt, dropout=dropout)
        if pkg == "jax":
            self.scope = JScope()
            with jscope_guard(self.scope):
                self.exe = fluid.Executor(fluid.CPUPlace())
                self.exe.run(startup)
        else:
            self.scope = tfluid.Scope()
            self.exe = fluid.Executor(fluid.CPUPlace())
            self.exe.run(startup, scope=self.scope)
            for n, v in (init or {}).items():
                self.scope.set(n, torch.from_numpy(np.array(v)))

    def params(self):
        return {n: _np(self.scope.get(n)).copy()
                for n in _state_names(self.main, self.scope)}

    def run(self, feed, fetch_loss=True):
        fetch = [self.loss.name] if fetch_loss else []
        if self.pkg == "jax":
            with jscope_guard(self.scope):
                return self.exe.run(self.main, feed=feed, fetch_list=fetch)
        return self.exe.run(self.main, feed=feed, fetch_list=fetch,
                            scope=self.scope)

    def run_steps(self, feed, n):
        if self.pkg == "jax":
            with jscope_guard(self.scope):
                return self.exe.run_steps(self.main, feed=feed, n_steps=n,
                                          fetch_list=[self.loss.name])
        return self.exe.run_steps(self.main, feed=feed, n_steps=n,
                                  fetch_list=[self.loss.name],
                                  scope=self.scope)


def _train(opt="sgd", plan=None, n=N_STEPS, batches=None, dropout=False,
           pkgs=("jax", "torch")):
    """The same run in each package of ``pkgs``, the port from the JAX
    package's start: {pkg: {losses, scales, found, params, bad_total}}."""
    batches = batches if batches is not None else _batches(n)
    init = _Run("jax", opt, dropout=dropout).params()
    out = {}
    for pkg in pkgs:
        r = _Run(pkg, opt, plan, init, dropout=dropout)
        rec = {"losses": [], "scales": [], "found": []}
        try:
            for b in batches:
                (lv,) = r.run(b)
                rec["losses"].append(float(_np(lv)))
                if r.scope.get(LOSS_SCALE_VAR) is not None:
                    rec["scales"].append(_scalar(r.scope, LOSS_SCALE_VAR))
                rec["found"].append(_scalar(r.scope, FOUND_INF_VAR))
            rec["params"] = r.params()
            rec["bad_total"] = _scalar(r.scope, BAD_TOTAL_VAR)
        finally:
            PKGS[pkg][1].uninstall()
        out[pkg] = rec
    return out


def _agree(rec):
    """Per-step losses, scales, found flags and the final state of the
    two packages within TOL."""
    j, t = rec["jax"], rec["torch"]
    np.testing.assert_allclose(t["losses"], j["losses"], **TOL)
    np.testing.assert_allclose(t["scales"], j["scales"], **TOL)
    assert t["found"] == j["found"]
    assert t["bad_total"] == j["bad_total"]
    assert sorted(t["params"]) == sorted(j["params"])
    for n in j["params"]:
        np.testing.assert_allclose(t["params"][n], j["params"][n], **TOL,
                                   err_msg=n)


def _samples(snapshot, family):
    fam = snapshot().get(family)
    return dict(fam["samples"]) if fam else {}


def _bad_steps(pkg):
    snap = jobs.REGISTRY.snapshot if pkg == "jax" else tobs.snapshot
    return _samples(snap, "pt_health_bad_steps_total")


# ---------------------------------------------------------------------------
# the fault repaired: the flag used to leave the port's Executor unguarded
# ---------------------------------------------------------------------------


def test_sentinel_flag_skips_nan_batch_as_jax_does(health_flags):
    health_flags(FLAGS_health_action="skip")
    batches = _batches(3)
    batches[1]["x"][0, 0] = np.nan
    rec = _train(batches=batches)
    for n in PARAMS:
        assert np.isfinite(rec["torch"]["params"][n]).all(), n
        np.testing.assert_allclose(rec["torch"]["params"][n],
                                   rec["jax"]["params"][n], **TOL)
    assert rec["torch"]["found"] == [0.0, 1.0, 0.0] == rec["jax"]["found"]
    assert rec["torch"]["bad_total"] == 1.0


# ---------------------------------------------------------------------------
# the five ops against the JAX registry
# ---------------------------------------------------------------------------


def _run_jax(op_type, inputs, attrs):
    ctx = jreg.LowerContext(step=0)
    ctx.op_index = 0
    vals = [[jnp.asarray(x) for x in a] if isinstance(a, list)
            else jnp.asarray(a) for a in inputs]
    out = jreg.get_op(op_type).lower(ctx, *vals, attrs=dict(attrs))
    return out if isinstance(out, tuple) else (out,)


def _run_port(op_type, inputs, attrs):
    ctx = treg.LowerContext("cpu")
    vals = [[torch.from_numpy(np.array(x)) for x in a] if isinstance(a, list)
            else torch.from_numpy(np.array(a)) for a in inputs]
    out = treg.get_op(op_type).lower(ctx, *vals, attrs=dict(attrs))
    return out if isinstance(out, tuple) else (out,)


def _flat(out):
    for o in out:
        if isinstance(o, (list, tuple)):
            yield from o
        else:
            yield o


_r = np.random.RandomState(3)
_g = [(_r.randn(3, 5) * 4).astype(np.float32),
      (_r.randn(7) * 2).astype(np.float32)]
_g_nan = [_g[0], np.where(np.arange(7) == 4, np.nan, _g[1]).astype(
    np.float32)]
_g_inf = [np.where(np.arange(15).reshape(3, 5) == 2, -np.inf,
                   _g[0]).astype(np.float32), _g[1]]
_f32 = lambda *v: np.array(v, np.float32)  # noqa: E731
_i32 = lambda *v: np.array(v, np.int32)  # noqa: E731

OP_CASES = {
    "health_check_clean": ("health_check", [_g], {}),
    "health_check_nan": ("health_check", [_g_nan], {}),
    "health_check_inf": ("health_check", [_g_inf], {}),
    "health_check_ints_ignored": ("health_check",
                                  [[np.arange(6, dtype=np.int32)]], {}),
    "unscale_clean": ("check_finite_and_unscale", [_g, _f32(1024.0)], {}),
    "unscale_nan": ("check_finite_and_unscale", [_g_nan, _f32(256.0)], {}),
    "unscale_inf": ("check_finite_and_unscale", [_g_inf, _f32(3.0)], {}),
    "accum_good": ("health_accum", [np.array([False]), _f32(2.0)], {}),
    "accum_bad": ("health_accum", [np.array([True]), _f32(2.0)], {}),
    "scaling_bad_halves": ("update_loss_scaling",
                           [_f32(1024.0), np.array([True]), _i32(5),
                            _i32(0)],
                           {"incr_every_n_steps": 3,
                            "decr_every_n_nan_or_inf": 1,
                            "incr_ratio": 2.0, "decr_ratio": 0.5}),
    "scaling_floor_one": ("update_loss_scaling",
                          [_f32(1.0), np.array([True]), _i32(0), _i32(0)],
                          {"decr_every_n_nan_or_inf": 1}),
    "scaling_grows": ("update_loss_scaling",
                      [_f32(1024.0), np.array([False]), _i32(2), _i32(0)],
                      {"incr_every_n_steps": 3, "incr_ratio": 2.0}),
    "scaling_counts": ("update_loss_scaling",
                       [_f32(64.0), np.array([False]), _i32(0), _i32(1)],
                       {}),
    "scaling_second_bad": ("update_loss_scaling",
                           [_f32(64.0), np.array([True]), _i32(0), _i32(1)],
                           {"decr_every_n_nan_or_inf": 2}),
    **{f"inject_{kind}_{c}": (
        "health_fault_inject", [_g[0], _f32(c)],
        {"kind": kind, "spike_scale": 250.0})
       for kind in ("nan", "inf", "spike") for c in (0.0, 1.0, 3.0)},
    "inject_loss_scalar": ("health_fault_inject",
                           [np.float32(0.75), _f32(1.0)], {"kind": "inf"}),
}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_op_matches_jax_registry(case):
    op_type, inputs, attrs = OP_CASES[case]
    got = list(_flat(_run_port(op_type, inputs, attrs)))
    want = list(_flat(_run_jax(op_type, inputs, attrs)))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype, (case, i, g.dtype,
                                                          w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{case} output {i}")


def test_detect_reduces_to_one_scalar():
    from paddle_tpu_torch.health import detect

    ok = detect.all_finite([torch.ones(4, 4), torch.zeros(3)])
    assert ok.shape == () and bool(ok)
    assert not bool(detect.all_finite([torch.ones(3),
                                       torch.tensor([1.0, np.nan])]))
    assert not bool(detect.all_finite([torch.tensor([np.inf],
                                                    dtype=torch.bfloat16)]))
    assert bool(detect.all_finite([torch.arange(3), None, "str"]))
    assert bool(detect.all_finite([]))
    f = detect.found_inf([torch.tensor([np.nan])])
    assert f.shape == (1,) and f.dtype == torch.float32 and float(f[0]) == 1


def test_host_scan_names_the_variable_as_jax_does():
    named = [("ok", np.ones(2, np.float32)),
             ("ints", np.arange(3)),
             ("bad_var", np.array([np.nan], np.float32))]
    msgs = []
    for scan, vals in ((jhealth.detect.host_scan, named),
                       (thealth.detect.host_scan,
                        [(n, torch.from_numpy(v)) for n, v in named])):
        with pytest.raises(RuntimeError) as e:
            scan(vals, "label")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    thealth.detect.host_scan([("ints", torch.arange(3))], "label")


def test_check_nan_inf_flag_names_the_variable_as_jax_does(health_flags):
    names = []
    for pkg, (fluid, _) in PKGS.items():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data(name="x", shape=[2], dtype="float32")
            out = fluid.layers.sqrt(x)  # sqrt(-1) = nan
        fluid.set_flags({"FLAGS_check_nan_inf": True})
        feed = {"x": -np.ones((1, 2), "float32")}
        with pytest.raises(RuntimeError, match="check_nan_inf") as e:
            if pkg == "jax":
                with jscope_guard(JScope()):
                    exe = fluid.Executor(fluid.CPUPlace())
                    exe.run(startup)
                    exe.run(main, feed=feed, fetch_list=[out.name])
            else:
                exe = fluid.Executor(fluid.CPUPlace())
                exe.run(main, feed=feed, fetch_list=[out.name],
                        scope=tfluid.Scope())
        names.append(re.search(r"variable '([^']+)'", str(e.value)).group(1))
        fluid.set_flags({"FLAGS_check_nan_inf": False})
    assert names[0] == names[1] == out.name


# ---------------------------------------------------------------------------
# the transpile against the JAX package's
# ---------------------------------------------------------------------------


def _vars(main):
    return {n: (str(v.dtype), list(v.shape or []), bool(v.persistable))
            for n, v in main.global_block().vars.items()
            if n.startswith(HEALTH_PREFIX)}


TRANSPILE_CASES = {
    "sgd": ("sgd", {}, None),
    "adam": ("adam", {}, None),
    "adam_scaling": ("adam", {"FLAGS_health_loss_scaling": True,
                              "FLAGS_health_loss_scale_init": 512.0,
                              "FLAGS_health_scale_growth_steps": 7}, None),
    "faults": ("sgd", {}, "nan:grad:step:2;spike:loss:step:5:250;"
                          "inf:loss:step:3"),
    "scaling_faults": ("adam", {"FLAGS_health_loss_scaling": True},
                       "inf:grad:step:4"),
}


@pytest.mark.parametrize("case", sorted(TRANSPILE_CASES))
def test_insert_health_sentinel_matches_jax(health_flags, case):
    opt, flags, plan = TRANSPILE_CASES[case]
    health_flags(**flags)
    got = {}
    for pkg, (fluid, fi) in PKGS.items():
        if plan:
            fi.install(plan)
        main, _startup, loss = _build(fluid, opt)
        mod = jhealth if pkg == "jax" else thealth
        hp = mod.insert_health_sentinel(main, loss_name=loss.name)
        assert mod.insert_health_sentinel(main) is hp  # idempotent
        ops = main.global_block().ops
        got[pkg] = dict(
            types=[op.type for op in ops],
            io=[(op.type, op.inputs, op.outputs,
                 {k: v for k, v in op.attrs.items()
                  if k in ("op_role", "kind", "spike_scale",
                           "incr_every_n_steps", "decr_every_n_nan_or_inf",
                           "incr_ratio", "decr_ratio")})
                for op in ops if op.type.startswith(("health", "check_",
                                                     "update_loss"))
                or op.inputs.get("ScaleTensor")],
            vars=_vars(main),
            plan={k: v for k, v in hp.items() if k not in ("state",)},
            state={k: (np.asarray(v).dtype.str, np.asarray(v).tolist())
                   for k, v in hp["state"].items()})
        fi.uninstall()
    assert got["torch"] == got["jax"]


def test_sentinel_skips_programs_without_optimizer():
    main, startup, _loss = _build(tfluid)
    assert thealth.insert_health_sentinel(startup) is None
    infer = tfluid.Program()
    with tfluid.program_guard(infer, tfluid.Program()), \
            tfluid.unique_name.guard():
        x = tfluid.layers.data(name="x", shape=[4], dtype="float32")
        tfluid.layers.fc(x, size=1)
    assert thealth.insert_health_sentinel(infer) is None


def test_sentinel_off_is_no_op():
    """Flag off: no @HEALTH@ vars, no rewrite, in both packages."""
    for fluid, fi in PKGS.values():
        fi.uninstall()
        main, _startup, _loss = _build(fluid)
        mod = jhealth if fluid is jfluid else thealth
        assert mod.attach(main) is None
        assert getattr(main, "_health_plan", None) is None
        assert not any(n.startswith(HEALTH_PREFIX)
                       for n in main.global_block().vars)


def test_health_flags_default_and_parse_as_jax():
    from paddle_tpu.fluid import flags as jflags
    from paddle_tpu_torch.fluid import flags as tflags

    names = HEALTH_FLAGS + ["FLAGS_flight_recorder_steps",
                            "FLAGS_flight_recorder_dir",
                            "FLAGS_profile_slow_step_zscore"]
    assert tflags.get_flags(names) == jflags.get_flags(names)
    prior = tflags.get_flags(names)
    try:
        tflags.set_flags({"FLAGS_health_sentinel": "1",
                          "FLAGS_health_action": "rollback",
                          "FLAGS_health_rollback_keep": "5",
                          "FLAGS_health_spike_zscore": "3.5"})
        assert tflags.get_flags(["health_sentinel", "health_action",
                                 "health_rollback_keep",
                                 "health_spike_zscore"]) == {
            "health_sentinel": True, "health_action": "rollback",
            "health_rollback_keep": 5, "health_spike_zscore": 3.5}
    finally:
        tflags.set_flags(prior)


# ---------------------------------------------------------------------------
# tests/test_health.py's training cases, through both packages
# ---------------------------------------------------------------------------


def test_skip_masks_update_and_training_continues(health_flags):
    health_flags(FLAGS_health_action="skip")
    before = {p: _bad_steps(p).get(("grad", "skip"), 0.0) for p in PKGS}
    rec = _train(plan=f"nan:grad:step:{BAD_STEP}")
    _agree(rec)
    t = rec["torch"]
    assert all(np.isfinite(t["losses"]))
    assert t["found"][BAD_STEP - 1] == 1.0 and sum(t["found"]) == 1.0
    assert t["bad_total"] == 1.0
    for p in PKGS:
        assert _bad_steps(p)[("grad", "skip")] == before[p] + 1.0


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_skip_step_state_bitwise_unchanged(health_flags, opt):
    """The gate is a true skip in the port: parameters, moments and beta
    powers of the bad step are bit-identical to the state before it;
    every step's loss and the final state agree with the JAX package's."""
    health_flags(FLAGS_health_action="skip")
    init = _Run("jax", opt).params()
    runs = {pkg: _Run(pkg, opt, f"nan:grad:step:{BAD_STEP}", init)
            for pkg in PKGS}
    losses = {pkg: [] for pkg in PKGS}
    for i, b in enumerate(_batches(5)):
        for pkg, r in runs.items():
            pre = r.params()
            (lv,) = r.run(b)
            losses[pkg].append(float(_np(lv)))
            found = _scalar(r.scope, FOUND_INF_VAR)
            assert found == (1.0 if i + 1 == BAD_STEP else 0.0), (pkg, i)
            if i + 1 == BAD_STEP:
                post = r.params()
                for n in pre:
                    np.testing.assert_array_equal(
                        pre[n], post[n], err_msg=f"{pkg}: {n} changed")
    np.testing.assert_allclose(losses["torch"], losses["jax"], **TOL)
    j, t = runs["jax"].params(), runs["torch"].params()
    assert sorted(t) == sorted(j)
    for n in j:
        np.testing.assert_allclose(t[n], j[n], **TOL, err_msg=n)
    for fi in (jfi, tfi):
        fi.uninstall()


def test_raise_action_preserves_fail_fast(health_flags):
    health_flags(FLAGS_health_action="raise")
    for pkg in PKGS:
        with pytest.raises(RuntimeError, match="health sentinel") as e:
            _train(plan=f"nan:grad:step:{BAD_STEP}", pkgs=(pkg,))
        if pkg == "torch":
            assert f"at step {BAD_STEP} " in str(e.value)


def test_rollback_replays_to_bitexact_parity(health_flags):
    """rollback restores the snapshot and replays the same feed: the
    run equals the uninjected one bit for bit, in each package, and the
    two packages agree."""
    health_flags(FLAGS_health_action="skip")
    base = _train()
    health_flags(FLAGS_health_action="rollback")
    before = {p: _bad_steps(p).get(("grad", "rollback"), 0.0) for p in PKGS}
    rb_before = _samples(tobs.snapshot, "pt_health_rollbacks_total").get(
        (), 0.0)
    rb = _train(plan=f"nan:grad:step:{BAD_STEP}")
    for pkg in PKGS:
        np.testing.assert_array_equal(base[pkg]["losses"],
                                      rb[pkg]["losses"])
        for n in base[pkg]["params"]:
            np.testing.assert_array_equal(base[pkg]["params"][n],
                                          rb[pkg]["params"][n])
        assert _bad_steps(pkg)[("grad", "rollback")] == before[pkg] + 1.0
    np.testing.assert_allclose(rb["torch"]["losses"], rb["jax"]["losses"],
                               **TOL)
    assert _samples(tobs.snapshot, "pt_health_rollbacks_total")[()] \
        == rb_before + 1.0


def test_rollback_replays_the_same_step_under_dropout(health_flags):
    """The port's replay runs at the rolled-back step (its random
    streams reseeded from it) and the step counts once: under dropout
    the whole run equals the uninjected one bit for bit."""
    health_flags(FLAGS_health_action="skip")
    base = _train(dropout=True, pkgs=("torch",))["torch"]
    health_flags(FLAGS_health_action="rollback")
    rb = _train(dropout=True, plan=f"nan:grad:step:{BAD_STEP}",
                pkgs=("torch",))["torch"]
    np.testing.assert_array_equal(base["losses"], rb["losses"])
    for n in base["params"]:
        np.testing.assert_array_equal(base["params"][n], rb["params"][n])
    assert rb["bad_total"] == 1.0


def test_inf_loss_detected_by_host_loss_detector(health_flags):
    """inf:loss corrupts the fetched loss only: found_inf never fires and
    the host's loss detector books kind="loss"."""
    health_flags(FLAGS_health_action="skip")
    before = {p: _bad_steps(p).get(("loss", "skip"), 0.0) for p in PKGS}
    rec = _train(plan=f"inf:loss:step:{BAD_STEP}")
    _agree(rec)
    t = rec["torch"]
    assert not np.isfinite(t["losses"][BAD_STEP - 1])
    assert np.isfinite(t["losses"][BAD_STEP])
    assert t["bad_total"] == 0.0
    for p in PKGS:
        assert _bad_steps(p)[("loss", "skip")] == before[p] + 1.0


def test_spike_detector_books_spike_kind(health_flags):
    health_flags(FLAGS_health_action="skip", FLAGS_health_spike_zscore=4.0,
                 FLAGS_health_spike_warmup=3)
    before = {p: _bad_steps(p).get(("spike", "skip"), 0.0) for p in PKGS}
    rec = _train(plan="spike:loss:step:7:1000")
    _agree(rec)
    assert rec["torch"]["losses"][6] > 100 * max(rec["torch"]["losses"][:6])
    for p in PKGS:
        assert _bad_steps(p)[("spike", "skip")] == before[p] + 1.0


def test_dynamic_loss_scaling_halves_and_grows(health_flags):
    health_flags(FLAGS_health_action="skip", FLAGS_health_loss_scaling=True,
                 FLAGS_health_loss_scale_init=1024.0,
                 FLAGS_health_scale_growth_steps=3)
    rec = _train(plan=f"nan:grad:step:{BAD_STEP}")
    _agree(rec)
    scales = rec["torch"]["scales"]
    assert scales[BAD_STEP - 1] == scales[BAD_STEP - 2] / 2
    assert scales[-1] > scales[BAD_STEP - 1]
    assert all(np.isfinite(rec["torch"]["losses"]))
    gauge = _samples(tobs.snapshot, "pt_health_loss_scale")
    assert gauge[("single",)] == scales[-1]


def test_loss_scaling_matches_unscaled_training(health_flags):
    """Scaling the seed and unscaling at the optimizer edge is neutral on
    clean fp32 steps (powers of two), in the port as in the JAX
    package."""
    health_flags()
    base = _train()
    health_flags(FLAGS_health_loss_scaling=True,
                 FLAGS_health_loss_scale_init=256.0,
                 FLAGS_health_scale_growth_steps=10 ** 6)
    scaled = _train()
    _agree(scaled)
    np.testing.assert_allclose(scaled["torch"]["losses"],
                               base["torch"]["losses"], rtol=0, atol=1e-6)


def test_run_steps_chain_masks_midchain_bad_step(health_flags):
    """A bad step inside a run_steps chain is masked in its own
    iteration and counted through the bad-step total; only the last
    iteration's found_inf reaches the host."""
    health_flags(FLAGS_health_action="skip")
    init = _Run("jax").params()
    got = {}
    for pkg in PKGS:
        r = _Run(pkg, plan="nan:grad:step:2", init=init)
        (out,) = r.run_steps(_batches(1)[0], 4)
        got[pkg] = (float(_np(out)), r.params(),
                    _scalar(r.scope, BAD_TOTAL_VAR),
                    _scalar(r.scope, FOUND_INF_VAR))
        PKGS[pkg][1].uninstall()
    loss, params, bad_total, found = got["torch"]
    assert np.isfinite(loss) and bad_total == 1.0 and found == 0.0
    assert all(np.isfinite(v).all() for v in params.values())
    np.testing.assert_allclose(loss, got["jax"][0], **TOL)
    for n in params:
        np.testing.assert_allclose(params[n], got["jax"][1][n], **TOL)
    assert got["jax"][2:] == got["torch"][2:]


def test_fresh_sentinel_syncs_to_persisted_bad_total(health_flags):
    """A new executor (a new sentinel) on a scope with a bad step behind
    it syncs to its bad-step total: a clean chain books nothing."""
    health_flags(FLAGS_health_action="skip")
    before = _bad_steps("torch").get(("grad", "skip"), 0.0)
    r = _Run("torch", plan=f"nan:grad:step:{BAD_STEP}")
    for b in _batches(BAD_STEP):
        r.run(b)
    assert _scalar(r.scope, BAD_TOTAL_VAR) == 1.0
    assert _bad_steps("torch")[("grad", "skip")] == before + 1.0
    tfi.uninstall()
    exe2 = tfluid.Executor(tfluid.CPUPlace())
    (out,) = exe2.run_steps(r.main, feed=_batches(1)[0], n_steps=2,
                            fetch_list=[r.loss.name], scope=r.scope)
    assert np.isfinite(out).all()
    assert _bad_steps("torch")[("grad", "skip")] == before + 1.0


def test_health_sentinel_pass_matches_jax_adapter(health_flags):
    from paddle_tpu import passes as jpasses
    from paddle_tpu_torch import passes as tpasses

    health_flags()
    types = {}
    for pkg, (fluid, _) in PKGS.items():
        mgr = (jpasses if pkg == "jax" else tpasses).PassManager(
            ["health_sentinel"])
        ctx = (jpasses if pkg == "jax" else tpasses).PassContext
        main, _startup, loss = _build(fluid)
        rep = mgr.run(main, ctx(loss_name=loss.name))
        assert rep[-1]["changed"] and rep[-1]["sites"] == 1
        assert not mgr.run(main, ctx(loss_name=loss.name))[-1]["changed"]
        types[pkg] = [op.type for op in main.global_block().ops]
    assert types["torch"] == types["jax"]
