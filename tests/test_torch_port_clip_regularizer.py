"""Weight decay and gradient clipping in the PyTorch port's training
front end (paddle_tpu_torch/fluid/regularizer.py, clip.py and their
wiring in optimizer.py) against the JAX package, on the CPU.

A two-``fc`` classifier (relu, softmax, cross entropy) built by both
packages with the same regularization (none, L1Decay, L2Decay, or a
parameter's own regularizer over the optimizer's) and clipping (none,
by value and by norm through ``set_gradient_clip``, the global norm as
the optimizer's ``grad_clip``, or a parameter's own ``gradient_clip``),
the JAX package's initial parameters in both, 5 SGD steps: the appended
op lists equal (types, slots, attrs) and the losses within 1e-5
relative.  Also: the port's data-parallel run of the JAX package's
``test_dp_parity_with_regularizer_and_clip`` (four CPU replicas against
one, the reference's rtol 3e-4), ``minimize(startup_program=...)``
placing the accumulators where the JAX package places them, and ``fc``
over two inputs.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import json

import numpy as np
import pytest

from paddle_tpu import fluid as jfluid

from paddle_tpu_torch import convert
from paddle_tpu_torch import fluid as tfluid

PKGS = {"jax": jfluid, "torch": tfluid}
STEPS, LR = 5, 0.1
LOSS_RTOL = 1e-5

REGS = ["none", "l1", "l2", "per_param"]
CLIPS = ["none", "by_value", "by_norm", "by_global_norm", "per_param"]


def _regularization(fl, reg):
    """(the optimizer's regularization, the first weight's own)."""
    if reg == "l1":
        return fl.regularizer.L1Decay(0.01), None
    if reg == "l2":
        return fl.regularizer.L2Decay(0.1), None
    if reg == "per_param":  # the parameter's own wins over the optimizer's
        return fl.regularizer.L2Decay(0.1), fl.regularizer.L1Decay(0.05)
    return None, None


def _clipping(fl, clip):
    """(the optimizer's grad_clip, set_gradient_clip's, the first
    weight's own)."""
    if clip == "by_value":
        return None, fl.clip.GradientClipByValue(0.05), None
    if clip == "by_norm":
        return None, fl.clip.GradientClipByNorm(0.1), None
    if clip == "by_global_norm":
        return fl.clip.GradientClipByGlobalNorm(0.5), None, None
    if clip == "per_param":
        return None, None, fl.clip.GradientClipByValue(0.02, -0.01)
    return None, None, None


def _classifier(fl, reg="none", clip="none", opt=None):
    """x [8] -> fc 6 relu -> fc 3 softmax -> mean cross entropy, with
    ``opt(fl, regularization, grad_clip)`` (SGD by default) minimizing
    it.  Returns (main, startup, loss)."""
    opt_reg, w0_reg = _regularization(fl, reg)
    grad_clip, global_clip, w0_clip = _clipping(fl, clip)
    main, startup = fl.Program(), fl.Program()
    fl.clip.set_gradient_clip(global_clip)
    try:
        with fl.program_guard(main, startup), fl.unique_name.guard():
            x = fl.layers.data(name="x", shape=[8], dtype="float32")
            y = fl.layers.data(name="y", shape=[1], dtype="int64")
            h = fl.layers.fc(x, 6, act="relu", param_attr=fl.ParamAttr(
                name="w0", regularizer=w0_reg, gradient_clip=w0_clip))
            p = fl.layers.fc(h, 3, act="softmax",
                             param_attr=fl.ParamAttr(name="w1"))
            loss = fl.layers.mean(fl.layers.cross_entropy(p, y))
            if opt is None:
                fl.optimizer.SGD(LR, regularization=opt_reg,
                                 grad_clip=grad_clip).minimize(loss)
            else:
                opt(fl, opt_reg, grad_clip).minimize(loss)
    finally:
        fl.clip.set_gradient_clip(None)
    return main, startup, loss


def _data(seed=9, n=40):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(n, 8).astype("float32"),
            "y": rng.randint(0, 3, (n, 1)).astype("int64")}


def op_list(program):
    def attr(v):
        if isinstance(v, np.generic):
            return v.item()
        return list(v) if isinstance(v, tuple) else v

    return json.loads(json.dumps([
        [op.type, op.inputs, op.outputs,
         {k: attr(v) for k, v in sorted(op.attrs.items())}]
        for op in program.global_block().ops], default=str))


def train_both(build, steps=STEPS, feed=None):
    """``build(fl)`` -> (main, startup, loss) in each package; the JAX
    package's initial parameters in both; ``steps`` runs each.  Returns
    ({pkg: losses}, the initial parameters)."""
    feed = feed or _data()
    progs = {k: build(fl) for k, fl in PKGS.items()}
    jmain, jstartup, _ = progs["jax"]
    jscope = jfluid.Scope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstartup, scope=jscope)
    init = {p.name: np.array(jscope.get(p.name))
            for p in jmain.all_parameters()}
    tmain, tstartup, _ = progs["torch"]
    tscope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(tstartup, scope=tscope)
    convert.load_params(tscope, init, tfluid.CPUPlace(), program=tmain)
    losses = {}
    for k, scope in (("jax", jscope), ("torch", tscope)):
        fl = PKGS[k]
        main, _, loss = progs[k]
        exe = fl.Executor(fl.CPUPlace())
        with fl.scope_guard(scope):
            losses[k] = [float(np.asarray(exe.run(
                main, feed=feed, fetch_list=[loss], scope=scope)[0]))
                for _ in range(steps)]
    return losses, init


@pytest.mark.parametrize("clip", CLIPS)
@pytest.mark.parametrize("reg", REGS)
def test_regularizer_and_clip_match_jax(reg, clip):
    ops = {k: op_list(_classifier(fl, reg, clip)[0])
           for k, fl in PKGS.items()}
    assert ops["torch"] == ops["jax"]
    types = [op[0] for op in ops["torch"]]
    want = {"none": set(), "l1": {"sign", "scale", "sum"},
            "l2": {"scale", "sum"}, "per_param": {"sign", "scale", "sum"}}
    assert want[reg] <= set(types)
    n_clip = {"none": 0, "by_value": 4, "by_norm": 0, "by_global_norm": 1,
              "per_param": 1}
    assert types.count("clip") == n_clip[clip]
    assert types.count("clip_by_norm") == (4 if clip == "by_norm" else 0)
    if clip == "by_global_norm":  # w0, b0, w1, b1
        assert types.count("squared_l2_norm") == 4
        assert types.count("elementwise_mul") == 4
    losses, _ = train_both(lambda fl: _classifier(fl, reg, clip))
    np.testing.assert_allclose(losses["torch"], losses["jax"],
                               rtol=LOSS_RTOL)
    assert losses["torch"][-1] < losses["torch"][0]


def test_dp_parity_with_regularizer_and_clip():
    """The JAX package's test of the same name on the port: over four
    CPU replicas the transpile all-reduces the raw gradients ahead of
    the decay and the clip, so they see the whole gradient and the run
    equals one replica's (the reference's rtol 3e-4); that single run
    equals the JAX package's."""
    feed = _data()

    def build(fl):
        return _classifier(fl, "l2", "by_global_norm")

    single, init = train_both(build, feed=feed)
    np.testing.assert_allclose(single["torch"], single["jax"],
                               rtol=LOSS_RTOL)
    main, startup, loss = build(tfluid)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    convert.load_params(scope, init, tfluid.CPUPlace(), program=main)
    prog = tfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss.name, places=[tfluid.CPUPlace()] * 4)
    dp = [float(np.mean(exe.run(prog, feed=feed, fetch_list=[loss],
                                scope=scope)[0])) for _ in range(STEPS)]
    types = [op.type for op in main.global_block().ops]
    assert "c_allreduce_sum" in types
    last_reduce = max(i for i, t in enumerate(types)
                      if t == "c_allreduce_sum")
    assert last_reduce < types.index("squared_l2_norm")
    assert last_reduce < types.index("scale")
    np.testing.assert_allclose(dp, single["torch"], rtol=3e-4)


def test_minimize_startup_program_places_accumulators_as_jax():
    """``minimize(startup_program=other)`` is accepted, and the
    accumulators and the learning rate go to the default startup
    program (the program_guard's), ``other`` staying empty — as in the
    JAX package."""
    got = {}
    for k, fl in PKGS.items():
        main, startup, other = fl.Program(), fl.Program(), fl.Program()
        with fl.program_guard(main, startup), fl.unique_name.guard():
            x = fl.layers.data(name="x", shape=[8], dtype="float32")
            loss = fl.layers.mean(fl.layers.fc(x, 3))
            fl.optimizer.Adam(1e-3).minimize(loss, startup_program=other)
        got[k] = (sorted(startup.global_block().vars),
                  [op.type for op in startup.global_block().ops],
                  sorted(other.global_block().vars),
                  len(other.global_block().ops))
    assert got["torch"] == got["jax"]
    assert any("moment1" in n for n in got["torch"][0])
    assert got["torch"][2:] == ([], 0)


def test_fc_over_two_inputs_matches_jax():
    """``fc([a, b], size)``: a ``mul`` a input, their ``sum``, the bias
    and the activation; the same op list and output as the JAX
    package's."""
    rng = np.random.RandomState(2)
    feed = {"a": rng.randn(5, 4).astype("float32"),
            "b": rng.randn(5, 2, 3).astype("float32")}
    out, ops, init = {}, {}, None
    for k, fl in PKGS.items():
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup), fl.unique_name.guard():
            a = fl.layers.data(name="a", shape=[4], dtype="float32")
            b = fl.layers.data(name="b", shape=[2, 3], dtype="float32")
            y = fl.layers.fc([a, b], 7, act="tanh")
        ops[k] = op_list(main)
        scope = fl.Scope()
        exe = fl.Executor(fl.CPUPlace())
        with fl.scope_guard(scope):
            exe.run(startup, scope=scope)
            if init is None:
                init = {p.name: np.array(scope.get(p.name))
                        for p in main.all_parameters()}
            else:
                convert.load_params(scope, init, fl.CPUPlace(),
                                    program=main)
            out[k] = np.asarray(exe.run(main, feed=feed, fetch_list=[y],
                                        scope=scope)[0])
    assert ops["torch"] == ops["jax"]
    assert [op[0] for op in ops["torch"]] == [
        "mul", "mul", "sum", "elementwise_add", "tanh"]
    assert out["torch"].shape == (5, 7)
    np.testing.assert_allclose(out["torch"], out["jax"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("reg,clip", [("l2", "by_global_norm"),
                                      ("none", "by_value"),
                                      ("l1", "none")])
def test_quantized_transpile_keeps_clipped_updates_unfused_as_jax(reg,
                                                                  clip):
    """With the quantized all-reduce and the fused update on, a gradient
    that a regularizer or clip op reads keeps its unfused update and its
    bucket's dequantized all-reduce: the JAX package's transpile op for
    op, and no ``fused_*_quant_grad`` op."""
    from paddle_tpu.parallel import data_parallel as jdp
    from paddle_tpu_torch.parallel import data_parallel as tdp

    ops = {}
    for k, fl in PKGS.items():
        main, _, loss = _classifier(fl, reg, clip)
        (jdp if k == "jax" else tdp).transpile_data_parallel(
            main, loss.name, 4, quant_grads=True, quant_block_size=16,
            fused_update=True, overlap=True)
        ops[k] = op_list(main)
    assert ops["torch"] == ops["jax"]
    types = [op[0] for op in ops["torch"]]
    assert "c_allreduce_quant" in types
    assert not any(t.startswith("fused_") for t in types)
