"""Dual-int8 weight storage of the PyTorch port against the JAX package:
the weight codec (codes bit-equal), the ``int8_weight_storage`` pass
and ``quantize_scope_weights`` on the JAX package's MLP test program,
the fake-quantize ops and ``dequantize_weight_storage`` against the JAX
registry, and ``DecodeEngine(int8_weights=True)`` on the tiny trained
GPT, token-exact with the JAX package's engine (run in a child process,
as tests/test_torch_port_decode.py runs its oracle).

Tolerances: codes and ids exact; the int8 MLP's output within 1e-2 of
fp32 (the codec keeps ~14.6 significant bits) and within 1e-6 of the
JAX int8 run; the fake-quantize ops within 1e-6.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import registry as jreg
from paddle_tpu.kernels.primitives import int8 as jint8
from paddle_tpu.passes import PassContext as JCtx
from paddle_tpu.passes import PassManager as JMgr
from paddle_tpu.passes.int8_weights import \
    quantize_scope_weights as jquantize_scope

from paddle_tpu_torch import convert
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.fluid import registry as treg
from paddle_tpu_torch.kernels.primitives import int8 as tint8
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.passes import PassContext, PassManager
from paddle_tpu_torch.passes import int8_weights as tw
from paddle_tpu_torch.serving import DecodeEngine

HERE = os.path.dirname(os.path.abspath(__file__))


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64, 96), (7, 33), (3, 5, 17)])
def test_weight_codes_bit_equal_to_jax(shape):
    rng = np.random.RandomState(sum(shape))
    w = (rng.randn(*shape) * rng.choice([1e-3, 1.0, 40.0], shape)).astype(
        np.float32)
    w.reshape(-1)[:5] = [0.0, -0.0, 1e-38, 127.5, -3e4]
    got = tint8.quantize_weight(torch.from_numpy(w))
    want = jint8.quantize_weight(jnp.asarray(w))
    for g, x in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    assert got[3] == want[3]
    back = tint8.dequantize_weight(*got[:3], shape)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jint8.dequantize_weight(*want[:3], shape)))
    assert np.abs(back.numpy() - w).max() <= np.abs(w).max() / (127 * 254)
    # the per-row layout the pass stores
    if len(shape) == 2:
        got = tint8.quantize_lastdim(torch.from_numpy(w))
        want = jint8.quantize_lastdim(jnp.asarray(w))
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        np.testing.assert_array_equal(
            tint8.dequantize_lastdim(*got).numpy(),
            np.asarray(jint8.dequantize_lastdim(*want)))


# ---------------------------------------------------------------------------
# the pass and the scope conversion: the JAX package's MLP test
# ---------------------------------------------------------------------------


def _build_mlp(fluid):
    """Two fc weights (eligible), two biases and an embedding table
    (not)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.data("ids", [4, 6], False, dtype="int64")
        x = fluid.layers.embedding(ids, size=[32, 16])
        x = fluid.layers.reduce_mean(x, dim=1)
        h = fluid.layers.fc(x, size=24, act="relu")
        out = fluid.layers.fc(h, size=8)
    return main, startup, out


def _claimed(program):
    return {op.output("Out")[0] for op in program.global_block().ops
            if op.type == "dequantize_weight_storage"}


def _booked_weights():
    fam = tobs.REGISTRY.get("pt_int8_bytes_saved_total")
    samples = fam._snapshot()["samples"] if fam else {}
    return samples.get(("weights",), 0.0)


@pytest.fixture(scope="module")
def jax_mlp():
    """The JAX package's run of the MLP test: its fp32 parameters, its
    fp32 and int8 outputs, its quantized scope and its pass report."""
    main, startup, out = _build_mlp(jfluid)
    feed = {"ids": np.random.RandomState(0).randint(
        0, 32, (4, 6)).astype(np.int64)}
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe = jfluid.Executor(jfluid.CPUPlace())
        exe.run(startup)
        params = {p.name: np.array(scope.get(p.name))
                  for p in main.all_parameters()}
        (ref,) = exe.run(main, feed=feed, fetch_list=[out.name])
        JMgr(["int8_weight_storage"]).run(main, JCtx(lane="single"))
        report = dict(main._pass_report[-1])
        jquantize_scope(scope, main)
        (got,) = exe.run(main, feed=feed, fetch_list=[out.name])
        stored = {n: np.array(scope.get(n)) for n in scope.keys()
                  if n.endswith(tw._SUFFIXES)}
    return dict(feed=feed, params=params, fp32=np.asarray(ref),
                int8=np.asarray(got), report=report, stored=stored,
                claimed=_claimed(main))


def test_int8_weight_storage_mlp_matches_jax(jax_mlp):
    main, startup, out = _build_mlp(tfluid)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    convert.load_params(scope, jax_mlp["params"], tfluid.CPUPlace(),
                        program=main)
    (ref,) = exe.run(main, feed=jax_mlp["feed"], fetch_list=[out],
                     scope=scope)
    np.testing.assert_allclose(ref, jax_mlp["fp32"], rtol=0, atol=1e-6)

    PassManager(["int8_weight_storage"]).run(main, PassContext())
    rep = main._pass_report[-1]
    assert rep["changed"] and rep["sites"] == 2
    assert _claimed(main) == jax_mlp["claimed"]
    block = main.global_block()
    modeled = 0
    for n in _claimed(main):
        r, c = block.vars[n].shape
        assert not block.vars[n].persistable
        modeled += 4 * r * c - (2 * r * c + 4 * r)
    assert rep["modeled_bytes_saved"] == modeled
    assert {k: v for k, v in rep.items() if k not in ("lane",)} == \
        {k: v for k, v in jax_mlp["report"].items() if k not in ("lane",)}
    PassManager(["int8_weight_storage"]).run(main, PassContext())
    assert not main._pass_report[-1]["changed"]

    before = _booked_weights()
    info = tw.quantize_scope_weights(scope, main)
    assert info["weights"] == 2 and info["bytes_saved"] == modeled
    assert _booked_weights() - before == modeled
    for n in _claimed(main):
        assert scope.get(n) is None
        for s in tw.storage_var_names(n):
            np.testing.assert_array_equal(scope.get(s).numpy(),
                                          jax_mlp["stored"][s])
    assert tw.quantize_scope_weights(scope, main)["weights"] == 0

    (got,) = exe.run(main, feed=jax_mlp["feed"], fetch_list=[out],
                     scope=scope)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2)
    np.testing.assert_allclose(got, jax_mlp["int8"], rtol=0, atol=1e-6)


def test_load_params_takes_the_jax_packages_int8_scope(jax_mlp):
    """A scope the JAX package quantized carries over: the claimed
    weights arrive as their storage triples."""
    main, _, out = _build_mlp(tfluid)
    PassManager(["int8_weight_storage"]).run(main, PassContext())
    arrays = {n: a for n, a in jax_mlp["params"].items()
              if n not in jax_mlp["claimed"]}
    scope = tfluid.Scope()
    with pytest.raises(ValueError, match="__qhi: missing"):
        convert.load_params(scope, arrays, tfluid.CPUPlace(), program=main)
    convert.load_params(scope, {**arrays, **jax_mlp["stored"]},
                        tfluid.CPUPlace(), program=main)
    (got,) = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed=jax_mlp["feed"], fetch_list=[out], scope=scope)
    np.testing.assert_allclose(got, jax_mlp["int8"], rtol=0, atol=1e-6)


def _gpt_decode_program(pkg_fluid, pkg_gpt):
    cfg = pkg_gpt.GPTConfig.tiny(num_layers=2, hidden_dropout=0.0,
                                 use_flash_attention=False)
    main = pkg_fluid.Program()
    with pkg_fluid.program_guard(main, pkg_fluid.Program()), \
            pkg_fluid.unique_name.guard():
        pkg_gpt.build_gpt_decode_step(cfg, 2, 9, 4, 8)
    return main


def test_int8_weight_storage_vetoes():
    """A training program claims nothing (every weight feeds a grad
    op); a keep_vars weight keeps fp32; GPT's tied word embedding (a
    lookup_table input too) is never claimed, and the decode program's
    claims equal the JAX package's."""
    from paddle_tpu.models import gpt as jgpt

    main, startup, out = _build_mlp(tfluid)
    with tfluid.program_guard(main, startup):
        loss = tfluid.layers.mean(out)
        tfluid.optimizer.SGD(0.1).minimize(loss)
    PassManager(["int8_weight_storage"]).run(main, PassContext())
    assert main._pass_report[-1]["sites"] == 0

    full = _claimed(_mlp_rewritten())
    pinned = sorted(full)[0]
    assert _claimed(_mlp_rewritten(keep={pinned})) == full - {pinned}

    tdec = _gpt_decode_program(tfluid, tgpt)
    jdec = _gpt_decode_program(jfluid, jgpt)
    PassManager(["int8_weight_storage"]).run(tdec, PassContext())
    JMgr(["int8_weight_storage"]).run(jdec, JCtx())
    assert _claimed(tdec) == _claimed(jdec)
    assert len(_claimed(tdec)) == 12
    assert "gpt_word_embedding" not in _claimed(tdec)


def _mlp_rewritten(keep=()):
    main, _, _ = _build_mlp(tfluid)
    PassManager(["int8_weight_storage"]).run(
        main, PassContext(keep_vars=keep))
    return main


# ---------------------------------------------------------------------------
# the fake-quantize ops and the weight reconstruction against JAX
# ---------------------------------------------------------------------------

_r = np.random.RandomState(7)


def _f(*shape, scale=1.0):
    return np.asarray(_r.randn(*shape) * scale, np.float32)


_one = np.array([0.8], np.float32)
FAKE = {
    "abs_max": ("fake_quantize_abs_max", [_f(4, 9, scale=3)],
                {"bit_length": 8}, {}),
    "abs_max_4bit": ("fake_quantize_abs_max", [_f(6, 5)],
                     {"bit_length": 4}, {}),
    "channel_wise_axis0": ("fake_channel_wise_quantize_abs_max",
                           [_f(3, 4, 5)], {"quant_axis": 0}, {}),
    "channel_wise_axis1": ("fake_channel_wise_quantize_abs_max",
                           [_f(8, 6)], {"quant_axis": 1}, {}),
    "range_window": ("fake_quantize_range_abs_max",
                     [_f(5, 4), _one, np.abs(_f(6)), np.array([9], np.int32)],
                     {"window_size": 6}, {}),
    "range_running": ("fake_quantize_range_abs_max",
                      [_f(5, 4), _one, None, None], {}, {}),
    "range_test": ("fake_quantize_range_abs_max",
                   [_f(5, 4), _one, np.abs(_f(6)), np.array([2], np.int32)],
                   {"window_size": 6}, {"is_test": True}),
    "moving_average": ("fake_quantize_moving_average_abs_max",
                       [_f(4, 7, scale=2), _one, np.array([1.5], np.float32),
                        np.array([2.0], np.float32)],
                       {"moving_rate": 0.9}, {}),
    "moving_average_test": ("fake_quantize_moving_average_abs_max",
                            [_f(4, 7), _one, None, None], {},
                            {"is_test": True}),
    "observe_scale": ("moving_average_abs_max_scale",
                      [_f(3, 8), np.array([0.5], np.float32),
                       np.array([1.0], np.float32)], {"moving_rate": 0.8},
                      {}),
    "observe_scale_first": ("moving_average_abs_max_scale",
                            [_f(3, 8), None, None], {}, {}),
    "dequantize_max_abs": ("fake_dequantize_max_abs",
                           [np.round(_f(4, 5, scale=60)),
                            np.array([3.7], np.float32)],
                           {"max_range": 127.0}, {}),
}


def _lower(reg, kind, op_type, inputs, attrs, ctx_kw):
    if kind == "jax":
        ctx = reg.LowerContext(step=3, is_test=ctx_kw.get("is_test", False))
        ctx.op_index = 0
        vals = [None if a is None else jnp.asarray(a) for a in inputs]
    else:
        ctx = reg.LowerContext("cpu", step=3,
                               is_test=ctx_kw.get("is_test", False))
        vals = [None if a is None else torch.from_numpy(np.array(a))
                for a in inputs]
    out = reg.get_op(op_type).lower(ctx, *vals, attrs=dict(attrs))
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("case", sorted(FAKE))
def test_fake_quant_ops_match_jax(case):
    op_type, inputs, attrs, ctx_kw = FAKE[case]
    got = _lower(treg, "port", op_type, inputs, attrs, ctx_kw)
    want = _lower(jreg, "jax", op_type, inputs, attrs, ctx_kw)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), (case, i)
        if g is None:
            continue
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, (case, i)
        np.testing.assert_allclose(g.astype(np.float64),
                                   w.astype(np.float64), rtol=1e-6,
                                   atol=1e-6, err_msg=f"{case} output {i}")


@pytest.mark.parametrize("case", ["abs_max", "channel_wise_axis1",
                                  "range_window", "moving_average"])
def test_fake_quant_grads_are_straight_through(case):
    """The derived grad op passes dOut through unchanged (the JAX
    package's stop_gradient form), on both sides."""
    op_type, inputs, attrs, ctx_kw = FAKE[case]
    x = inputs[0]
    dout = _f(*x.shape)
    n_out = len(treg.get_op(op_type).output_slots)
    extra = [None] * (n_out - 1)
    got = _lower(treg, "port", op_type + "_grad",
                 inputs + [dout] + extra, attrs, ctx_kw)[0]
    want = _lower(jreg, "jax", op_type + "_grad",
                  inputs + [dout] + extra, attrs, ctx_kw)[0]
    np.testing.assert_array_equal(np.asarray(want), dout)
    np.testing.assert_array_equal(got.numpy(), dout)


def test_dequantize_weight_storage_matches_jax():
    w = _f(12, 20, scale=5)
    hi, lo, sc = (np.asarray(a) for a in jint8.quantize_lastdim(
        jnp.asarray(w)))
    got = _lower(treg, "port", "dequantize_weight_storage", [hi, lo, sc],
                 {}, {})[0]
    want = _lower(jreg, "jax", "dequantize_weight_storage", [hi, lo, sc],
                  {}, {})[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not treg.has_op("dequantize_weight_storage_grad")


# ---------------------------------------------------------------------------
# DecodeEngine(int8_weights=True) against the JAX package's engine
# ---------------------------------------------------------------------------

ENGINE = dict(pool_slots=4, page_size=4, prefill_chunk=4, max_len=32)

_ORACLE = r"""
import sys
import decode_e2e_checks as e2e  # cpu_mesh first, compile cache off
import numpy as np
from paddle_tpu import fluid, serving
from paddle_tpu.models import gpt

cfg, scope, prompts, ref_ids = e2e.build_fixture()
main = fluid.Program()
with fluid.program_guard(main, fluid.Program()), fluid.unique_name.guard():
    gpt.build_gpt_decode_step(cfg, 2, 9, 4, 8)
out = {"prompts": np.asarray(prompts, np.int64)}
for p in main.all_parameters():
    out["param:" + p.name] = np.asarray(scope.get(p.name))
qscope = fluid.Scope()
for n in list(scope.keys()):
    qscope.set(n, scope.get(n))
eng = serving.DecodeEngine(cfg, scope=qscope, auto_start=False,
                           int8_weights=True, **%(engine)s)
try:
    eng.warmup()
    eng.start()
    ids = eng.generate([list(p) for p in prompts], max_new_tokens=6,
                       timeout=300)
finally:
    eng.close()
out["ids_int8"] = np.asarray(ids, np.int64)
for n in list(qscope.keys()):
    if n.endswith(("__qhi", "__qlo", "__scale")):
        out["stored:" + n] = np.asarray(qscope.get(n))
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def jax_int8_engine(tmp_path_factory):
    path = tmp_path_factory.mktemp("int8w") / "oracle.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + os.path.dirname(HERE) + \
        os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c",
                        _ORACLE % {"engine": json.dumps(ENGINE)}, str(path)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, f"JAX oracle child failed\n{r.stderr[-3000:]}"
    z = np.load(path)
    return {k: z[k] for k in z.files}


def _port_scope(oracle):
    main = _gpt_decode_program(tfluid, tgpt)
    scope = tfluid.Scope()
    convert.load_params(scope, {k[6:]: v for k, v in oracle.items()
                                if k.startswith("param:")},
                        tfluid.CPUPlace(), program=main)
    return scope


def _cfg():
    return tgpt.GPTConfig.tiny(num_layers=2, hidden_dropout=0.0,
                               use_flash_attention=False)


def test_decode_engine_int8_weights_token_exact_with_jax(jax_int8_engine):
    oracle = jax_int8_engine
    scope = _port_scope(oracle)
    before = _booked_weights()
    eng = DecodeEngine(_cfg(), scope=scope, place=tfluid.CPUPlace(),
                       auto_start=False, int8_weights=True, **ENGINE)
    try:
        info = eng.stats()["int8_weights"]
        stored = {k[7:] for k in oracle if k.startswith("stored:")}
        assert info["weights"] == 12 == len(stored) // 3
        assert info["bytes_saved"] == info["modeled_bytes_saved"] > 0
        assert _booked_weights() - before == info["bytes_saved"]
        for n in stored:
            np.testing.assert_array_equal(scope.get(n).numpy(),
                                          oracle["stored:" + n])
        claimed = _claimed(eng._dec_prog)
        assert claimed == _claimed(eng._pf_prog)
        assert all(scope.get(n) is None for n in claimed)
        eng.warmup()
        eng.start()
        ids = eng.generate([list(p) for p in oracle["prompts"]],
                           max_new_tokens=6, timeout=300)
    finally:
        eng.close()
    np.testing.assert_array_equal(np.asarray(ids), oracle["ids_int8"])


def test_decode_engine_refuses_unequal_weight_claims(jax_int8_engine,
                                                     monkeypatch):
    """The two programs share one scope: claims that differ fail by
    name before the scope is touched."""
    eligible = tw._eligible_weights

    def fewer_for_prefill(program, ctx):
        names = eligible(program, ctx)
        if "pf_tok" in program.global_block().vars:
            return names[1:]
        return names

    monkeypatch.setattr(tw, "_eligible_weights", fewer_for_prefill)
    scope = _port_scope(jax_int8_engine)
    with pytest.raises(RuntimeError, match="different weight sets"):
        DecodeEngine(_cfg(), scope=scope, place=tfluid.CPUPlace(),
                     auto_start=False, int8_weights=True, **ENGINE)
    assert not any(n.endswith("__qhi") for n in scope.keys())
