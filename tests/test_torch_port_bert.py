"""BERT pretraining in the PyTorch port against the JAX package, on the
CPU.

A child process (tests/torch_port_bert_oracle.py) builds BERT-tiny
(flash attention, attention and hidden dropout 0) with Adam(1e-4) in
the JAX package and dumps its post-pass op list, initial parameters, 20
per-step fp32 losses and final parameters, and 5 steps under the bf16
dtype policy.  The port builds the same program with its own front
end, loads the initial parameters through ``convert.load_params`` on
CPUPlace and must give:

- the same op list after the graph passes (types, slots, attrs);
- fp32: every loss within 1e-4 relative, final parameters within 1e-5
  absolute (the same fp32 math summed in another order);
- bf16 policy: losses within 1e-3 relative, final parameters within
  2e-3 absolute (bf16 rounds at other places in the two frameworks, and
  an Adam step moves an element by up to about lr = 1e-4 whichever sign
  its grad has, so a near-zero grad rounded the other way moves it by up
  to 2·lr a step).

Also here: the two repairs this slice needed — K4 on bf16 input, and
``fused_bias_act_dropout_grad`` lowering in a program the
``fuse_bias_act_dropout`` pass rewrote.
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

from paddle_tpu.kernels import fused_bias_act as jfba

from paddle_tpu_torch import convert, fluid, passes
from paddle_tpu_torch.fluid.contrib.mixed_precision import enable_bf16_policy
from paddle_tpu_torch.kernels import fused_bias_act as tfba
from paddle_tpu_torch.models import bert

ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_port_bert_oracle.py")
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-5
BF16_LOSS_RTOL, BF16_PARAM_ATOL = 1e-3, 2e-3


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    out = tmp_path_factory.mktemp("bert_oracle") / "oracle.npz"
    r = subprocess.run([sys.executable, ORACLE, str(out)],
                       capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.dirname(ORACLE)))
    assert r.returncode == 0 and "TORCH_PORT_BERT_ORACLE_OK" in r.stdout, (
        f"JAX oracle child failed rc={r.returncode}\n{r.stderr[-3000:]}")
    z = np.load(out)
    return {k: z[k] for k in z.files}


def _build():
    cfg = bert.BertConfig.tiny(use_flash_attention=True, attn_dropout=0.0,
                               hidden_dropout=0.0)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _, loss, _, _ = bert.build_bert_pretrain(cfg)
        fluid.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    return main, startup, loss


def _prefixed(oracle, prefix):
    return {k[len(prefix):]: v for k, v in oracle.items()
            if k.startswith(prefix)}


def _train(oracle, steps, bf16=False):
    main, startup, loss = _build()
    if bf16:
        enable_bf16_policy(main)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    convert.load_params(scope, _prefixed(oracle, "init:"), fluid.CPUPlace(),
                        program=main)
    feed = _prefixed(oracle, "feed:")
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0]) for _ in range(steps)]
    return main, np.asarray(losses), scope


def _op_list(program):
    def attr(v):
        return list(v) if isinstance(v, tuple) else v

    return json.loads(json.dumps([
        [op.type, op.inputs, op.outputs,
         {k: attr(v) for k, v in sorted(op.attrs.items())}]
        for op in program.global_block().ops], default=str))


def test_training_program_matches_jax_op_list(oracle):
    main, _, _ = _build()
    passes.apply_graph_passes(main)
    got, want = _op_list(main), json.loads(str(oracle["ops"]))
    assert [op[0] for op in got] == [op[0] for op in want]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"op {i}: {g} != {w}"
    types = {op[0] for op in got}
    assert {"flash_attention_grad", "fused_bias_act_dropout_grad", "sum",
            "adam"} <= types and "gelu_grad" not in types


def test_training_program_var_shapes_match_jax():
    """Build-time shape inference (meta tensors here, eval_shape there)
    gives every var of the training program the JAX package's shape and
    dtype (an int64 there is int32: x64 is off)."""
    from paddle_tpu import fluid as jfluid
    from paddle_tpu.models import bert as jbert

    vars_ = []
    for fl, bt in ((jfluid, jbert), (fluid, bert)):
        cfg = bt.BertConfig.tiny(use_flash_attention=True, attn_dropout=0.0,
                                 hidden_dropout=0.0)
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup), fl.unique_name.guard():
            _, loss, _, _ = bt.build_bert_pretrain(cfg)
            fl.optimizer.Adam(learning_rate=1e-4).minimize(loss)
        vars_.append({n: (v.shape, v.dtype.replace("int64", "int32"))
                      for n, v in main.global_block().vars.items()})
    assert vars_[1] == vars_[0]


def test_fp32_training_matches_jax(oracle):
    main, losses, scope = _train(oracle, len(oracle["loss"]))
    np.testing.assert_allclose(losses, oracle["loss"], rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    final = _prefixed(oracle, "final:")
    assert set(final) == {p.name for p in main.all_parameters()}
    for name, want in final.items():
        np.testing.assert_allclose(scope.get(name).numpy(), want,
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


def test_bf16_policy_training_matches_jax(oracle):
    main, losses, scope = _train(oracle, len(oracle["bf16_loss"]),
                                 bf16=True)
    np.testing.assert_allclose(losses, oracle["bf16_loss"],
                               rtol=BF16_LOSS_RTOL)
    for name, want in _prefixed(oracle, "bf16_final:").items():
        got = scope.get(name)
        assert got.dtype == torch.float32, name  # fp32 masters
        np.testing.assert_allclose(got.numpy(), want, atol=BF16_PARAM_ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("approximate", [False, True])
def test_bias_gelu_bf16_plain_matches_jax(approximate):
    """Repair 1: K4 takes bf16 x and bias (the bf16 policy's inputs),
    computes in fp32 and returns bf16, as the JAX function does."""
    rng = np.random.RandomState(4)
    x = rng.randn(6, 48).astype(np.float32) * 3
    b = rng.randn(48).astype(np.float32)
    want, _ = jfba.fused_bias_gelu_dropout(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
        approximate=approximate)
    got = tfba.fused_bias_gelu(torch.from_numpy(x).bfloat16(),
                               torch.from_numpy(b).bfloat16(),
                               approximate=approximate)
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    # both round the same fp32 value: at most one bf16 ulp apart
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=8e-3, atol=8e-3)


def test_fused_grad_op_runs_in_rewritten_program():
    """Repair 2: a training program the fuse_bias_act_dropout pass
    rewrites (fc(act="gelu") + dropout) runs, and the grads through
    ``fused_bias_act_dropout_grad`` equal autograd of the same function
    with the mask the forward drew."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.data("x", [8])
        h = fluid.layers.fc(x, 16, act="gelu")
        h = fluid.layers.dropout(h, 0.3,
                                 dropout_implementation="upscale_in_train")
        loss = fluid.layers.mean(fluid.layers.fc(h, 1))
        fluid.backward.append_backward(loss)
    startup.random_seed = 3
    passes.apply_graph_passes(main)
    types = [op.type for op in main.global_block().ops]
    assert "fused_bias_act_dropout_grad" in types
    assert not {"gelu", "gelu_grad", "dropout", "dropout_grad"} & set(types)
    fused = next(op for op in main.global_block().ops
                 if op.type == "fused_bias_act_dropout")
    mask_name = fused.outputs["Mask"][0]
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    xv = np.random.RandomState(0).randn(4, 8).astype(np.float32)
    mask, gw, gb = exe.run(main, feed={"x": xv},
                           fetch_list=[mask_name, "fc_0.w_0@GRAD",
                                       "fc_0.b_0@GRAD"], scope=scope)
    assert mask.dtype == np.uint8 and 0 < mask.mean() < 1
    w0, b0, w1, b1 = (scope.get(n).clone().requires_grad_()
                      for n in ("fc_0.w_0", "fc_0.b_0", "fc_1.w_0",
                                "fc_1.b_0"))
    pre = torch.from_numpy(xv) @ w0 + b0
    y = (tfba.gelu_reference(pre) * torch.from_numpy(mask) / 0.7) @ w1 + b1
    want_w, want_b = torch.autograd.grad(y.mean(), (w0, b0))
    np.testing.assert_allclose(gw, want_w.numpy(), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(gb, want_b.numpy(), atol=1e-6, rtol=1e-5)
