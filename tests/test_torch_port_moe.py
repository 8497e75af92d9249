"""The mixture-of-experts FFN in the PyTorch port against the JAX
package, on the CPU (``ops/nn_ops.py`` ``moe_ffn``, ``layers.moe_ffn``,
``BertConfig(moe_experts=, moe_top_k=)``).

- The op: the same seeded numpy inputs and attrs through both
  registries, its forward and its grad op (the port's derived by
  autograd through the forward lowering, the JAX package's by
  ``jax.vjp``): top 2 of 4 experts, a gate whose columns tie (so more
  than k experts stay: the mask is ``probs >= kth``, not the top-k
  indices) and ``act="relu"``; the forward also at top_k = E (no
  mask), without biases, and on bf16 experts (the bf16 policy's) with
  the gate still accumulated in fp32.
  Tolerances: fp32 forward within 1e-5 of the JAX output's largest
  magnitude, grads within 1e-4 of each grad's (sums in another order);
  bf16 forward within 2e-2 (both round fp32 results to bf16).
- The layer: BERT-tiny with ``moe_experts=4, moe_top_k=2`` builds the
  JAX package's program (op list, parameter names, shapes and
  initializers).
- BERT-tiny at one layer with ``moe_experts=4`` trained 3 Adam steps
  from one state
  (the port's startup values copied into the JAX package's scope):
  losses within 1e-4 relative, parameters within 1e-5 absolute (a
  tenth of lr, the gate of tests/test_torch_port_bert.py).
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.ops  # noqa: F401  (registers the JAX lowerings)
from paddle_tpu import fluid as jfluid
from paddle_tpu.fluid import registry as jreg
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch.ops  # noqa: F401  (registers the port's lowerings)
from paddle_tpu_torch import fluid
from paddle_tpu_torch.fluid import registry as treg
from paddle_tpu_torch.models import bert

FWD_TOL, GRAD_TOL, BF16_TOL = 1e-5, 1e-4, 2e-2
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-5


def _f(*shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _case(e=4, d=8, h=16, tie=False, bias=True):
    x = _f(2, 5, d, seed=1)
    gate = _f(d, e, seed=2, scale=0.5)
    if tie:  # experts 1..E-1 get the same logit: their probs tie exactly
        gate[:, 1:] = gate[:, 1:2]
    w1, w2 = _f(e, d, h, seed=3, scale=0.3), _f(e, h, d, seed=4, scale=0.3)
    b1 = _f(e, h, seed=5, scale=0.1) if bias else None
    b2 = _f(e, d, seed=6, scale=0.1) if bias else None
    return [x, gate, w1, b1, w2, b2]


CASES = {"top2": (_case(), {"top_k": 2, "act": "gelu"}),
         "tie": (_case(tie=True), {"top_k": 2, "act": "gelu"}),
         "relu": (_case(), {"top_k": 2, "act": "relu"}),
         "top_all": (_case(e=3), {"top_k": 3, "act": "gelu"}),
         "no_bias": (_case(bias=False), {"top_k": 2, "act": "gelu"})}
GRAD_CASES = ("top2", "tie", "relu")


def _jax(op_type, inputs, attrs, dtype=jnp.float32):
    """The JAX registry's lowering of ``op_type``, jitted as one program
    (op by op, each primitive would compile on its own)."""
    import jax

    ctx = jreg.LowerContext(step=0)
    ctx.op_index = 0
    given = [i for i, a in enumerate(inputs) if a is not None]

    def run(*vals):
        full = [None] * len(inputs)
        for i, v in zip(given, vals):
            full[i] = v
        return jreg.get_op(op_type).lower(ctx, *full, attrs=dict(attrs))

    out = jax.jit(run)(*[jnp.asarray(inputs[i], dtype) for i in given])
    outs = out if isinstance(out, tuple) else (out,)
    return [None if o is None else np.asarray(o.astype(jnp.float32))
            for o in outs]


def _port(op_type, inputs, attrs, dtype=torch.float32):
    vals = [None if a is None else torch.from_numpy(a).to(dtype)
            for a in inputs]
    out = treg.get_op(op_type).lower(treg.LowerContext("cpu"), *vals,
                                     attrs=dict(attrs))
    outs = out if isinstance(out, tuple) else (out,)
    return [None if o is None else o.float().numpy() for o in outs]


def _close(got, want, tol, what):
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol * max(float(np.abs(want).max()), 1e-30), (what, err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_ffn_matches_jax(case):
    inputs, attrs = CASES[case]
    (got,), (want,) = _port("moe_ffn", inputs, attrs), _jax("moe_ffn",
                                                             inputs, attrs)
    _close(got, want, FWD_TOL, case)


@pytest.mark.parametrize("case", GRAD_CASES)
def test_moe_ffn_grad_matches_jax(case):
    inputs, attrs = CASES[case]
    dout = _f(*inputs[0].shape, seed=9)
    got = _port("moe_ffn_grad", inputs + [dout], attrs)
    want = _jax("moe_ffn_grad", inputs + [dout], attrs)
    assert len(got) == len(want) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None) == (inputs[i] is None), i
        if g is not None:
            _close(g, w, GRAD_TOL, f"{case} grad {i}")


def test_tied_gate_keeps_more_than_k_experts():
    """With experts 1..3 tied, every token keeps at least three experts
    (the k-th largest probability is the tied one); a combine by the
    top-k indices would keep two and give another output."""
    inputs, attrs = CASES["tie"]
    x, gate = (torch.from_numpy(a) for a in inputs[:2])
    probs = torch.softmax(torch.einsum("bsd,de->bse", x, gate), -1)
    kth = torch.topk(probs, 2, dim=-1).values[..., -1:]
    assert ((probs >= kth).sum(-1) >= 3).all()
    (got,) = _port("moe_ffn", inputs, attrs)
    idx = torch.topk(probs, 2, dim=-1).indices
    two = torch.zeros_like(probs).scatter(-1, idx, 1.0) * probs
    two = two / two.sum(-1, keepdim=True)
    w1, b1, w2, b2 = (torch.from_numpy(a) for a in inputs[2:])
    h = torch.einsum("bsd,edh->ebsh", x, w1) + b1[:, None, None, :]
    h = 0.5 * h * (1 + torch.tanh(0.7978845608028654
                                  * (h + 0.044715 * h * h * h)))
    y = torch.einsum("ebsh,ehd->ebsd", h, w2) + b2[:, None, None, :]
    by_index = torch.einsum("ebsd,bse->bsd", y, two).numpy()
    assert float(np.abs(got - by_index).max()) > 1e-3


def test_moe_ffn_bf16_keeps_the_gate_in_fp32():
    """bf16 experts (the bf16 policy's inputs): the output is bf16 and
    within one bf16 rounding of the JAX op's on the same bf16 values;
    the gate's logits, softmax and mask run in fp32 in both."""
    inputs, attrs = CASES["top2"]
    bf = [None if a is None else
          torch.from_numpy(a).bfloat16().float().numpy() for a in inputs]
    vals = [None if a is None else torch.from_numpy(a).bfloat16()
            for a in bf]
    out = treg.get_op("moe_ffn").lower(treg.LowerContext("cpu"), *vals,
                                       attrs=dict(attrs))
    assert out.dtype == torch.bfloat16
    (want,) = _jax("moe_ffn", bf, attrs, dtype=jnp.bfloat16)
    _close(out.float().numpy(), want, BF16_TOL, "bf16")


def _build(pkg, num_layers=2):
    fl, bm = (jfluid, jbert) if pkg == "jax" else (fluid, bert)
    cfg = bm.BertConfig.tiny(use_flash_attention=True, attn_dropout=0.0,
                             hidden_dropout=0.0, moe_experts=4, moe_top_k=2,
                             num_layers=num_layers)
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        _, loss, _, _ = bm.build_bert_pretrain(cfg)
        fl.optimizer.Adam(1e-4).minimize(loss)
    return cfg, main, startup, loss


def _desc(main, startup):
    ops = [(op.type, {k: list(v) for k, v in op.inputs.items()},
            {k: list(v) for k, v in op.outputs.items()},
            {k: (list(v) if isinstance(v, tuple) else v)
             for k, v in sorted(op.attrs.items())})
           for op in main.global_block().ops]
    params = [(p.name, list(p.shape), p.dtype) for p in main.all_parameters()]
    init = [(op.type, op.outputs["Out"], {k: v for k, v in op.attrs.items()
                                          if k != "seed"})
            for op in startup.global_block().ops]
    return ops, params, init


def test_moe_bert_builds_the_jax_program():
    _, tmain, tstart, _ = _build("port")
    _, jmain, jstart, _ = _build("jax")
    got, want = _desc(tmain, tstart), _desc(jmain, jstart)
    assert [o[0] for o in got[0]] == [o[0] for o in want[0]]
    for i, (g, w) in enumerate(zip(got[0], want[0])):
        assert g == w, f"op {i}: {g} != {w}"
    assert got[1] == want[1]
    assert got[2] == want[2]
    moe = [op for op in tmain.global_block().ops if op.type == "moe_ffn"]
    assert len(moe) == 2 and moe[0].attrs == {"top_k": 2, "act": "gelu"}
    assert "moe_ffn_grad" in [op.type for op in tmain.global_block().ops]


def test_moe_bert_tiny_trains_like_jax():
    cfg, tmain, tstart, tloss = _build("port", num_layers=1)
    _, jmain, jstart, jloss = _build("jax", num_layers=1)
    tscope, texe = fluid.Scope(), fluid.Executor(fluid.CPUPlace())
    texe.run(tstart, scope=tscope)
    jscope, jexe = jfluid.Scope(), jfluid.Executor(jfluid.CPUPlace())
    names = [n for n, v in jmain.global_block().vars.items()
             if v.persistable]
    for n in names:
        jscope.set(n, jnp.asarray(tscope.get(n).numpy()))
    feed = bert.make_fake_batch(cfg, 4, 32)
    losses = []
    for _ in range(3):
        with jfluid.scope_guard(jscope):
            (jl,) = jexe.run(jmain, feed=feed, fetch_list=[jloss.name])
        (tl,) = texe.run(tmain, feed=feed, fetch_list=[tloss], scope=tscope)
        losses.append((float(tl), float(np.asarray(jl))))
    got, want = np.array(losses).T
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]
    for p in tmain.all_parameters():
        np.testing.assert_allclose(tscope.get(p.name).numpy(),
                                   np.asarray(jscope.get(p.name)), rtol=0,
                                   atol=PARAM_ATOL, err_msg=p.name)
