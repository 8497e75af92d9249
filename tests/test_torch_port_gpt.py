"""GPT causal-LM training in the PyTorch port against the JAX package,
on the CPU.

A child process (tests/torch_port_gpt_oracle.py) builds GPT-tiny (2
layers, dropout 0) in the JAX package, with flash attention in the
program or the composed causal chain the default passes rewrite, and
with Adam(1e-4) or AdamW(1e-4) under GradientClipByGlobalNorm; it
dumps the post-pass op list, the initial parameters, 10 fp32 steps'
losses (and the clip's global norms) and final parameters, and 5 steps
under the bf16 dtype policy.  The port builds the same program with
its own front end, loads the initial parameters through
``convert.load_params`` on CPUPlace and must give:

- the same op list after the graph passes (types, slots, attrs): the
  unfused build's attention is the causal ``flash_attention`` there too;
- fp32: every loss within 1e-4 relative, final parameters within 1e-5
  absolute (the same fp32 math summed in another order); the global
  norms within 1e-4 relative;
- bf16 policy: losses within 1e-3 relative, final parameters within
  2e-3 absolute (the BERT test's tolerances and reasons: bf16 rounds at
  other places in the two frameworks, and an Adam step moves an element
  by up to about lr = 1e-4 whichever sign its grad has).
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch import convert, fluid, passes
from paddle_tpu_torch.fluid.contrib.mixed_precision import enable_bf16_policy
from paddle_tpu_torch.models import gpt

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_port_gpt_oracle as gpt_oracle  # noqa: E402  (no jax import)

ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_port_gpt_oracle.py")
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-5
BF16_LOSS_RTOL, BF16_PARAM_ATOL = 1e-3, 2e-3
CASES = [("flash", "adam"), ("flash", "adamw_clip"), ("unfused", "adam"),
         ("unfused", "adamw_clip")]


def _oracle(tmp_path, build, opt):
    out = tmp_path / "oracle.npz"
    r = subprocess.run([sys.executable, ORACLE, str(out), build, opt],
                       capture_output=True, text=True, timeout=600,
                       cwd=os.path.dirname(os.path.dirname(ORACLE)))
    assert r.returncode == 0 and "TORCH_PORT_GPT_ORACLE_OK" in r.stdout, (
        f"JAX oracle child failed rc={r.returncode}\n{r.stderr[-3000:]}")
    z = np.load(out)
    return {k: z[k] for k in z.files}


def _build(build, opt):
    _, main, startup, loss = gpt_oracle.build(fluid, gpt, build, opt)
    return main, startup, loss


def _prefixed(oracle, prefix):
    return {k[len(prefix):]: v for k, v in oracle.items()
            if k.startswith(prefix)}


def _train(oracle, build, opt, steps, bf16=False):
    main, startup, loss = _build(build, opt)
    if bf16:
        enable_bf16_policy(main)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    init = _prefixed(oracle, "init:")
    loaded = convert.load_params(scope, init, fluid.CPUPlace(), program=main)
    assert loaded == sorted(init) == sorted(
        p.name for p in main.all_parameters())
    fetch = [loss]
    if opt != "adam":
        fetch.append(gpt_oracle.global_norm_name(main))
    feed = _prefixed(oracle, "feed:")
    losses, norms = [], []
    for _ in range(steps):
        out = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
        losses.append(float(out[0]))
        norms += [float(v.reshape(())) for v in out[1:]]
    return main, np.asarray(losses), np.asarray(norms), scope


def _op_list(program):
    def attr(v):
        return list(v) if isinstance(v, tuple) else v

    return json.loads(json.dumps([
        [op.type, op.inputs, op.outputs,
         {k: attr(v) for k, v in sorted(op.attrs.items())}]
        for op in program.global_block().ops], default=str))


@pytest.mark.parametrize("build,opt", CASES,
                         ids=[f"{b}-{o}" for b, o in CASES])
def test_gpt_lm_training_matches_jax(tmp_path, build, opt):
    oracle = _oracle(tmp_path, build, opt)
    main, _, _ = _build(build, opt)
    passes.apply_graph_passes(main)
    got, want = _op_list(main), json.loads(str(oracle["ops"]))
    assert [op[0] for op in got] == [op[0] for op in want]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, f"op {i}: {g} != {w}"
    types = [op[0] for op in got]
    assert types.count("flash_attention") == 2
    assert all(op[3]["causal"] for op in got if op[0] == "flash_attention")
    assert "softmax_mask_fuse_upper_triangle" not in types
    if opt == "adamw_clip":
        assert types.count("squared_l2_norm") == len(main.all_parameters())

    main, losses, norms, scope = _train(oracle, build, opt,
                                        len(oracle["loss"]))
    np.testing.assert_allclose(losses, oracle["loss"], rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(norms, oracle["gnorm"], rtol=LOSS_RTOL)
    if opt == "adamw_clip":  # the clip scaled every step's gradients
        assert (norms > gpt_oracle.CLIP_NORM).all()
    final = _prefixed(oracle, "final:")
    assert set(final) == {p.name for p in main.all_parameters()}
    for name, want in final.items():
        np.testing.assert_allclose(scope.get(name).numpy(), want,
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)

    _, losses, _, scope = _train(oracle, build, opt,
                                 len(oracle["bf16_loss"]), bf16=True)
    np.testing.assert_allclose(losses, oracle["bf16_loss"],
                               rtol=BF16_LOSS_RTOL)
    for name, want in _prefixed(oracle, "bf16_final:").items():
        got = scope.get(name)
        assert got.dtype == torch.float32, name  # fp32 masters
        np.testing.assert_allclose(got.numpy(), want, atol=BF16_PARAM_ATOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("build", ["flash", "unfused"])
def test_gpt_lm_var_shapes_match_jax(build):
    """Build-time shape inference gives every var of the training
    program (with AdamW and the global-norm clip) the JAX package's
    shape and dtype (an int64 there is int32: x64 is off)."""
    from paddle_tpu import fluid as jfluid
    from paddle_tpu.models import gpt as jgpt

    vars_ = []
    for fl, g in ((jfluid, jgpt), (fluid, gpt)):
        cfg = g.GPTConfig.tiny(num_layers=2, hidden_dropout=0.1,
                               use_flash_attention=build == "flash")
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup), fl.unique_name.guard():
            _, loss = g.build_gpt_lm(cfg)
            gpt_oracle.optimizer(fl, "adamw_clip").minimize(loss)
        vars_.append({n: (v.shape, v.dtype.replace("int64", "int32"))
                      for n, v in main.global_block().vars.items()})
    assert vars_[1] == vars_[0]


def test_make_fake_lm_batch_matches_jax():
    from paddle_tpu.models import gpt as jgpt

    for seed in (0, 3):
        want = jgpt.make_fake_lm_batch(jgpt.GPTConfig.tiny(), 3, 17, seed)
        got = gpt.make_fake_lm_batch(gpt.GPTConfig.tiny(), 3, 17, seed)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
            assert got[k].dtype == want[k].dtype


def test_kv_sink_stamps_the_cache_dtype():
    """``KVSink(dtype=...)`` casts every layer's K and V to the cache
    dtype (the JAX package's op list); a plain list adds no op."""
    from paddle_tpu import fluid as jfluid
    from paddle_tpu.models import gpt as jgpt

    got = {}
    for key, fl, g in (("jax", jfluid, jgpt), ("torch", fluid, gpt)):
        for sink in (g.KVSink(dtype="float32"), []):
            cfg = g.GPTConfig.tiny(num_layers=2)
            main, startup = fl.Program(), fl.Program()
            with fl.program_guard(main, startup), fl.unique_name.guard():
                ids = fl.data("ids", [-1, -1], False, dtype="int64")
                pos = fl.data("pos", [-1, -1], False, dtype="int64")
                g.gpt_decoder(ids, pos, cfg, is_test=True, kv_sink=sink)
            got[key, isinstance(sink, g.KVSink)] = (
                [op.type for op in main.global_block().ops], len(sink),
                getattr(sink, "shapes", None))
    assert got["torch", True] == got["jax", True]
    assert got["torch", False] == got["jax", False]
    assert got["torch", True][0].count("cast") == 4
    assert "cast" not in got["torch", False][0]
