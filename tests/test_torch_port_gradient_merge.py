"""``GradientMergeOptimizer``, ``ModelAverage`` and the exponential moving
average of the PyTorch port against the JAX package, on the CPU.

BERT-tiny pretraining (flash attention, dropout 0, fp32) with
``GradientMergeOptimizer(Adam, k_steps=4)`` over an exponentially
decaying learning rate, a ``ModelAverage`` updated in the program, 8
micro-steps over four fixed batches.  Both packages build the program
with their own front ends; the port starts from the JAX package's state
after its startup run, carried across by ``convert.load_checkpoint``
(``_gm_acc``, ``_gm_snap``, the step counter and the averages by name),
and must give:

- the same op list, and ``program._params_grads`` naming the raw
  micro-batch grads;
- every loss within 1e-4 relative and every persistable (parameters,
  Adam's moments and beta powers, the merge accumulators, snapshots and
  counter, the LR counter, the averages) within 1e-5 absolute of the
  JAX package's after each micro-step (the same fp32 math summed in
  another order);
- off the boundary (micro-steps 1-3 and 5-7) every parameter, moment,
  beta power and the LR counter bit-equal to its value at the last
  boundary; at steps 4 and 8 they change, beta_pow by one factor of
  beta, the LR counter by one;
- a port checkpoint after micro-step 2 (a half-full accumulator)
  loaded into a new scope, whose steps 3-4 equal the JAX package's;
- inside ``ModelAverage.apply`` the scope's own parameter tensors hold
  the averages, bit for bit, and after it the trained values;
- under the bf16 policy, the fp32 accumulator keeps its dtype.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import numpy as np
import pytest
import torch

import paddle_tpu
import paddle_tpu_torch
from paddle_tpu_torch import convert

LOSS_RTOL, STATE_ATOL = 1e-4, 1e-5
K, STEPS, BATCH, SEQ = 4, 8, 2, 16


def _build(pkg):
    fl = pkg.fluid
    cfg = pkg.models.bert.BertConfig.tiny(
        use_flash_attention=True, attn_dropout=0.0, hidden_dropout=0.0)
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        _, loss, _, _ = pkg.models.bert.build_bert_pretrain(cfg)
        lr = fl.layers.exponential_decay(1e-3, decay_steps=1,
                                         decay_rate=0.5)
        opt = fl.optimizer.GradientMergeOptimizer(
            fl.optimizer.Adam(learning_rate=lr), k_steps=K)
        _, params_grads = opt.minimize(loss)
        avg = fl.optimizer.ModelAverage(0.15)
        avg.update()
    return cfg, main, startup, loss, lr, avg, params_grads


def _state(scope, names):
    """Each var's value as float64 numpy (exact for fp32 and int32)."""
    out = {}
    for n in names:
        v = scope.get(n)
        v = v.double().numpy() if isinstance(v, torch.Tensor) else v
        out[n] = np.array(v, np.float64)
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX package's 8 micro-steps (losses, persistables after each,
    checkpoints after its startup run and after micro-step 2) and the
    port's programs."""
    import paddle_tpu.models.bert  # noqa: F401
    import paddle_tpu_torch.models.bert  # noqa: F401

    jfl = paddle_tpu.fluid
    cfg, main, startup, loss, lr, avg, _ = _build(paddle_tpu)
    names = sorted(v.name for v in main.list_vars() if v.persistable
                   and not v.is_data and v.name not in ("feed", "fetch"))
    batches = [paddle_tpu.models.bert.make_fake_batch(cfg, BATCH, SEQ,
                                                      seed=i)
               for i in range(K)]
    exe, scope = jfl.Executor(jfl.CPUPlace()), jfl.Scope()
    exe.run(startup, scope=scope)
    ckpt = {0: str(tmp_path_factory.mktemp("gm_ckpt0"))}
    jfl.io.save_persistables(exe, ckpt[0], main_program=main, scope=scope)
    losses, states = [], []
    for i in range(STEPS):
        (lv,) = exe.run(main, feed=batches[i % K], fetch_list=[loss],
                        scope=scope)
        losses.append(float(np.asarray(lv).reshape(())))
        states.append(_state(scope, names))
        if i == 1:
            ckpt[2] = str(tmp_path_factory.mktemp("gm_ckpt2"))
            jfl.io.save_persistables(exe, ckpt[2], main_program=main,
                                     scope=scope)
    return dict(names=names, batches=batches, losses=losses,
                states=states, ckpt=ckpt, jmain=main)


def _port_run(run, ckpt, first, last):
    tfl = paddle_tpu_torch.fluid
    _, main, startup, loss, _, avg, pg = _build(paddle_tpu_torch)
    exe, scope = tfl.Executor(tfl.CPUPlace()), tfl.Scope()
    exe.run(startup, scope=scope)
    convert.load_checkpoint(scope, ckpt, main, tfl.CPUPlace())
    losses, states = [], []
    for i in range(first, last):
        (lv,) = exe.run(main, feed=run["batches"][i % K], fetch_list=[loss],
                        scope=scope)
        losses.append(float(np.asarray(lv).reshape(())))
        states.append(_state(scope, run["names"]))
    return main, exe, scope, avg, pg, losses, states


def test_gradient_merge_matches_jax_and_reverts_off_boundary(run):
    main, exe, scope, avg, pg, losses, states = _port_run(
        run, run["ckpt"][0], 0, STEPS)
    jmain = run["jmain"]
    assert [op.type for op in main.global_block().ops] == \
        [op.type for op in jmain.global_block().ops]
    assert main._params_grads == jmain._params_grads
    assert all("@GRAD" in g and "_gm_" not in g
               for _, g in main._params_grads)
    assert [g.name for _, g in pg] == [g for _, g in main._params_grads]
    np.testing.assert_allclose(losses, run["losses"], rtol=LOSS_RTOL)
    for got, want in zip(states, run["states"]):
        for n in run["names"]:
            np.testing.assert_allclose(got[n], want[n], atol=STATE_ATOL,
                                       err_msg=n)

    params = [p.name for p in main.all_parameters()]
    frozen = params + [n for n in run["names"]
                       if ("moment" in n or "pow_acc" in n
                           or n == "@LR_DECAY_COUNTER@")
                       and "_gm_" not in n]
    b1 = [n for n in frozen if "beta1_pow_acc" in n]
    assert b1 and "@LR_DECAY_COUNTER@" in frozen
    start = _state(_fresh_scope(run), frozen)
    for i, st in enumerate(states):
        last = start if i < K else states[K - 1]
        if (i + 1) % K:
            for n in frozen:
                assert np.array_equal(st[n], last[n]), (i, n)
        else:
            for n in params:
                assert not np.array_equal(st[n], last[n]), (i, n)
            for n in b1:
                np.testing.assert_allclose(st[n], last[n] * 0.9, rtol=1e-6)
            np.testing.assert_array_equal(
                st["@LR_DECAY_COUNTER@"], last["@LR_DECAY_COUNTER@"] + 1)

    # ModelAverage: the scope's own tensors hold the averages inside
    # apply() and the trained values after it
    tfl = paddle_tpu_torch.fluid
    objs = {p: scope.get(p) for p in params}
    trained = {p: objs[p].clone() for p in params}
    with tfl.scope_guard(scope):
        with avg.apply(exe):
            for p in params:
                assert scope.get(p) is objs[p]
                assert torch.equal(objs[p],
                                   scope.get(avg._ema_vars[p].name))
        for p in params:
            assert scope.get(p) is objs[p]
            assert torch.equal(objs[p], trained[p])
    assert sorted(avg.get_opti_var_name_list()) == sorted(
        avg._ema_vars[p].name for p in params)
    with pytest.raises(NotImplementedError):
        avg.minimize(None)


def _fresh_scope(run):
    tfl = paddle_tpu_torch.fluid
    _, main, startup, *_ = _build(paddle_tpu_torch)
    scope = tfl.Scope()
    tfl.Executor(tfl.CPUPlace()).run(startup, scope=scope)
    convert.load_checkpoint(scope, run["ckpt"][0], main, tfl.CPUPlace())
    return scope


def test_gradient_merge_resumes_mid_window_from_checkpoint(run,
                                                           tmp_path):
    """Two micro-steps, ``convert.save_checkpoint`` (a half-full
    accumulator, the counter at 2), then a new scope from
    ``convert.load_checkpoint`` whose steps 3-4 equal the JAX package's:
    every var keeps its declared dtype across the eager steps."""
    main, _, scope, *_ = _port_run(run, run["ckpt"][0], 0, 2)
    convert.save_checkpoint(scope, str(tmp_path), main)
    *_, losses, states = _port_run(run, str(tmp_path), 2, K)
    np.testing.assert_allclose(losses, run["losses"][2:K], rtol=LOSS_RTOL)
    for got, want in zip(states, run["states"][2:K]):
        for n in run["names"]:
            np.testing.assert_allclose(got[n], want[n], atol=STATE_ATOL,
                                       err_msg=n)


def test_gradient_merge_bf16_accumulator_keeps_fp32(run):
    from paddle_tpu_torch.fluid.contrib.mixed_precision import (
        enable_bf16_policy)

    tfl = paddle_tpu_torch.fluid
    _, main, startup, loss, *_ = _build(paddle_tpu_torch)
    enable_bf16_policy(main)
    exe, scope = tfl.Executor(tfl.CPUPlace()), tfl.Scope()
    exe.run(startup, scope=scope)
    accs = [n for n in main.global_block().vars if "_gm_acc" in n]
    exe.run(main, feed=run["batches"][0], fetch_list=[loss], scope=scope)
    for n in accs:
        assert scope.get(n).dtype == torch.float32, n
        assert torch.count_nonzero(scope.get(n)) > 0, n


def test_eager_write_back_keeps_a_persistable_dtype():
    """A persistable written as another dtype than its own (an int64
    counter blended with a float gate, as the merge blends
    ``@LR_DECAY_COUNTER@``) keeps its dtype after an eager run, as a
    captured graph's copy into the scope's tensor keeps it.  Left
    float32, ``convert.load_checkpoint`` of the port's own checkpoint
    refuses it (ROADMAP §3)."""
    tfl = paddle_tpu_torch.fluid
    main, startup = tfl.Program(), tfl.Program()
    with tfl.program_guard(main, startup), tfl.unique_name.guard():
        helper = tfl.layer_helper.LayerHelper("counter")
        c = helper.create_global_variable(name="counter", shape=[1],
                                          dtype="int64", persistable=True)
        helper.set_variable_initializer(c, tfl.initializer.Constant(3.0))
        gate = tfl.layers.fill_constant([1], "float32", 1.0)
        main.global_block().append_op(
            "elementwise_mul", inputs={"X": [c], "Y": [gate]},
            outputs={"Out": [c]}, attrs={"axis": -1})
    exe, scope = tfl.Executor(tfl.CPUPlace()), tfl.Scope()
    exe.run(startup, scope=scope)
    for _ in range(2):
        exe.run(main, scope=scope)
        assert scope.get("counter").dtype == torch.int64
        assert int(scope.get("counter")) == 3
