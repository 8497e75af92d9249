"""The data-parallel lane of the PyTorch port against the JAX package,
on the CPU.

The JAX side runs as the JAX package's own tests run it: one program
over the 8-virtual-device CPU mesh (tests/cpu_mesh.py) under
``jax.shard_map``, through ``CompiledProgram.with_data_parallel`` for
whole programs.  The port drives the same number of replicas from one
process, each on ``CPUPlace()`` (parallel/mesh.py).

- Collectives: the quantized all-reduce in every form (one-shot, ring,
  bidirectional ring, and "auto"), at dp 2 and 4, on sizes that are and
  are not multiples of n·256: the kept hi, lo and scale codes exactly
  equal to the JAX package's run op by op (``jax.vmap`` over the axis
  name), the dequantized sums within 1e-7 of each other, and within two
  code steps of the jitted ``shard_map`` run (XLA:CPU contracts
  multiply-adds there; ROADMAP queue 3).
- The pure functions ``select_allreduce_algo``, ``wire_bytes`` and
  ``quant_padded_elems`` over a grid.
- The transpile: the same program through both packages'
  ``transpile_data_parallel`` gives the same op types and attrs, q-var
  shapes and the four ``program._*`` reports.
- End to end (the JAX run in a child, tests/torch_port_dp_oracle.py):
  BERT-tiny at dp 4 from the same parameters, on the quantized lane and
  the plain ``c_allreduce_sum`` lane.
- The runner's contract: one place falls back to the plain executor,
  an indivisible feed raises, replicas stay bit-identical, and each
  replica draws its own dropout mask.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.kernels import quantized_collectives as jqc
from paddle_tpu.kernels import ring_collectives as jrc

from paddle_tpu_torch.kernels import quantized_collectives as tqc
from paddle_tpu_torch.kernels import ring_collectives as trc

BS = 256


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _jax_all_reduce(xs, algo, keep, jit=False):
    """The JAX collective over n replicas.  By default under ``jax.vmap``
    with the axis name, op by op (no jit): the arithmetic exactly as the
    JAX package writes it.  With ``jit``, under ``jax.shard_map`` over n
    CPU-mesh devices, as the JAX package's tests run it: there XLA:CPU
    contracts multiply-adds into fused multiply-adds (the residual
    ``x - hi * scale``, the dequantization ``hi * s + lo * s / 254``),
    so a code can move by one step; the port keeps the written
    arithmetic (ROADMAP queue 3)."""
    n = xs.shape[0]

    def body(x):
        if keep:
            return jrc.adaptive_quantized_all_reduce_keep(
                x, "dp", block_size=BS, algo=algo)
        return (jrc.adaptive_quantized_all_reduce(
            x, "dp", block_size=BS, algo=algo),)

    if not jit:
        return [np.asarray(o) for o in
                jax.vmap(body, axis_name="dp")(jnp.asarray(xs))]
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    f = jax.jit(jax.shard_map(
        lambda x: tuple(o[None] for o in body(x[0])), mesh=mesh,
        in_specs=P("dp"), out_specs=(P("dp"),) * (3 if keep else 1),
        check_vma=False))
    return [np.asarray(o) for o in f(jnp.asarray(xs))]


# dp 2 and 4; every form (ring_bidir at dp 2 demotes to the ring);
# sizes that are and are not multiples of n * 256
CASES = [(2, "oneshot", 1536), (2, "ring", 1613), (2, "ring_bidir", 1536),
         (4, "oneshot", 3072), (4, "oneshot", 4173), (4, "ring", 3072),
         (4, "ring", 4173), (4, "ring_bidir", 4096),
         (4, "ring_bidir", 4173), (4, "auto", 70001), (4, "auto", 1000)]


@pytest.mark.parametrize("n,algo,size", CASES)
def test_quantized_all_reduce_codes_match_jax(n, algo, size):
    rng = np.random.RandomState(size + n)
    xs = rng.randn(n, size).astype(np.float32)
    j_hi, j_lo, j_sc = _jax_all_reduce(xs, algo, keep=True)
    kept = trc.adaptive_quantized_all_reduce_keep(
        [torch.from_numpy(x) for x in xs], block_size=BS, algo=algo)
    for r, (hi, lo, sc) in enumerate(kept):
        np.testing.assert_array_equal(hi.numpy(), j_hi[r])
        np.testing.assert_array_equal(lo.numpy(), j_lo[r])
        np.testing.assert_array_equal(sc.numpy(), j_sc[r])
    padded = tqc.quant_padded_elems(size, n, BS, trc.select_allreduce_algo(
        size, n, algo=algo, block_size=BS))
    assert kept[0][0].numel() == padded
    (j_out,) = _jax_all_reduce(xs, algo, keep=False)
    outs = trc.adaptive_quantized_all_reduce(
        [torch.from_numpy(x) for x in xs], block_size=BS, algo=algo)
    for r, o in enumerate(outs):
        assert o.shape == (size,) and o.dtype == torch.float32
        np.testing.assert_allclose(o.numpy(), j_out[r], rtol=0, atol=1e-7)
    if size % (n * BS) == 0:
        # against the jitted shard_map run: the same sum up to XLA's
        # multiply-add contraction, within two code steps
        (j_jit,) = _jax_all_reduce(xs, algo, keep=False, jit=True)
        step = np.abs(xs).sum(0).max() / 64516
        assert np.abs(outs[0].numpy() - j_jit[0]).max() <= 2 * step
    # the sum itself: each quantization on the way errs by at most one
    # residual step, 1/64516 of its block's max (at most n·max|x|)
    exact = xs.sum(0)
    quantizations = n + (2 * (n - 1) if algo != "oneshot" else 2)
    bound = quantizations * n * np.abs(xs).max() / 64516
    assert np.abs(outs[0].numpy() - exact).max() <= bound


def test_one_replica_collectives_are_the_single_device_meaning():
    x = torch.from_numpy(np.random.RandomState(0).randn(300).astype(
        np.float32))
    (out,) = trc.adaptive_quantized_all_reduce([x], block_size=BS)
    assert out is x
    ((hi, lo, sc),) = trc.adaptive_quantized_all_reduce_keep([x],
                                                            block_size=BS)
    j_hi, j_lo, j_sc = jrc.local_keep_quant(jnp.asarray(x.numpy()), BS,
                                            True)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(j_hi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(j_lo))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(j_sc))


GRID_N = (1, 2, 3, 4, 8)
GRID_ELEMS = (0, 1, 255, 256, 1000, 4096, 65535, 65536, 100003,
              23445504)
GRID_BS = (16, 256)


def test_select_allreduce_algo_matches_jax():
    for n in GRID_N:
        for e in GRID_ELEMS:
            for bs in GRID_BS:
                for algo in ("auto", "oneshot", "ring", "ring_bidir"):
                    for kb in (None, 1, 256):
                        assert trc.select_allreduce_algo(
                            e, n, algo, kb, bs) == jrc.select_allreduce_algo(
                                e, n, algo, kb, bs), (n, e, bs, algo, kb)
                assert trc.bidir_eligible(e, n, bs) == \
                    jrc.bidir_eligible(e, n, bs)


def test_wire_bytes_and_padding_match_jax():
    for n in GRID_N:
        for e in GRID_ELEMS:
            for bs in GRID_BS:
                for algo in ("oneshot", "ring", "ring_bidir"):
                    assert tqc.quant_padded_elems(e, n, bs, algo) == \
                        jqc.quant_padded_elems(e, n, bs, algo)
                    for dual in (True, False):
                        assert tqc.wire_bytes(e, bs, dual, n, algo) == \
                            jqc.wire_bytes(e, bs, dual, n, algo)
                assert tqc.gather_wire_bytes(e, bs, True, n) == \
                    jqc.gather_wire_bytes(e, bs, True, n)
    with pytest.raises(ValueError):
        tqc.wire_bytes(4096, algo="tree", n_devices=4)


# ---------------------------------------------------------------------------
# the transpile, op for op
# ---------------------------------------------------------------------------

from paddle_tpu import fluid as jfluid  # noqa: E402
from paddle_tpu import passes as jpasses  # noqa: E402
from paddle_tpu.models import bert as jbert  # noqa: E402
from paddle_tpu.parallel import data_parallel as jdp  # noqa: E402

from paddle_tpu_torch import convert, fluid  # noqa: E402
from paddle_tpu_torch import passes as tpasses  # noqa: E402
from paddle_tpu_torch.fluid.contrib.mixed_precision import (  # noqa: E402
    enable_bf16_policy)
from paddle_tpu_torch.models import bert  # noqa: E402
from paddle_tpu_torch.parallel import data_parallel as tdp  # noqa: E402

import torch_port_dp_oracle as oracle_mod  # noqa: E402

ORACLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "torch_port_dp_oracle.py")


def _build_bert(pkg, opt="adam"):
    fl, bm = (jfluid, jbert) if pkg == "jax" else (fluid, bert)
    cfg = bm.BertConfig.tiny(use_flash_attention=True, attn_dropout=0.0,
                             hidden_dropout=0.0)
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        _, loss, _, _ = bm.build_bert_pretrain(cfg)
        fl.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    return main, startup, loss


def build_mlp(pkg, opt):
    """tests/torch_port_dp_oracle.py's MLP, in either package."""
    fl = jfluid if pkg == "jax" else fluid
    L = fl.layers
    opts = {"momentum": lambda: fl.optimizer.Momentum(0.1, 0.9),
            "nesterov": lambda: fl.optimizer.Momentum(0.1, 0.9,
                                                      use_nesterov=True),
            "sgd": lambda: fl.optimizer.SGD(0.1),
            "adamw": lambda: fl.optimizer.AdamW(0.01, weight_decay=0.05)}
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        x = L.data(name="x", shape=[8], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="int64")
        h = L.fc(x, size=6, act="tanh")
        logits = L.fc(h, size=3)
        loss = L.mean(L.softmax_with_cross_entropy(logits, y))
        opts[opt]().minimize(loss)
    return main, startup, loss


def _op_list(program):
    def attr(v):
        return list(v) if isinstance(v, tuple) else v

    return json.loads(json.dumps([
        [op.type, op.inputs, op.outputs,
         {k: attr(v) for k, v in sorted(op.attrs.items())}]
        for op in program.global_block().ops], default=str))


def _narrow_resnet(pkg):
    from paddle_tpu.models import resnet as jresnet
    from paddle_tpu_torch.models import resnet as tresnet

    return oracle_mod.build_narrow_resnet(
        *((jfluid, jresnet) if pkg == "jax" else (fluid, tresnet)))


def _transpiled(pkg, model, fused, overlap, block_size):
    """``model`` "resnet_plain" is the narrow ResNet without the
    quantized all-reduce; every other model takes it."""
    if model.startswith("resnet"):
        main, _, loss = _narrow_resnet(pkg)
    else:
        main, _, loss = (_build_bert(pkg) if model == "bert"
                         else build_mlp(pkg, model))
    (jpasses if pkg == "jax" else tpasses).apply_graph_passes(main,
                                                              lane="dp")
    (jdp if pkg == "jax" else tdp).transpile_data_parallel(
        main, loss.name, 4, quant_grads=model != "resnet_plain",
        quant_block_size=block_size, fused_update=fused, overlap=overlap)
    return main


TRANSPILES = [("bert", f, o) for f in (True, False) for o in (True, False)]
TRANSPILES += [(m, True, True) for m in ("momentum", "sgd", "adamw")]
TRANSPILES += [("momentum", False, False)]
# batch norm through the lane: the quantized and the plain all-reduce
TRANSPILES += [("resnet", True, True), ("resnet_plain", False, True)]


@pytest.mark.parametrize("model,fused,overlap", TRANSPILES)
def test_transpile_matches_jax(model, fused, overlap):
    """Also, on the narrow ResNet: one exact fp32 ``c_allreduce_avg`` of
    each training batch norm's MeanOut and VarianceOut right after it,
    which no quantized bucket takes."""
    bs = 256 if model == "bert" else 16
    want = _transpiled("jax", model, fused, overlap, bs)
    got = _transpiled("torch", model, fused, overlap, bs)
    g_ops, w_ops = _op_list(got), _op_list(want)
    assert [o[0] for o in g_ops] == [o[0] for o in w_ops]
    for i, (g, w) in enumerate(zip(g_ops, w_ops)):
        assert g == w, f"op {i}: {g} != {w}"
    for attr in ("_collective_bytes_per_step", "_quant_allreduce_plan",
                 "_overlap_schedule", "_fused_update_bytes_saved"):
        assert getattr(got, attr) == getattr(want, attr), attr
    if model.startswith("resnet"):
        ops = got.global_block().ops
        bns = [i for i, op in enumerate(ops) if op.type == "batch_norm"]
        assert bns and types_count(ops, "c_allreduce_avg") == 2 * len(bns)
        for i in bns:
            stats = [ops[i].outputs[s][0] for s in ("MeanOut",
                                                    "VarianceOut")]
            assert [(o.type, o.inputs["X"]) for o in ops[i + 1:i + 3]] == \
                [("c_allreduce_avg", [n]) for n in stats]
            for o in ops:
                if o.type == "coalesce_tensor":
                    assert not set(stats) & set(o.inputs["Input"])
    qvars = [n for n in got.global_block().vars if "@FUSED_GRAD_QUANT@" in n]
    assert bool(qvars) == (model != "resnet_plain")
    for n in qvars:
        gv, wv = got.global_block().var(n), want.global_block().var(n)
        assert (list(gv.shape), gv.dtype) == (list(wv.shape), wv.dtype), n
    types = [o[0] for o in g_ops]
    if fused:
        kind = {"bert": "adam", "nesterov": "momentum",
                "resnet": "momentum"}.get(model, model)
        assert f"fused_{kind}_quant_grad" in types and kind not in types
        assert "c_allreduce_quant_keep" in types


def types_count(ops, type_):
    return sum(op.type == type_ for op in ops)


def _strategy(fl, setting):
    """The build strategy of a stat-sync setting: None, the default
    strategy (sync_batch_norm False), or one with the sync set."""
    if setting == "no_strategy":
        return None
    bs = fl.BuildStrategy()
    if setting != "strategy_default":
        bs.sync_batch_norm = setting == "strategy_true"
    return bs


# setting: (the build strategy, whether the stats are synced)
SYNC_SETTINGS = {"no_strategy": True, "strategy_default": False,
                 "strategy_true": True, "strategy_false": False,
                 "imported_sync_batch_norm": False}


def _as_imported(program):
    """Retype the batch norms and their grads as an imported Fluid
    training program names them under ParallelExecutor."""
    for op in program.global_block().ops:
        if op.type in ("batch_norm", "batch_norm_grad"):
            op.type = "sync_" + op.type
    return program


@pytest.mark.parametrize("setting", sorted(SYNC_SETTINGS))
def test_batch_norm_stat_sync_setting_matches_jax(setting):
    """When the runner syncs the moving statistics, as the JAX package
    decides it: with no build strategy, or one whose ``sync_batch_norm``
    is not False.  An imported ``sync_batch_norm`` op is not synced in
    either package (the rewrite matches ``batch_norm`` only): both
    runners' programs are the same op for op."""
    progs = {}
    for pkg, fl, dp in (("jax", jfluid, jdp), ("torch", fluid, tdp)):
        main, _, loss = _narrow_resnet(pkg)
        if setting == "imported_sync_batch_norm":
            _as_imported(main)
        strategy = _strategy(fl, "no_strategy" if setting.startswith(
            "imported") else setting)
        runner = dp.DataParallelRunner(main, loss.name, strategy,
                                       places=[fl.CPUPlace()] * 2)
        progs[pkg] = runner.program
    g_ops, w_ops = _op_list(progs["torch"]), _op_list(progs["jax"])
    assert g_ops == w_ops
    n_bn = sum(o[0] in ("batch_norm", "sync_batch_norm") for o in g_ops)
    assert n_bn == 9
    assert types_count(progs["torch"].global_block().ops,
                       "c_allreduce_avg") == \
        (2 * n_bn if SYNC_SETTINGS[setting] else 0)


# ---------------------------------------------------------------------------
# the narrow ResNet at dp 2 (child oracles, one a lane, run at once)
# ---------------------------------------------------------------------------

# losses 1e-5 relative; SavedMean within 1e-5 of its largest magnitude
# (a batch mean near 0 has few correct digits); first gradients within
# 5e-4 of their norm floored at 1e-2 of the model's largest gradient RMS
# (the image models' rule, tests/test_torch_port_cnn.py: at lr 1e-6 the
# parameters move less than their fp32 rounding, so the backward is held
# by its first gradient); the moving statistics within 1e-5 of their
# norm of the JAX package's, and within 4 fp32 ulps of their own largest
# magnitude of 0.9·old + 0.1·(the mean of the replicas' batch means):
# c_allreduce_avg sums the replicas' values in another order than the
# JAX psum
RN_LOSS_RTOL, RN_GRAD_RTOL, RN_GRAD_FLOOR, RN_STAT_RTOL = \
    1e-5, 5e-4, 1e-2, 1e-5
RN_ULPS = 4 * np.finfo(np.float32).eps


@pytest.fixture(scope="module")
def rn_oracle(tmp_path_factory):
    """The JAX runs, from the port's startup values (so the children do
    not compile the startup program)."""
    d = tmp_path_factory.mktemp("dp_rn_oracle")
    main, startup, _ = _narrow_resnet("torch")
    _, scope = _started(startup)
    np.savez(d / "init.npz", **{
        n: scope.get(n).numpy() for n, v in
        main.global_block().vars.items() if v.persistable})
    procs = [(d / f"{lane}.npz", subprocess.Popen(
        [sys.executable, ORACLE, str(d / f"{lane}.npz"), "resnet", lane,
         f"--init={d / 'init.npz'}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.dirname(ORACLE))))
        for lane in oracle_mod.RESNET_LANES]
    res = {}
    for out, p in procs:
        so, se = p.communicate(timeout=900)
        assert p.returncode == 0 and "TORCH_PORT_DP_ORACLE_OK" in so, (
            f"JAX oracle child failed rc={p.returncode}\n{se[-3000:]}")
        z = np.load(out)
        res.update({k: z[k] for k in z.files})
    return res


def _rel(got, want, floor=0.0):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  floor, 1e-30))


@pytest.mark.parametrize("lane", sorted(oracle_mod.RESNET_LANES))
def test_narrow_resnet_dp2_matches_jax(rn_oracle, lane):
    """The narrow ResNet at dp 2 from one state: the losses, each
    replica's first gradients and batch means, the moving statistics
    and the parameters after the step against the JAX
    ``DataParallelRunner``'s.  With the sync on, every replica's
    parameters, velocities and moving statistics are bit-identical and
    each moving statistic is the previous one folded with the mean of
    the replicas' batch statistics; with it off the replicas' statistics
    differ and the scope keeps replica 0's, as the JAX runner's does."""
    quant, sync = oracle_mod.RESNET_LANES[lane]
    main, startup, loss = _narrow_resnet("torch")
    stats, saved = oracle_mod.bn_names(main)
    params = [p.name for p in main.all_parameters()]
    grads = [p + "@GRAD" for p in params]
    exe, scope = _started(startup)
    init = prefixed(rn_oracle, f"{lane}:init:")
    convert.load_params(scope, init, fluid.CPUPlace(), program=main)
    bs = fluid.BuildStrategy()
    bs.quant_allreduce, bs.sync_batch_norm = quant, sync
    cp = _runner(main, loss, [fluid.CPUPlace()] * 2, build_strategy=bs)
    feed = prefixed(rn_oracle, "rn:feed:")
    old = fluid.get_flags("FLAGS_quant_allreduce_block_size")
    fluid.set_flags({"FLAGS_quant_allreduce_block_size": 16})
    losses = []
    try:
        for step in range(oracle_mod.RESNET_STEPS):
            out = exe.run(cp, feed=feed, fetch_list=[loss.name] + grads
                          + saved, scope=scope)
            losses.append(out[0])
            if step == 0:
                first = dict(zip(grads + saved, out[1:]))
                stats1 = {n: scope.get(n).numpy().copy() for n in stats}
    finally:
        fluid.set_flags(old)
    np.testing.assert_allclose(np.stack(losses), rn_oracle[f"{lane}:loss"],
                               rtol=RN_LOSS_RTOL, atol=0)
    want_g = prefixed(rn_oracle, f"{lane}:grad:")
    top = max(float(np.sqrt(np.mean(g ** 2))) for g in want_g.values())
    for p in params:
        w = want_g[p]
        assert _rel(first[p + "@GRAD"], w, RN_GRAD_FLOOR * top
                    * np.sqrt(w.size)) <= RN_GRAD_RTOL, p
    for n in saved:
        w = rn_oracle[f"{lane}:saved:{n}"]
        assert np.abs(first[n] - w).max() <= RN_STAT_RTOL * np.abs(w).max(), n
    for n in stats:
        assert _rel(stats1[n], rn_oracle[f"{lane}:stats1:{n}"]) \
            <= RN_STAT_RTOL, n
    final = prefixed(rn_oracle, f"{lane}:final:")
    for n in stats:
        assert _rel(scope.get(n).numpy(), final[n]) <= RN_STAT_RTOL, n
        assert not np.array_equal(final[n], init[n])
    for p in params:
        np.testing.assert_allclose(scope.get(p).numpy(), final[p], rtol=0,
                                   atol=1e-7, err_msg=p)
    # the replicas; replica r's batch mean is rows r·C.. of SavedMean
    runner = cp._dp_runner
    bn_ops = [op for op in main.global_block().ops
              if op.type == "batch_norm"]
    for op, sm in zip(bn_ops, saved):
        m = op.inputs["Mean"][0]
        per = first[sm].reshape(2, -1)
        own = 0.9 * init[m] + 0.1 * (per.mean(0) if sync else per[0])
        scale = max(float(np.abs(stats1[m]).max()), 1e-30)
        assert np.abs(stats1[m] - own).max() <= RN_ULPS * scale, m
    vel = [n for op in main.global_block().ops if op.type == "momentum"
           for n in op.inputs["Velocity"]] or [
        n for op in runner.program.global_block().ops
        if op.type == "fused_momentum_quant_grad"
        for n in op.inputs["Velocity"]]
    assert len(vel) == len(params)
    for n in params + vel + stats:
        vals = runner.replica_values(n)
        assert scope.get(n) is vals[0], n
        same = torch.equal(vals[0], vals[1])
        assert same if (sync or n not in stats) else not same, n
    types = [op.type for op in runner.program.global_block().ops]
    assert ("fused_momentum_quant_grad" in types) == quant
    assert types_count(runner.program.global_block().ops,
                       "c_allreduce_avg") == (18 if sync else 0)


def test_imported_sync_batch_norm_trains_unsynced_at_dp2():
    """An imported program's ``sync_batch_norm`` and its grad run as
    batch norm (the compat aliases) through the lane, unsynced: the
    same losses as the ``batch_norm`` program with the sync off, bit
    for bit."""
    runs = {}
    feed = oracle_mod.resnet_feed()
    for imported in (True, False):
        main, startup, loss = _narrow_resnet("torch")
        if imported:
            _as_imported(main)
        exe, scope = _started(startup)
        cp = _runner(main, loss, [fluid.CPUPlace()] * 2,
                     build_strategy=_strategy(fluid, "no_strategy"
                                              if imported else
                                              "strategy_false"))
        runs[imported] = [exe.run(cp, feed=feed, fetch_list=[loss],
                                  scope=scope)[0] for _ in range(2)]
        types = {op.type for op in cp._dp_runner.program.global_block().ops}
        assert ("sync_batch_norm_grad" in types) == imported
    for a, b in zip(runs[True], runs[False]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# end to end: the JAX package's lanes (child oracle) vs the port
# ---------------------------------------------------------------------------

LOSS_RTOL = 1e-5
# final parameters: 1e-5 relative, and 1e-5 absolute (a tenth of Adam's
# lr, the gate of tests/test_torch_port_bert.py): an Adam step moves an
# element by about lr whatever its gradient's size, so an element whose
# gradient sits at the rounding floor (the attention key biases, whose
# true gradient is 0) or whose wire code is one step apart moves by a
# different fraction of lr in the two packages
PARAM_ATOL = 1e-5


def run_oracle(tmp_path_factory, group):
    """The JAX lanes of ``group`` ("bert" or "mlp"), from the child."""
    out = tmp_path_factory.mktemp("dp_oracle") / "oracle.npz"
    r = subprocess.run([sys.executable, ORACLE, str(out), group],
                       capture_output=True, text=True, timeout=900,
                       cwd=os.path.dirname(os.path.dirname(ORACLE)))
    assert r.returncode == 0 and "TORCH_PORT_DP_ORACLE_OK" in r.stdout, (
        f"JAX oracle child failed rc={r.returncode}\n{r.stderr[-3000:]}")
    z = np.load(out)
    return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    return run_oracle(tmp_path_factory, "bert")


def prefixed(d, prefix):
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


def train_port(oracle, lane, build, feed, steps, quant, bf16=False,
               block_size=None):
    """The port's run of an oracle lane from the lane's initial
    parameters: (stacked losses, scope, compiled program)."""
    main, startup, loss = build()
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    convert.load_params(scope, prefixed(oracle, f"{lane}:init:"),
                        fluid.CPUPlace(), program=main)
    if bf16:
        enable_bf16_policy(main)
    bs = fluid.compiler.BuildStrategy()
    bs.quant_allreduce = quant
    cp = fluid.CompiledProgram(main, build_strategy=bs).with_data_parallel(
        loss_name=loss.name, places=[fluid.CPUPlace()] * 4)
    old = fluid.get_flags("FLAGS_quant_allreduce_block_size")
    if block_size:
        fluid.set_flags({"FLAGS_quant_allreduce_block_size": block_size})
    try:
        losses = np.stack([exe.run(cp, feed=feed, fetch_list=[loss],
                                   scope=scope)[0] for _ in range(steps)])
    finally:
        fluid.set_flags(old)
    return losses, scope, cp


def check_params(oracle, lane, scope):
    final = prefixed(oracle, f"{lane}:final:")
    assert final
    for n, want in final.items():
        np.testing.assert_allclose(scope.get(n).numpy(), want,
                                   rtol=LOSS_RTOL, atol=PARAM_ATOL,
                                   err_msg=n)


@pytest.mark.parametrize("lane", ["quant", "plain"])
def test_bert_tiny_dp4_matches_jax(oracle, lane):
    """BERT-tiny at dp 4 through CompiledProgram.with_data_parallel:
    the stacked per-replica losses of 5 steps within 1e-5 relative of
    the JAX package's, and the final parameters (PARAM_ATOL)."""
    feed = prefixed(oracle, "feed:")
    losses, scope, cp = train_port(
        oracle, lane, lambda: _build_bert("torch"), feed, 5,
        quant=lane == "quant")
    want = oracle[f"{lane}:loss"]
    assert losses.shape == want.shape == (5, 4)
    np.testing.assert_allclose(losses, want, rtol=LOSS_RTOL, atol=0)
    assert (losses[-1] < losses[0]).all()
    check_params(oracle, lane, scope)
    types = [op.type for op in cp._dp_runner.program.global_block().ops]
    if lane == "quant":
        assert "fused_adam_quant_grad" in types and "adam" not in types
    else:
        assert types.count("c_allreduce_sum") == len(
            cp._dp_runner.program.all_parameters())


def test_bert_tiny_dp4_bf16_policy_matches_jax(oracle):
    """Under the bf16 dtype policy coalesce_tensor and the keep-quant
    all-reduce are backward ops and see bf16; the fused optimizer ops see
    fp32 and int8.  Each of 3 losses within one bf16 ulp (2^-8
    relative) of the JAX package's."""
    feed = prefixed(oracle, "feed:")
    losses, _, cp = train_port(oracle, "bf16", lambda: _build_bert("torch"),
                                feed, 3, quant=True, bf16=True)
    np.testing.assert_allclose(losses, oracle["bf16:loss"], rtol=2 ** -8,
                               atol=0)


# ---------------------------------------------------------------------------
# the runner's contract
# ---------------------------------------------------------------------------


def _dropout_net(seed):
    """x [8, 16] -> fc -> dropout(p=0.5, seed) -> mean, SGD; returns the
    programs, the loss and the dropout's Mask var name."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data("x", [16], dtype="float32")
        h = fluid.layers.dropout(fluid.layers.fc(x, size=16), 0.5,
                                 seed=seed)
        loss = fluid.layers.mean(h)
        fluid.optimizer.SGD(0.1).minimize(loss)
    mask = [op.outputs["Mask"][0] for op in main.global_block().ops
            if op.type == "dropout"][0]
    return main, startup, loss, mask


def _runner(main, loss, places, **kw):
    return fluid.CompiledProgram(main, **kw).with_data_parallel(
        loss_name=loss.name, places=places)


def _started(startup):
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    return exe, scope


FEED = {"x": np.random.RandomState(0).randn(8, 16).astype(np.float32)}


def test_one_place_falls_back_to_the_plain_executor():
    main, startup, loss, _ = _dropout_net(0)
    exe, scope = _started(startup)
    types = [op.type for op in main.global_block().ops]
    (lv,) = exe.run(_runner(main, loss, [fluid.CPUPlace()]), feed=FEED,
                    fetch_list=[loss], scope=scope)
    assert np.shape(lv) == () and np.isfinite(lv)
    after = [op.type for op in main.global_block().ops]
    assert after == types and "c_allreduce_sum" not in after


def test_indivisible_feed_raises():
    main, startup, loss, _ = _dropout_net(0)
    exe, scope = _started(startup)
    cp = _runner(main, loss, [fluid.CPUPlace()] * 3)
    with pytest.raises(ValueError, match="not divisible by 3"):
        exe.run(cp, feed=FEED, fetch_list=[loss], scope=scope)


@pytest.mark.parametrize("seed", [0, 7])
def test_replicas_draw_their_own_masks_and_stay_identical(seed):
    """Each replica's dropout mask differs (its stream folds in the
    replica index, with or without a seed attr), while the parameters
    every replica holds after the step are bit-identical: the same
    update of the same all-reduced gradient."""
    main, startup, loss, mask = _dropout_net(seed)
    exe, scope = _started(startup)
    cp = _runner(main, loss, [fluid.CPUPlace()] * 4)
    lv, m = exe.run(cp, feed=FEED, fetch_list=[loss, mask], scope=scope)
    assert lv.shape == (4,) and m.shape == (8, 16)
    shards = m.reshape(4, 2, 16)
    for i in range(4):
        for j in range(i):
            assert not np.array_equal(shards[i], shards[j]), (i, j)
    runner = cp._dp_runner
    for p in main.all_parameters():
        vals = runner.replica_values(p.name)
        assert len(vals) == 4
        for v in vals[1:]:
            assert torch.equal(v, vals[0]), p.name
        assert scope.get(p.name) is vals[0]


def test_replaced_scope_tensor_is_copied_to_every_replica_again():
    main, startup, loss, _ = _dropout_net(0)
    exe, scope = _started(startup)
    cp = _runner(main, loss, [fluid.CPUPlace()] * 2)
    exe.run(cp, feed=FEED, fetch_list=[loss], scope=scope)
    name = main.all_parameters()[0].name
    new = torch.full_like(scope.get(name), 0.5)
    scope.set(name, new)
    exe.run(cp, feed=FEED, fetch_list=[loss], scope=scope)
    vals = cp._dp_runner.replica_values(name)
    assert torch.equal(vals[0], vals[1])
    assert not torch.equal(vals[0], torch.full_like(vals[0], 0.5))
    assert (vals[0] - 0.5).abs().max() < 1.0  # one SGD step from 0.5


def test_scope_written_in_place_is_copied_to_every_replica_again():
    """A plain Executor run on the same scope between two data-parallel
    runs updates the scope's tensors (replica 0's) in place, and so
    does an in-place edit of the learning rate: the other replicas take
    the new values again, so every replica stays bit-identical."""
    main, startup, loss, _ = _dropout_net(0)
    exe, scope = _started(startup)
    cp = _runner(main, loss, [fluid.CPUPlace()] * 2)
    exe.run(cp, feed=FEED, fetch_list=[loss], scope=scope)
    before = {p.name: scope.get(p.name).clone()
              for p in main.all_parameters()}
    exe.run(main, feed={"x": FEED["x"][:4]}, fetch_list=[loss], scope=scope)
    assert any(not torch.equal(scope.get(n), v) for n, v in before.items())
    lr = [op.inputs["LearningRate"][0] for op in main.global_block().ops
          if op.type == "sgd"][0]
    scope.get(lr).fill_(0.0)
    runner = cp._dp_runner
    exe.run(cp, feed=FEED, fetch_list=[loss], scope=scope)
    for name in [p.name for p in main.all_parameters()] + [lr]:
        vals = runner.replica_values(name)
        assert torch.equal(vals[0], vals[1]), name
        assert scope.get(name) is vals[0]
    assert float(runner.replica_values(lr)[1]) == 0.0


def test_unported_lanes_raise():
    main, startup, loss, _ = _dropout_net(0)
    exe, scope = _started(startup)
    bs = fluid.BuildStrategy()
    bs.gspmd_executor = True
    with pytest.raises(NotImplementedError, match="GSPMD"):
        exe.run(_runner(main, loss, [fluid.CPUPlace()] * 2,
                        build_strategy=bs), feed=FEED, fetch_list=[loss],
                scope=scope)
    old = fluid.get_flags("FLAGS_health_sentinel")
    fluid.set_flags({"FLAGS_health_sentinel": True})
    try:
        with pytest.raises(NotImplementedError, match="sentinel"):
            exe.run(_runner(main, loss, [fluid.CPUPlace()] * 2), feed=FEED,
                    fetch_list=[loss], scope=scope)
    finally:
        fluid.set_flags(old)


def test_fused_momentum_matches_unfused_within_1e_5():
    """The port's own fused-vs-unfused momentum run (the MLP at dp 4,
    block size 16, 20 steps).  The gate is 1e-5, not the 1e-6 of the
    JAX package's test_transpiler_rewrites_momentum_to_fused: the JAX
    package's own fused and unfused runs differ by up to 1.848e-6 (float
    association of the reduction; ROADMAP queue 3), and the unfused lane
    reduces a dequantized bucket that was packed without block alignment,
    so its quantization blocks — and their rounding — differ from the
    fused lane's."""
    feed = oracle_mod.mlp_feed()
    runs = {}
    for fused in (True, False):
        main, startup, loss = build_mlp("torch", "momentum")
        exe, scope = _started(startup)
        bs = fluid.BuildStrategy()
        bs.quant_allreduce, bs.fused_update = True, fused
        cp = _runner(main, loss, [fluid.CPUPlace()] * 4, build_strategy=bs)
        old = fluid.get_flags("FLAGS_quant_allreduce_block_size")
        fluid.set_flags({"FLAGS_quant_allreduce_block_size": 16})
        try:
            runs[fused] = [float(np.mean(exe.run(
                cp, feed=feed, fetch_list=[loss], scope=scope)[0]))
                for _ in range(20)]
        finally:
            fluid.set_flags(old)
        types = [op.type for op in cp._dp_runner.program.global_block().ops]
        assert ("fused_momentum_quant_grad" in types) == fused
        assert ("momentum" in types) != fused
    np.testing.assert_allclose(runs[True], runs[False], rtol=0, atol=1e-5)
    assert runs[True][-1] < runs[True][0]
