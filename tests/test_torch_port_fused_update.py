"""K8 (the fused dequant -> update -> requant step) in the PyTorch port
against the JAX package, on the CPU.

The same seeded numpy inputs go through the port's plain version
(``paddle_tpu_torch/kernels/fused_update.py``, what its wrapper runs for
a CPU tensor) and the JAX package's ``fused_*_update`` in its pure-XLA
mode and with the Pallas kernel in interpret mode
(``PT_FUSED_UPDATE_IMPL``): every kind (sgd, heavy-ball and Nesterov
momentum, adam, adamw), the gradient as a member of a kept bucket image
at a nonzero block offset with a numel that is not a multiple of the
block, and the requant form.

Each K8 kind is also reached through a real program: an MLP trained at
dp 4 through ``CompiledProgram.with_data_parallel`` with every optimizer
op fused, against the JAX package's run of the same lane
(tests/torch_port_dp_oracle.py in a child).

Tolerances: the parameter and moments within 1e-6 relative to the
tensor's largest element (the same fp32 terms, but XLA may contract
``beta1 * m1 + (1 - beta1) * g`` into a fused multiply-add where
PyTorch rounds twice: an element that nearly cancels then differs by a
fraction of an ulp of its terms, 2e-6 of itself), the requant codes
equal (against the Pallas kernel in interpret mode, one residual code
may be one step apart where XLA contracts ``p - hi * scale`` into a
fused multiply-add), and the requant scales within the same 1e-6.
Also here: the
plain version against the JAX math on an fp32 gradient, the bucket
slice, and the entry's in-place contract.

The group form (``fused_update_group``, what the dp step runs): on CPU
tensors bit-equal to the per-parameter calls over odd members at block
offsets that are not multiples of 4, what its kernel branch hands the
library (build stubbed), and the executor's grouping: which ops of the
MLP dp-4 program share a group step, where a run breaks, and a grouped
dp step bit-equal to the same step op by op.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import contextlib
import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import fused_update as jfu
from paddle_tpu.kernels import quantized_collectives as jqc

from paddle_tpu_torch import fluid
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import fused_update as tfu
from paddle_tpu_torch.kernels import quantized_collectives as tqc

BS = 256
RTOL = 1e-6
OFFSET = 3
KINDS = [("adam", False), ("adamw", False), ("momentum", False),
         ("momentum", True), ("sgd", False)]


def _inputs(numel, seed=0):
    rng = np.random.RandomState(seed)
    nb = -(-numel // BS)
    bucket = rng.randn((OFFSET + nb + 2) * BS).astype(np.float32)
    # the member's alignment padding is zero, as coalesce_tensor pads it
    bucket[OFFSET * BS + numel:(OFFSET + nb) * BS] = 0.0
    return dict(
        p=(rng.randn(numel) * 0.1).astype(np.float32),
        m1=(rng.randn(numel) * 0.01).astype(np.float32),
        m2=(np.abs(rng.randn(numel)) * 0.01).astype(np.float32),
        lr=np.asarray([1e-3], np.float32),
        b1p=np.asarray([0.9 ** 3], np.float32),
        b2p=np.asarray([0.999 ** 3], np.float32),
        bucket=bucket)


def _jax_call(kind, nesterov, x, numel, requant):
    hi, lo, sc = jqc.quantize_block_scaled(jnp.asarray(x["bucket"]), BS)
    grad = (hi, lo, sc, OFFSET, numel)
    kw = dict(block_size=BS, requant_pad=BS if requant else None)
    j = {k: jnp.asarray(v) for k, v in x.items() if k != "bucket"}
    if kind in ("adam", "adamw"):
        fn = jfu.fused_adam_update if kind == "adam" else \
            jfu.fused_adamw_update
        out = fn(j["p"], grad, j["m1"], j["m2"], j["lr"], j["b1p"],
                 j["b2p"], **kw)
    elif kind == "momentum":
        out = jfu.fused_momentum_update(j["p"], grad, j["m1"], j["lr"],
                                        use_nesterov=nesterov, **kw)
    else:
        out = jfu.fused_sgd_update(j["p"], grad, j["lr"], **kw)
    out = out if isinstance(out, tuple) else (out,)
    return [np.asarray(o) for o in out]


def _port_call(kind, nesterov, x, numel, requant, force=None):
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    hi, lo, sc = tqc.quantize_block_scaled(t.pop("bucket"), BS)
    grad = (hi, lo, sc, OFFSET, numel)
    kw = dict(block_size=BS, requant_pad=BS if requant else None,
              force=force)
    if kind in ("adam", "adamw"):
        fn = tfu.fused_adam_update if kind == "adam" else \
            tfu.fused_adamw_update
        out = fn(t["p"], grad, t["m1"], t["m2"], t["lr"], t["b1p"],
                 t["b2p"], **kw)
    elif kind == "momentum":
        out = tfu.fused_momentum_update(t["p"], grad, t["m1"], t["lr"],
                                        use_nesterov=nesterov, **kw)
    else:
        out = tfu.fused_sgd_update(t["p"], grad, t["lr"], **kw)
    out = out if isinstance(out, tuple) else (out,)
    return [o.numpy() for o in out], t


@pytest.mark.parametrize("mode", ["xla", "interpret"])
@pytest.mark.parametrize("requant", [False, True])
@pytest.mark.parametrize("kind,nesterov", KINDS)
def test_plain_version_matches_jax_fused_update(monkeypatch, mode, requant,
                                                kind, nesterov):
    monkeypatch.setenv("PT_FUSED_UPDATE_IMPL", mode)
    numel = 5 * BS + 37  # a ragged last block
    x = _inputs(numel)
    want = _jax_call(kind, nesterov, x, numel, requant)
    got, _ = _port_call(kind, nesterov, x, numel, requant)
    assert len(got) == len(want)
    n_codes = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if w.dtype == np.int8:
            n_codes += 1
            if mode == "xla" or n_codes == 1:
                np.testing.assert_array_equal(g, w, err_msg=f"output {i}")
            else:
                # lo against the Pallas kernel run by XLA, which may
                # contract p - hi*scale into a fused multiply-add: one
                # residual code may round the other way
                d = np.abs(g.astype(int) - w.astype(int))
                assert d.max() <= 1 and (d > 0).sum() <= 2, d.max()
        elif requant and i == 0 and mode == "interpret":
            # the Pallas requant form returns the payload's dequantized
            # image as p; the plain version the exact update: one
            # dual-int8 quantization apart
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=np.abs(w).max() / 64516 * 2)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL,
                                       atol=RTOL * np.abs(w).max(),
                                       err_msg=f"output {i}")


@pytest.mark.parametrize("kind,nesterov", KINDS)
def test_plain_version_on_fp32_grad_matches_jax_math(kind, nesterov):
    """An fp32 gradient takes the plain version in both packages (the
    XLA path there): the update math term for term."""
    numel = 1000
    x = _inputs(numel, seed=1)
    g = np.random.RandomState(2).randn(numel).astype(np.float32)
    j = {k: jnp.asarray(v) for k, v in x.items() if k != "bucket"}
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items()
         if k != "bucket"}
    if kind in ("adam", "adamw"):
        extra = {"coeff": 0.02} if kind == "adamw" else {}
        jfn = jfu.fused_adamw_update if extra else jfu.fused_adam_update
        tfn = tfu.fused_adamw_update if extra else tfu.fused_adam_update
        want = jfn(j["p"], jnp.asarray(g), j["m1"], j["m2"], j["lr"],
                   j["b1p"], j["b2p"], **extra)
        got = tfn(t["p"], torch.from_numpy(g), t["m1"], t["m2"], t["lr"],
                  t["b1p"], t["b2p"], **extra)
    elif kind == "momentum":
        want = jfu.fused_momentum_update(j["p"], jnp.asarray(g), j["m1"],
                                         j["lr"], mu=0.8,
                                         use_nesterov=nesterov)
        got = tfu.fused_momentum_update(t["p"], torch.from_numpy(g),
                                        t["m1"], t["lr"], mu=0.8,
                                        use_nesterov=nesterov)
    else:
        want = (jfu.fused_sgd_update(j["p"], jnp.asarray(g), j["lr"]),)
        got = (tfu.fused_sgd_update(t["p"], torch.from_numpy(g), t["lr"]),)
    for gv, wv in zip(got, want):
        wv = np.asarray(wv)
        np.testing.assert_allclose(gv.numpy(), wv, rtol=RTOL,
                                   atol=RTOL * np.abs(wv).max())


def test_dequant_slice_matches_jax():
    rng = np.random.RandomState(3)
    bucket = rng.randn(16 * BS).astype(np.float32)
    jh, jl, js = jqc.quantize_block_scaled(jnp.asarray(bucket), BS)
    th, tl, ts = tqc.quantize_block_scaled(torch.from_numpy(bucket), BS)
    want = np.asarray(jfu.dequant_slice(jh, jl, js, 4, 3 * BS + 7, BS,
                                        (3 * BS + 7,)))
    got = tfu.dequant_slice(th, tl, ts, 4, 3 * BS + 7, BS, (3 * BS + 7,))
    np.testing.assert_array_equal(got.numpy(), want)


def test_entries_update_in_place_and_advance_powers():
    """The port's contract: p and the moments are the caller's tensors,
    updated in place; the beta powers advance by one step."""
    numel = 2 * BS
    x = _inputs(numel)
    got, t = _port_call("adam", False, x, numel, False)
    np.testing.assert_array_equal(t["p"].numpy(), got[0])
    np.testing.assert_array_equal(t["m1"].numpy(), got[1])
    np.testing.assert_allclose(t["b1p"].numpy(), x["b1p"] * np.float32(0.9),
                               rtol=1e-7)
    np.testing.assert_allclose(t["b2p"].numpy(),
                               x["b2p"] * np.float32(0.999), rtol=1e-7)
    assert not np.array_equal(t["p"].numpy(), x["p"])


def test_kernel_refuses_bad_block_size_and_cpu_runs_plain():
    """A CPU tensor takes the plain version (no launch); the kernel's
    argument check refuses a block size past 1024 rather than fall
    back."""
    x = _inputs(BS)
    before = tfu.fused_update_kernel.launches
    _port_call("sgd", False, x, BS, False)
    assert tfu.fused_update_kernel.launches == before
    t = {k: torch.from_numpy(v.copy()) for k, v in x.items()}
    hi, lo, sc = tqc.quantize_block_scaled(torch.zeros(2048), 2048)
    with pytest.raises(ValueError, match="block_size"):
        tfu._check_kernel_args(t["p"][:100], (hi, lo, sc, 0, 100), [],
                               2048)
    with pytest.raises(ValueError, match="force"):
        tfu.fused_sgd_update(t["p"], t["p"], t["lr"], force="pallas")


# ---------------------------------------------------------------------------
# each kind through a real program
# ---------------------------------------------------------------------------

from test_torch_port_data_parallel import (  # noqa: E402
    LOSS_RTOL, build_mlp, check_params, prefixed, run_oracle, train_port)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    return run_oracle(tmp_path_factory, "mlp")


@pytest.mark.parametrize("lane", ["momentum", "nesterov", "sgd", "adamw"])
def test_mlp_dp4_fused_kinds_match_jax(oracle, lane):
    """Each K8 kind reached through a real program: the MLP at dp 4 with
    block size 16, every optimizer op fused; 5 steps of losses and the
    final parameters within 1e-5 relative of the JAX package's."""
    feed = prefixed(oracle, "mlp:feed:")
    losses, scope, cp = train_port(
        oracle, lane, lambda: build_mlp("torch", lane), feed, 5,
        quant=True, block_size=16)
    np.testing.assert_allclose(losses, oracle[f"{lane}:loss"],
                               rtol=LOSS_RTOL, atol=0)
    check_params(oracle, lane, scope)
    kind = "momentum" if lane == "nesterov" else lane
    assert f"fused_{kind}_quant_grad" in [
        op.type for op in cp._dp_runner.program.global_block().ops]


# ---------------------------------------------------------------------------
# the group form: one call over many parameters
# ---------------------------------------------------------------------------

GROUP_BS = 6  # offsets of 3, 5, ... blocks are not multiples of 4 elements
GROUP_NUMELS = (7, 13, 1, 40, 25)  # odd and ragged members


def _group_state(kind, dual, shared_lr, seed=0):
    """A bucket image quantized by the port's codec and one member per
    GROUP_NUMELS at consecutive block offsets (after two leading
    blocks), each with its own state; the learning rate one tensor for
    all or one a member."""
    rng = np.random.RandomState(seed)
    offsets, off = [], 2
    for n in GROUP_NUMELS:
        offsets.append(off)
        off += -(-n // GROUP_BS)
    bucket = np.zeros((off + 1) * GROUP_BS, np.float32)
    for o, n in zip(offsets, GROUP_NUMELS):
        bucket[o * GROUP_BS:o * GROUP_BS + n] = rng.randn(n)
    hi, lo, sc = tqc.quantize_block_scaled(torch.from_numpy(bucket),
                                           GROUP_BS, dual_int8=dual)
    lr = torch.tensor([1e-2], dtype=torch.float32)
    members = []
    for i, (o, n) in enumerate(zip(offsets, GROUP_NUMELS)):
        def f32(a):
            return torch.from_numpy(np.asarray(a, np.float32))
        adam = kind in ("adam", "adamw")
        members.append(tfu.GroupMember(
            p=f32(rng.randn(n) * 0.1), grad=(hi, lo if dual else None, sc,
                                            o, n),
            lr=lr if shared_lr else f32([1e-2 * (i + 1)]),
            m1=f32(rng.randn(n) * 0.01) if kind != "sgd" else None,
            m2=f32(np.abs(rng.randn(n)) * 0.01) if adam else None,
            b1p=f32([0.9 ** (i + 1)]) if adam else None,
            b2p=f32([0.999 ** (i + 1)]) if adam else None))
    return members


def _copy_members(members):
    """Every member's own tensors cloned; a tensor shared by members
    stays shared in the copy."""
    seen = {}

    def c(t):
        if t is None:
            return None
        if id(t) not in seen:
            seen[id(t)] = t.clone()
        return seen[id(t)]

    return [tfu.GroupMember(c(m.p), m.grad, c(m.lr), c(m.m1), c(m.m2),
                            c(m.b1p), c(m.b2p)) for m in members]


def _state_arrays(members):
    return [t.numpy().copy() for m in members
            for t in (m.p, m.m1, m.m2, m.b1p, m.b2p) if t is not None]


GROUP_HYPER = {"sgd": {}, "momentum": dict(mu=0.8, use_nesterov=False),
               "nesterov": dict(mu=0.8, use_nesterov=True),
               "adam": dict(beta1=0.9, beta2=0.999, epsilon=1e-8),
               "adamw": dict(beta1=0.85, beta2=0.99, epsilon=1e-6,
                             coeff=0.02)}


@pytest.mark.parametrize("shared_lr", [True, False])
@pytest.mark.parametrize("dual", [True, False])
@pytest.mark.parametrize("lane", sorted(GROUP_HYPER))
def test_group_plain_bit_equal_to_per_op_calls(lane, dual, shared_lr):
    """On CPU tensors the group entry equals each member's per-parameter
    entry, bit for bit: odd and one-element members, block offsets that
    are not multiples of 4 elements, a dual and a single int8 wire, and
    a learning rate shared or one a member."""
    kind = "momentum" if lane == "nesterov" else lane
    hyper = GROUP_HYPER[lane]
    members = _group_state(kind, dual, shared_lr)
    ref = _copy_members(members)
    before = tfu.fused_update_group.launches
    tfu.fused_update_group(kind, members, hyper, GROUP_BS)
    assert tfu.fused_update_group.launches == before  # no kernel on CPU
    for m in ref:
        tfu._member_plain(kind, m, hyper, GROUP_BS, None)
    for g, w in zip(_state_arrays(members), _state_arrays(ref)):
        np.testing.assert_array_equal(g, w)
    # the update moved every parameter
    fresh = _group_state(kind, dual, shared_lr)
    assert all(not np.array_equal(m.p.numpy(), f.p.numpy())
               for m, f in zip(members, fresh))


class _FakeGroupLib:
    """Stands in for the built K8 library: a table of ``cap`` segments,
    each launch's table rows recorded."""

    def __init__(self, cap):
        self.cap = cap
        self.calls = []

    def pt_fused_update_group_capacity(self):
        return self.cap

    def pt_fused_update_group(self, kind, dual, bs, n, rows, *rest):
        table = np.ctypeslib.as_array(
            ctypes.cast(rows, ctypes.POINTER(ctypes.c_longlong)),
            shape=(n, 11)).copy()
        self.calls.append((kind, dual, bs, table, rest[:6]))
        return 0


def test_group_wrapper_hands_the_kernel_its_table(monkeypatch):
    """The kernel branch driven on CPU tensors with the build stubbed:
    one launch per table-full of members (counted per launch), each row
    the member's pointers (0 where none), block offset and numel, the
    kind's constants, and the beta powers then advanced bit-equal to a
    ``mul_`` a member."""
    lib = _FakeGroupLib(cap=2)
    monkeypatch.setattr(tfu, "_use_kernel", lambda *a: True)
    monkeypatch.setattr(_build, "load", lambda *a: lib)
    monkeypatch.setattr(_build, "stream_of",
                        lambda dev: ctypes.c_void_p(1234))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    members = _group_state("adamw", False, False)
    powers = [(m.b1p.clone(), m.b2p.clone()) for m in members]
    hyper = GROUP_HYPER["adamw"]
    before = tfu.fused_update_group.launches
    tfu.fused_update_group("adamw", members, hyper, GROUP_BS)
    assert tfu.fused_update_group.launches == before + 3  # 5 members / 2
    assert [len(c[3]) for c in lib.calls] == [2, 2, 1]
    rows = np.concatenate([c[3] for c in lib.calls])
    for m, row in zip(members, rows):
        hi, lo, sc, off, numel = m.grad
        want = [m.p.data_ptr(), m.m1.data_ptr(), m.m2.data_ptr(),
                hi.data_ptr(), 0, sc.data_ptr(), m.lr.data_ptr(),
                m.b1p.data_ptr(), m.b2p.data_ptr(), off, numel]
        assert row.tolist() == want
    for kind, dual, bs, _, consts in lib.calls:
        assert (kind, dual, bs) == (3, 0, GROUP_BS)
        np.testing.assert_array_equal(
            np.float32(consts), np.float32([0.85, 1 - 0.85, 0.99, 1 - 0.99,
                                            1e-6, 0.02]))
    for m, (b1p, b2p) in zip(members, powers):
        np.testing.assert_array_equal(m.b1p.numpy(), b1p.mul_(0.85).numpy())
        np.testing.assert_array_equal(m.b2p.numpy(), b2p.mul_(0.99).numpy())


def test_group_refuses_mixed_wires_and_fp32_grads():
    members = _group_state("sgd", True, True)
    single = _group_state("sgd", False, True)
    with pytest.raises(ValueError, match="mix"):
        tfu._group_rows("sgd", [members[0], single[1]], GROUP_BS)
    bad = members[0]._replace(grad=torch.zeros(7))
    with pytest.raises(ValueError, match="bucket slice"):
        tfu.fused_update_group("sgd", [bad], {}, GROUP_BS)
    with pytest.raises(ValueError, match="kind"):
        tfu.fused_update_group("lamb", members, {}, GROUP_BS)


# ---------------------------------------------------------------------------
# the executor's group steps
# ---------------------------------------------------------------------------


def _mlp_dp4(lane, block_size=16):
    """The MLP of test_mlp_dp4_fused_kinds_match_jax, transpiled for dp 4
    with every optimizer op fused, and its startup program."""
    from paddle_tpu_torch import passes as tpasses
    from paddle_tpu_torch.parallel import data_parallel as tdp

    main, startup, loss = build_mlp("torch", lane)
    tpasses.apply_graph_passes(main, lane="dp")
    tdp.transpile_data_parallel(main, loss.name, 4, quant_grads=True,
                                quant_block_size=block_size,
                                fused_update=True)
    return main, startup, loss


@pytest.mark.parametrize("lane", ["momentum", "nesterov", "sgd", "adamw"])
def test_plan_groups_exactly_the_fused_ops(lane):
    """The plan merges the MLP dp-4 program's four fused optimizer ops,
    and nothing else, into one group step; the program's op list is
    untouched."""
    from paddle_tpu_torch.fluid import executor as ex

    main, _, loss = _mlp_dp4(lane)
    types = [op.type for op in main.global_block().ops]
    plan = ex._Plan(main, ["x", "y"], [loss.name])
    kind = "momentum" if lane == "nesterov" else lane
    fused = [op for op in main.global_block().ops
             if op.type == f"fused_{kind}_quant_grad"]
    assert len(fused) == 4
    groups = [s for s in plan.steps if isinstance(s, ex._Group)]
    assert plan.group_sizes == [(f"fused_{kind}_quant_grad", 4)]
    assert groups[0].ops == fused
    singles = [s[0] for s in plan.steps if not isinstance(s, ex._Group)]
    assert not any(op.type.startswith("fused_") for op in singles)
    assert len(singles) + 4 == len(ex._prune_ops(main.global_block(),
                                                 [loss.name]))
    assert [op.type for op in main.global_block().ops] == types


@pytest.mark.parametrize("shared", ["beta1_pow", "read_only"])
def test_plan_breaks_a_group_at_a_shared_beta_pow(shared):
    """A member reading a Beta1Pow an earlier member of the run writes
    starts a new group: op by op it reads the advanced power.  So does
    a member that only reads a name an earlier member writes (here its
    learning rate is that member's Beta1Pow)."""
    from paddle_tpu_torch.fluid import executor as ex

    main, _, loss = _mlp_dp4("adamw")
    ops = [op for op in main.global_block().ops
           if op.type == "fused_adamw_quant_grad"]
    if shared == "beta1_pow":
        ops[2].inputs["Beta1Pow"] = list(ops[1].inputs["Beta1Pow"])
        ops[2].outputs["Beta1PowOut"] = list(ops[1].inputs["Beta1Pow"])
    else:
        ops[2].inputs["LearningRate"] = list(ops[1].inputs["Beta1Pow"])
    plan = ex._Plan(main, ["x", "y"], [loss.name])
    assert plan.group_sizes == [("fused_adamw_quant_grad", 2),
                                ("fused_adamw_quant_grad", 2)]


def test_plan_leaves_plain_adam_ungrouped():
    """The single-device train step's plain adam ops have no group form:
    every op stays its own step."""
    from paddle_tpu_torch.fluid import executor as ex

    main, _, loss = build_mlp("torch", "adamw")
    plan = ex._Plan(main, ["x", "y"], [loss.name])
    assert plan.group_sizes == []
    assert len(plan.steps) == len(ex._prune_ops(main.global_block(),
                                                [loss.name]))


@pytest.mark.parametrize("lane", ["momentum", "nesterov", "sgd", "adamw"])
def test_grouped_dp_step_equals_op_by_op(monkeypatch, lane):
    """One dp-4 step of the MLP (block size 6: offsets that are not
    multiples of 4) through the grouped plan leaves every replica's
    state bit-equal to the same step with each fused op run by its own
    lowering, op by op."""
    from paddle_tpu_torch.fluid import executor as ex

    rng = np.random.RandomState(5)
    feed = {"x": rng.randn(8, 8).astype(np.float32),
            "y": rng.randint(0, 3, (8, 1)).astype(np.int64)}
    results = {}
    for grouped in (True, False):
        if not grouped:
            monkeypatch.setattr(ex, "_merge_groups",
                                lambda steps, index: (steps, index))
        main, startup, loss = build_mlp("torch", lane)
        startup.random_seed = 3
        scope = fluid.Scope()
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        bs = fluid.compiler.BuildStrategy()
        bs.quant_allreduce = True
        cp = fluid.CompiledProgram(main, build_strategy=bs) \
            .with_data_parallel(loss_name=loss.name,
                                places=[fluid.CPUPlace()] * 4)
        old = fluid.get_flags("FLAGS_quant_allreduce_block_size")
        fluid.set_flags({"FLAGS_quant_allreduce_block_size": 6})
        try:
            exe.run(cp, feed=feed, fetch_list=[loss], scope=scope)
        finally:
            fluid.set_flags(old)
        runner = cp._dp_runner
        plan = next(iter(runner._plans.values()))
        assert bool(plan.group_sizes) == grouped
        names = [n for n in plan.writes]
        results[grouped] = {n: [t.numpy().copy() for t in
                                runner.replica_values(n)] for n in names}
    assert results[True].keys() == results[False].keys()
    for n, vals in results[True].items():
        for g, w in zip(vals, results[False][n]):
            np.testing.assert_array_equal(g, w, err_msg=n)
