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
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import fused_update as jfu
from paddle_tpu.kernels import quantized_collectives as jqc

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
