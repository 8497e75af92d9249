"""K1-K3, flash attention forward and backward, of the PyTorch port
against the JAX package.

On the CPU the port's ``flash_attention`` runs the plain versions of
K1 (forward) and, under autograd, K2/K3 (backward).  They are
held here against the JAX package's two oracles on the same seeded
numpy inputs: the materializing ``attention_reference`` (differentiated
by ``jax.vjp``) and the Pallas kernels themselves in interpret mode
(``force="pallas"``, as tests/test_flash_attention.py runs them), which
also runs the JAX custom VJP, i.e. the Pallas backward kernels.  The
CUDA kernels are held against these plain versions on the card
(tests/test_torch_port_cuda.py, ``chip_smoke.py``).

Cases: S in {64, 128, 200} (200 is a ragged tile for both packages),
causal on and off, a key bias with -1e4 pads, float32 and bfloat16.
Tolerances: 2e-5 in fp32 (the same fp32 math summed in another order);
2e-2 in bf16 (both round an fp32 result to bf16, so they may differ by
one bf16 ulp).

The bf16 CUDA K1-K3 run on the tensor cores and round P (and dS, in
two parts) to bf16 before their second products; a test-local copy of
that arithmetic is held against ``attention_reference`` and its
``jax.vjp`` within the same bf16 gate.  Rows whose keys all carry the
-1e30 bias get uniform weights, as in the JAX kernel.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.kernels.primitives import flash as jflash

from paddle_tpu_torch.kernels.primitives import flash as tflash

B, H, D = 1, 2, 32
SM_SCALE = 1.0 / math.sqrt(D)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _case(s, seed=0):
    rng = np.random.RandomState(seed + s)
    q, k, v, do = (rng.randn(B, H, s, D).astype(np.float32)
                   for _ in range(4))
    bias = np.zeros((B, 1, 1, s), np.float32)
    bias[..., s - s // 5:] = -1e4  # padded keys
    return q, k, v, bias, do


def _jax(q, k, v, bias, do, causal, dtype, oracle):
    args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    args.append(jnp.asarray(bias))

    def f(q, k, v, b):
        if oracle == "reference":
            bh = b.shape[0] * H
            rows = jnp.broadcast_to(b.reshape(B, 1, -1),
                                    (B, H, b.shape[-1])).reshape(bh, -1)
            out = jflash.attention_reference(
                q.reshape(bh, -1, D), k.reshape(bh, -1, D),
                v.reshape(bh, -1, D), rows, causal, SM_SCALE)
            return out.reshape(q.shape)
        return jflash.flash_attention(q, k, v, b, causal=causal,
                                      sm_scale=SM_SCALE, force="pallas")

    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(do).astype(dtype))
    return [np.asarray(jnp.asarray(t, jnp.float32)) for t in (out,) + grads]


def _port(q, k, v, bias, do, causal, dtype):
    tdt = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(tdt).requires_grad_()
            for a in (q, k, v)]
    args.append(torch.from_numpy(bias).requires_grad_())
    out = tflash.flash_attention(*args, causal=causal, sm_scale=SM_SCALE)
    grads = torch.autograd.grad(out, args, torch.from_numpy(do).to(tdt))
    out = out.detach()
    assert out.dtype == tdt and grads[0].dtype == tdt
    assert grads[3].dtype == torch.float32
    return [t.float().numpy() for t in (out,) + grads]


@pytest.mark.parametrize("oracle", ["reference", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [64, 128, 200])
def test_flash_plain_matches_jax(s, causal, dtype, oracle):
    """O, dQ, dK, dV and dBias ([B, 1, 1, S], summed over heads)."""
    case = _case(s)
    got = _port(*case, causal, dtype)
    want = _jax(*case, causal, getattr(jnp, dtype), oracle)
    tol = TOL[dtype]
    for name, g, w in zip(("O", "dQ", "dK", "dV", "dBias"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, atol=tol, rtol=tol, err_msg=name)


def test_flash_kernel_entry_points_on_cpu_run_plain_versions():
    """Each launcher runs its plain version on a CPU tensor, counts no
    launch, and keeps the JAX contract: lse is the row logsumexp, O and
    the grads keep q's dtype, dBias is fp32."""
    q, k, v, bias, do = (torch.from_numpy(a) for a in _case(64))
    rows = bias.reshape(B, 1, -1).expand(B, H, -1).reshape(B * H, -1)
    counts = [f.launches for f in (tflash.flash_fwd, tflash.flash_bwd_dq,
                                   tflash.flash_bwd_dkv)]
    o, lse = tflash.flash_fwd(q, k, v, rows.contiguous(), False, SM_SCALE)
    s = torch.matmul(q, k.transpose(-1, -2)) * SM_SCALE \
        + bias.reshape(B, 1, 1, -1)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1))
    delta = (do * o).sum(-1).reshape(B * H, -1)
    args = (q, k, v, rows.contiguous(), do, lse.reshape(B * H, -1), delta,
            False, SM_SCALE)
    dq = tflash.flash_bwd_dq(*args)
    dk, dv, db = tflash.flash_bwd_dkv(*args)
    assert db.dtype == torch.float32 and tuple(db.shape) == (B * H, 64)
    assert dq.shape == dk.shape == dv.shape == q.shape
    assert [f.launches for f in (tflash.flash_fwd, tflash.flash_bwd_dq,
                                 tflash.flash_bwd_dkv)] == counts


def test_flash_three_dim_input_and_bias_forms_agree():
    """[BH, S, D] with a [BH, S] bias gives what [B, H, S, D] with the
    [B, 1, 1, S] and [B, S] bias forms give."""
    q, k, v, bias, _ = (torch.from_numpy(a) for a in _case(64))
    want = tflash.flash_attention(q, k, v, bias, sm_scale=SM_SCALE)
    got_bs = tflash.flash_attention(q, k, v, bias.reshape(B, -1),
                                    sm_scale=SM_SCALE)
    rows = bias.reshape(B, 1, -1).expand(B, H, -1).reshape(B * H, -1)
    got3 = tflash.flash_attention(q.reshape(B * H, -1, D),
                                  k.reshape(B * H, -1, D),
                                  v.reshape(B * H, -1, D), rows,
                                  sm_scale=SM_SCALE)
    torch.testing.assert_close(got_bs, want)
    torch.testing.assert_close(got3.reshape(want.shape), want)


def test_flash_wrapper_checks():
    q, k, v, bias, _ = (torch.from_numpy(a) for a in _case(64))
    with pytest.raises(ValueError, match="must match"):
        tflash.flash_attention(q, k[..., :16], v, bias)
    with pytest.raises(ValueError, match="force"):
        tflash.flash_attention(q, k, v, bias, force="pallas")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tflash.flash_attention(q.double(), k.double(), v.double(), bias)


# ---------------------------------------------------------------------------
# the bf16 tensor-core K1 and K3: their roundings, held against JAX
# ---------------------------------------------------------------------------

TILE = 64  # keys a K1 stage


def _k1_tensor_core(q, k, v, rows, causal, scale):
    """K1 as the bf16 kernel computes it: bf16 q·kᵀ summed in fp32, the
    online softmax over 64-key tiles in fp32, P rounded to bf16 before
    P·V (fp32 sums); O in bf16, lse fp32.  q, k, v [BH, S, D] bf16."""
    bh, s, d = q.shape
    qf, kf, vf = q.float(), k.float(), v.float()
    scores = qf @ kf.transpose(-1, -2)
    m = torch.full((bh, s), tflash.NEG_INF)
    l = torch.zeros(bh, s)
    acc = torch.zeros(bh, s, d)
    rows_i = torch.arange(s)[:, None]
    for k0 in range(0, s, TILE):
        j = torch.arange(k0, min(k0 + TILE, s))
        x = scores[..., j] * scale + rows[:, None, j]
        if causal:
            x = torch.where(j[None, :] <= rows_i, x,
                            torch.full_like(x, tflash.NEG_INF))
        m_new = torch.maximum(m, x.max(-1).values)
        alpha = torch.exp(m - m_new)
        p = torch.exp(x - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.bfloat16().float() @ vf[:, j]
        m = m_new
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).bfloat16(), m + torch.log(l_safe)


def _p_dl(q, k, v, rows, do, lse, delta, causal, scale):
    """P = exp(s·scale + bias - lse) and dL = P·(dO·vᵀ - delta) as the
    bf16 K2 and K3 compute them: bf16 products summed in fp32."""
    s = q.shape[1]
    x = (q.float() @ k.float().transpose(-1, -2)) * scale + rows[:, None]
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool).tril()
        x = torch.where(keep, x, torch.full_like(x, tflash.NEG_INF))
    p = torch.exp(x - lse[..., None])
    return p, p * (do.float() @ v.float().transpose(-1, -2)
                   - delta[..., None])


def _split(ds):
    """dS as the kernels hand it to the tensor cores: two bf16 parts, dS
    rounded and the remainder rounded."""
    hi = ds.bfloat16().float()
    return hi, (ds - hi).bfloat16().float()


def _k2_tensor_core(q, k, v, rows, do, lse, delta, causal, scale):
    """K2 as the bf16 kernel computes it: dS = dL·scale as two bf16
    parts, each multiplied by k; fp32 sums; dQ bf16."""
    _, dl = _p_dl(q, k, v, rows, do, lse, delta, causal, scale)
    hi, lo = _split(dl * scale)
    return (hi @ k.float() + lo @ k.float()).bfloat16()


def _k3_tensor_core(q, k, v, rows, do, lse, delta, causal, scale):
    """K3 as the bf16 kernel computes it: Pᵀ rounded to bf16 before
    Pᵀ·dO; dSᵀ = dLᵀ·scale as two bf16 parts, each multiplied by q; fp32
    sums; dK, dV bf16, dBias fp32 = Σ_q dL."""
    p, dl = _p_dl(q, k, v, rows, do, lse, delta, causal, scale)
    dv = p.bfloat16().float().transpose(-1, -2) @ do.float()
    hi, lo = _split(dl * scale)
    dk = hi.transpose(-1, -2) @ q.float() + lo.transpose(-1, -2) @ q.float()
    return dk.bfloat16(), dv.bfloat16(), dl.sum(dim=-2)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [12, 64])
@pytest.mark.parametrize("s", [77, 128, 200])
def test_tensor_core_roundings_match_jax(s, d, causal):
    """The bf16 K1 and K3 round P to bf16, and K2 and K3 split dS into
    two bf16 parts, where the JAX kernel keeps both fp32.  With those
    roundings (and the 64-key online softmax), O, dQ, dK, dV and dBias
    stay within the unchanged bf16 gate (2e-2) of the JAX package's
    attention_reference and its jax.vjp on the same bf16 inputs, a -1e4
    pad bias on a fifth of the keys."""
    rng = np.random.RandomState(s + d)
    bh = B * H
    q, k, v, do = (rng.randn(bh, s, d).astype(np.float32)
                   for _ in range(4))
    bias = np.zeros((bh, s), np.float32)
    bias[:, s - s // 5:] = -1e4
    scale = 1.0 / math.sqrt(d)

    def ref(q, k, v, b):
        return jflash.attention_reference(q, k, v, b, causal, scale)

    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    out, vjp = jax.vjp(ref, *jargs, jnp.asarray(bias))
    want = [np.asarray(jnp.asarray(t, jnp.float32))
            for t in (out,) + vjp(jnp.asarray(do).astype(jnp.bfloat16))]

    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16() for a in (q, k, v, do))
    rows = torch.from_numpy(bias)
    o, lse = _k1_tensor_core(tq, tk, tv, rows, causal, scale)
    delta = (tdo.float() * o.float()).sum(-1)
    dq = _k2_tensor_core(tq, tk, tv, rows, tdo, lse, delta, causal, scale)
    dk, dv, dbias = _k3_tensor_core(tq, tk, tv, rows, tdo, lse, delta,
                                    causal, scale)
    got = {"O": o, "dQ": dq, "dK": dk, "dV": dv, "dBias": dbias}
    for name, w in zip(("O", "dQ", "dK", "dV", "dBias"), want):
        np.testing.assert_allclose(got[name].float().numpy(), w,
                                   atol=TOL["bfloat16"],
                                   rtol=TOL["bfloat16"], err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_fully_masked_rows_match_jax(causal):
    """Every key of a row carries the -1e30 bias: the JAX kernel (and
    its reference) give the row uniform weights, O = the mean of V; the
    plain forward once returned exp(s - lse)·V = S x that mean, because
    lse rounds to -1e30.  The grads follow the JAX kernel's backward,
    whose P = exp(s - lse) is 1 for every key of such a row.  S = 128, a
    whole Pallas block: the Pallas kernel pads S to its block, and
    padded keys would join a fully masked row's average."""
    q, k, v, bias, do = _case(128)
    bias[...] = -1e30
    got = _port(q, k, v, bias, do, causal, "float32")
    for oracle in ("reference", "pallas"):
        want = _jax(q, k, v, bias, do, causal, jnp.float32, oracle)
        np.testing.assert_allclose(got[0], want[0], atol=TOL["float32"],
                                   rtol=TOL["float32"], err_msg=oracle)
    for name, g, w in zip(("dQ", "dK", "dV", "dBias"), got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    if not causal:
        np.testing.assert_allclose(got[0], np.broadcast_to(
            v.mean(axis=2, keepdims=True), v.shape), atol=1e-5, rtol=1e-5)
