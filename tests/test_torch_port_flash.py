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
causal on and off, a key bias with -1e4 pads, float32 and bfloat16; and
the head dims above 64 the kernels take (D 80 and 128, S 77 and 128).
Tolerances: 2e-5 in fp32 (the same fp32 math summed in another order);
2e-2 in bf16 (both round an fp32 result to bf16, so they may differ by
one bf16 ulp).

The bf16 CUDA K1-K3 run on the tensor cores and round P (and dS, in
two parts) to bf16 before their second products; a test-local copy of
that arithmetic is held against ``attention_reference`` and its
``jax.vjp`` within the same bf16 gate.  The fp32 CUDA K1 runs on the
tensor cores in split TF32; a test-local copy of its roundings is held
against ``attention_reference`` within the unchanged fp32 gate, and
one of the fp32 K2's and K3's (``-k split_tf32``) against the Pallas
backward in interpret mode.  Rows whose keys all carry the -1e30 bias
get uniform weights, as in the JAX kernel.
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import math
import pathlib

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


def _case(s, seed=0, d=D):
    rng = np.random.RandomState(seed + s)
    q, k, v, do = (rng.randn(B, H, s, d).astype(np.float32)
                   for _ in range(4))
    bias = np.zeros((B, 1, 1, s), np.float32)
    bias[..., s - s // 5:] = -1e4  # padded keys
    return q, k, v, bias, do


def _jax(q, k, v, bias, do, causal, dtype, oracle, scale=SM_SCALE):
    args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    args.append(jnp.asarray(bias))
    d = q.shape[-1]

    def f(q, k, v, b):
        if oracle == "reference":
            bh = b.shape[0] * H
            rows = jnp.broadcast_to(b.reshape(B, 1, -1),
                                    (B, H, b.shape[-1])).reshape(bh, -1)
            out = jflash.attention_reference(
                q.reshape(bh, -1, d), k.reshape(bh, -1, d),
                v.reshape(bh, -1, d), rows, causal, scale)
            return out.reshape(q.shape)
        return jflash.flash_attention(q, k, v, b, causal=causal,
                                      sm_scale=scale, force="pallas")

    out, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(do).astype(dtype))
    return [np.asarray(jnp.asarray(t, jnp.float32)) for t in (out,) + grads]


def _port(q, k, v, bias, do, causal, dtype, scale=SM_SCALE):
    tdt = getattr(torch, dtype)
    args = [torch.from_numpy(a).to(tdt).requires_grad_()
            for a in (q, k, v)]
    args.append(torch.from_numpy(bias).requires_grad_())
    out = tflash.flash_attention(*args, causal=causal, sm_scale=scale)
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


@pytest.mark.parametrize("oracle", ["reference", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [80, 128])
@pytest.mark.parametrize("s", [77, 128])
def test_flash_plain_matches_jax_wide_heads(s, d, causal, dtype, oracle):
    """The head dims the kernels take above 64 (D 80: a capacity of 128
    zero-filled past D; D 128, GPT-3 6.7B's): O, dQ, dK, dV and dBias of
    the plain versions against both JAX oracles, which take any D."""
    case = _case(s, d=d)
    scale = 1.0 / math.sqrt(d)
    got = _port(*case, causal, dtype, scale=scale)
    want = _jax(*case, causal, getattr(jnp, dtype), oracle, scale=scale)
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


@pytest.mark.parametrize("b", [1, 3])
def test_flash_key_bias_rows_are_contiguous(monkeypatch, b):
    """The [B, 1, 1, S] key bias becomes the [B*H, S] fp32 rows the
    kernels take contiguous: at b 1 the reshape of its expanded view was
    a zero-stride view, which K1 refused on the card (a data-parallel
    replica of one sequence)."""
    seen = {}

    def apply(q, k, v, rows, causal, scale, force):
        seen["rows"] = rows
        return (q,)

    monkeypatch.setattr(tflash._FlashAttention, "apply", apply)
    q = torch.zeros(b, 4, 16, 8)
    bias = torch.from_numpy(
        np.random.RandomState(b).randn(b, 1, 1, 16).astype(np.float32))
    tflash.flash_attention(q, q, q, bias=bias)
    rows = seen["rows"]
    assert rows.is_contiguous() and rows.shape == (b * 4, 16)
    assert torch.equal(rows, bias.reshape(b, 1, 16).expand(b, 4, 16)
                       .reshape(b * 4, 16))


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
@pytest.mark.parametrize("d", [12, 64, 128])
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


# ---------------------------------------------------------------------------
# the fp32 split-TF32 K1, K2 and K3: their roundings, held against JAX
# ---------------------------------------------------------------------------


def _tf32(x):
    """x rounded to TF32 as the kernel's ``to_tf32`` rounds it (and
    ``cvt.rna.tf32.f32`` a finite x): to 10 explicit mantissa bits, ties
    away from zero (the float's bits as an integer: half of the 13
    dropped bits added, then those bits cleared)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_split_tf32(a, b):
    """a @ b as the kernel's tensor cores take it: each operand as its
    TF32 part hi and the TF32 rounding lo of the rest, the product as
    lo_a·hi_b + hi_a·lo_b + hi_a·hi_b, summed in fp32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _k1_split_tf32(q, k, v, rows, causal, scale):
    """K1 as the fp32 kernel computes it: q·kᵀ and P·V in split TF32,
    the online softmax over 64-key tiles in fp32; O and lse fp32.  q, k,
    v [BH, S, D] fp32, rows the [BH, S] key bias."""
    bh, s, d = q.shape
    scores = _mm_split_tf32(q, k.transpose(-1, -2))
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
        acc = acc * alpha[..., None] + _mm_split_tf32(p, v[:, j])
        m = m_new
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    return acc / l_safe[..., None], m + torch.log(l_safe)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    """_tf32 keeps 10 mantissa bits: 1 + 2^-11 (a tie) rounds up to
    1 + 2^-10, 1 + 2^-12 down to 1, and the sign is kept; the kernel's
    source rounds with the same integer operations."""
    src = (pathlib.Path(tflash.__file__).parents[2] / "csrc"
           / "flash_tf32.cuh").read_text()
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in src
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11), 3.0,
                      tflash.NEG_INF])
    want = torch.tensor([1 + 2 ** -10, 1.0, -(1 + 2 ** -10), 3.0,
                         _tf32(torch.tensor([tflash.NEG_INF]))[0]])
    assert torch.equal(_tf32(x), want)
    y = torch.from_numpy(np.random.RandomState(0).randn(1000)
                         .astype(np.float32))
    hi = _tf32(y)
    assert float(((y - hi).abs() / y.abs()).max()) <= 2.0 ** -11
    assert float(((y - hi - _tf32(y - hi)).abs() / y.abs()).max()) \
        <= 2.0 ** -22


@pytest.mark.parametrize("causal,bias_mode", [(False, "pads"),
                                              (True, "pads"),
                                              (False, "masked")])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [77, 128])
def test_split_tf32_k1_matches_jax(s, d, causal, bias_mode):
    """The fp32 K1 takes each product in split TF32 (lo·lo dropped, each
    part rounded to TF32), where the JAX kernel multiplies in fp32.  With
    that rounding (and the 64-key online softmax), O stays within the
    unchanged fp32 gate (2e-5) of the JAX package's attention_reference,
    and lse within it of the JAX Pallas forward's (interpret mode, S
    padded to its block with -1e30 keys): with a -1e4 pad bias on a
    fifth of the keys, and ("masked") with every key of the second head
    at -1e30, whose rows get uniform weights."""
    rng = np.random.RandomState(s + d)
    bh = B * H
    q, k, v = (rng.randn(bh, s, d).astype(np.float32) for _ in range(3))
    bias = np.zeros((bh, s), np.float32)
    bias[:, s - s // 5:] = -1e4
    if bias_mode == "masked":
        bias[1] = -1e30
    scale = 1.0 / math.sqrt(d)
    want = np.asarray(jflash.attention_reference(
        *(jnp.asarray(a) for a in (q, k, v, bias)), causal, scale))
    tq, tk, tv, rows = (torch.from_numpy(a) for a in (q, k, v, bias))
    o, lse = _k1_split_tf32(tq, tk, tv, rows, causal, scale)
    np.testing.assert_allclose(o.numpy(), want, atol=TOL["float32"],
                               rtol=TOL["float32"])
    block = jflash.DEFAULT_BLOCK
    padded = jflash._pad_to_block(*(jnp.asarray(a) for a in (q, k, v, bias)),
                                  block)
    _, lse_want = jflash._pallas_fwd(*padded, causal, scale, True, block)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_want)[:, :s],
                               atol=TOL["float32"], rtol=TOL["float32"])
    if bias_mode == "masked":
        np.testing.assert_allclose(o[1].numpy(), np.broadcast_to(
            v[1].mean(axis=0), (s, d)), atol=1e-5, rtol=1e-5)


def _k2_k3_split_tf32(q, k, v, rows, do, lse, delta, causal, scale):
    """K2 and K3 as the fp32 kernels compute them: S = q·kᵀ and
    dP = dO·vᵀ in split TF32 over the head dim; P = exp(S·scale + bias -
    lse) (-1e30 past the diagonal); dL = P·(dP - delta), dS = dL·scale;
    dQ summed over key chunks, dK and dV over query chunks (64 at
    D <= 64, 16 above: the kernels' chunks), each chunk's product in
    split TF32 (dS, Pᵀ and dSᵀ split as they enter), the sums in fp32;
    dBias = Σ_q dL.  q, k, v, do [BH, S, D] fp32, rows the
    [BH, S] key bias, lse and delta [BH, S]."""
    s, d = q.shape[1], q.shape[2]
    x = _mm_split_tf32(q, k.transpose(-1, -2)) * scale + rows[:, None]
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool).tril()
        x = torch.where(keep, x, torch.full_like(x, tflash.NEG_INF))
    p = torch.exp(x - lse[..., None])
    dl = p * (_mm_split_tf32(do, v.transpose(-1, -2)) - delta[..., None])
    ds = dl * scale
    dq, dk, dv = (torch.zeros_like(q) for _ in range(3))
    chunk = TILE if d <= 64 else 16
    for c0 in range(0, s, chunk):  # K2: key chunks; K3: query chunks
        c = slice(c0, c0 + chunk)
        dq += _mm_split_tf32(ds[..., c], k[:, c])
        dv += _mm_split_tf32(p[:, c].transpose(-1, -2), do[:, c])
        dk += _mm_split_tf32(ds[:, c].transpose(-1, -2), q[:, c])
    return dq, dk, dv, dl.sum(dim=-2)


@pytest.mark.parametrize("causal,bias_mode", [(False, "pads"),
                                              (True, "pads"),
                                              (False, "masked")])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [77, 128])
def test_split_tf32_k2_k3_match_jax(s, d, causal, bias_mode):
    """The fp32 K2 and K3 take each product in split TF32 (lo·lo
    dropped, each part rounded to TF32) where the JAX kernels multiply
    in fp32, and dP - delta cancels after it.  With that rounding and
    the kernels' tiles, dQ, dK and dV stay within the fp32 gate (2e-5)
    and dBias within 1e-4 of the JAX package's Pallas backward
    (``_pallas_bwd``, interpret mode, S padded to its block with -1e30
    keys), given its forward's lse and O: with a -1e4 pad bias on a
    fifth of the keys, and ("masked") every key of the second head at
    -1e30, whose rows take P = 1 for every key."""
    rng = np.random.RandomState(2 * s + d)
    bh = B * H
    q, k, v, do = (rng.randn(bh, s, d).astype(np.float32)
                   for _ in range(4))
    bias = np.zeros((bh, s), np.float32)
    bias[:, s - s // 5:] = -1e4
    if bias_mode == "masked":
        bias[1] = -1e30
    scale = 1.0 / math.sqrt(d)
    block = jflash.DEFAULT_BLOCK
    padded = jflash._pad_to_block(*(jnp.asarray(a) for a in (q, k, v, bias)),
                                  block)
    do_pad = jnp.pad(jnp.asarray(do),
                     ((0, 0), (0, padded[0].shape[1] - s), (0, 0)))
    o, lse = jflash._pallas_fwd(*padded, causal, scale, True, block)
    want = jflash._pallas_bwd(*padded, o, lse, do_pad, causal, scale, True,
                              block)
    o, lse = (torch.from_numpy(np.array(t)[:, :s]) for t in (o, lse))
    tq, tk, tv, tdo, rows = (torch.from_numpy(a)
                             for a in (q, k, v, do, bias))
    delta = (tdo * o).sum(-1)
    got = _k2_k3_split_tf32(tq, tk, tv, rows, tdo, lse, delta, causal,
                            scale)
    for name, g, w in zip(("dQ", "dK", "dV", "dBias"), got, want):
        tol = 1e-4 if name == "dBias" else TOL["float32"]
        np.testing.assert_allclose(g.numpy(), np.asarray(w)[:, :s],
                                   atol=tol, rtol=tol, err_msg=name)


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


def _nmt_slice(seed, bh=4, s=256, d=64, lengths=(1, 3, 17, 256)):
    """A narrow slice of chip_smoke's nmt_enc_s256 K3 case: bf16 q, k, v,
    dO (as fp32 arrays holding bf16 values), each row's keys past its
    length at -1e9 as bf16 holds it (-999817216), short rows included."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(bh, s, d, generator=g).to(torch.bfloat16)
                   .float().numpy() for _ in range(4))
    pad = torch.tensor(-1e9).to(torch.bfloat16).item()
    bias = np.zeros((bh, s), np.float32)
    for i, ln in enumerate(lengths):
        bias[i, ln:] = pad
    return q, k, v, do, bias


def test_plain_k3_matches_jax_at_the_nmt_encoder_slice():
    """The plain K3 (dK, dV, dBias) in fp32 against the JAX package's
    Pallas backward (interpret mode) at [4, 256, 64] with the bf16
    -1e9 pad bias and rows of 1-256 real keys, given the JAX forward's
    O and lse: within the fp32 gate.  The exact answer the card's bf16
    K3 is held to (chip_smoke.bf16_dkv_over_bound) is this plain
    version's arithmetic."""
    q, k, v, do, bias = _nmt_slice(0)
    s, d = q.shape[1], q.shape[2]
    scale = 1.0 / math.sqrt(d)
    block = jflash.DEFAULT_BLOCK
    args = [jnp.asarray(a) for a in (q, k, v, bias)]
    o, lse = jflash._pallas_fwd(*args, False, scale, True, block)
    want = jflash._pallas_bwd(*args, o, lse, jnp.asarray(do), False, scale,
                              True, block)
    tq, tk, tv, tdo, rows = (torch.from_numpy(a)
                             for a in (q, k, v, do, bias))
    o, lse = (torch.from_numpy(np.array(t)) for t in (o, lse))
    delta = (tdo * o).sum(-1)
    dk, dv, db = tflash.flash_bwd_dkv_reference(tq, tk, tv, rows, tdo, lse,
                                                delta, False, scale)
    truth = tflash.flash_bwd_dkv_truth(tq.to(torch.bfloat16),
                                       tk.to(torch.bfloat16),
                                       tv.to(torch.bfloat16), rows,
                                       tdo.to(torch.bfloat16), lse, delta,
                                       False, scale)
    for name, g, w, tol in (("dK", dk, want[1], TOL["float32"]),
                            ("dV", dv, want[2], TOL["float32"]),
                            ("dBias", db, want[3], 1e-4)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol,
                                   rtol=tol, err_msg=name)
    assert torch.equal(truth[0], dk) and torch.equal(truth[1], dv)
    # a pad key's grads are 0 exactly
    assert float(dv[0, 1:].abs().max()) == 0.0
    assert float(dk[0, 1:].abs().max()) == 0.0


def test_bf16_k3_rounding_stays_within_its_bound_not_2e_2():
    """The bf16 K3's arithmetic, emulated on the CPU (P rounded to bf16
    into Pᵀ·dO; dS as bf16 hi + lo into dSᵀ·Q; fp32 sums; outputs
    rounded to bf16), at the nmt_enc_s256 slice over 8 seeds: dK and dV
    stay within ``flash_bwd_dkv_bf16_bound`` of the exact answer, while
    dV leaves 2e-2 of the plain bf16 version on a short row — the
    reading chip_smoke.py's phase 3 met on the card (ROADMAP §3)."""
    outside = 0
    for seed in range(8):
        q, k, v, do, bias = _nmt_slice(seed)
        d = q.shape[2]
        scale = 1.0 / math.sqrt(d)
        tq, tk, tv, tdo = (torch.from_numpy(a).to(torch.bfloat16)
                           for a in (q, k, v, do))
        rows = torch.from_numpy(bias)
        o, lse = tflash.flash_fwd_reference(tq, tk, tv, rows, False, scale)
        delta = (tdo.float() * o.float()).sum(-1)
        args = (tq, tk, tv, rows, tdo, lse, delta, False, scale)
        p = tflash._probs(tq, tk, rows, lse, False, scale)
        dv = torch.matmul(p.to(torch.bfloat16).float().transpose(-1, -2),
                          tdo.float()).to(torch.bfloat16).float()
        dp = torch.matmul(tdo.float(), tv.float().transpose(-1, -2))
        ds = p * (dp - delta[..., None]) * scale
        hi = ds.to(torch.bfloat16).float()
        lo = (ds - hi).to(torch.bfloat16).float()
        dk = (torch.matmul(hi.transpose(-1, -2), tq.float())
              + torch.matmul(lo.transpose(-1, -2), tq.float())) \
            .to(torch.bfloat16).float()
        truth = tflash.flash_bwd_dkv_truth(*args)
        bound = tflash.flash_bwd_dkv_bf16_bound(*args)
        plain = tflash.flash_bwd_dkv(*args)
        for got, t_, b_, pl in zip((dk, dv), truth, bound, plain):
            err = (got - t_).abs()
            assert bool((err <= b_).all())
            assert float((pl.float() - t_).abs().max()) <= float(
                b_.max())
        outside += not torch.allclose(dv, plain[1].float(), atol=2e-2,
                                      rtol=2e-2)
    assert outside > 0
