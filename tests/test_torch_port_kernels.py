"""The port's two kernels (K4 fused bias+GeLU, K5 paged attention) against
the JAX package.

On the CPU each wrapper runs its plain PyTorch version; those are held
here against the JAX oracles — the XLA reference and the Pallas kernel
in interpret mode — on the same seeded numpy inputs.  The CUDA kernels
themselves run only on a GPU: tests/test_torch_port_cuda.py holds them
against the plain versions there, and ``python3 chip_smoke.py`` does the
same at the decode lane's full-width shapes.

Tolerances: K5 1e-5 (fp32, the oracles sum keys in another order); K4
1e-6 (the same elementwise formula; erfc/tanh may differ by an ulp).
"""

import torch_port_threads  # noqa: F401  (one torch thread a process)
import ctypes

import numpy as np
import pytest
import torch

import jax
from scipy.special import erfc

from paddle_tpu.kernels import fused_bias_act as jfba
from paddle_tpu.kernels.primitives import paged as jpaged

from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import fused_bias_act as tfba
from paddle_tpu_torch.kernels.primitives import paged as tpaged

K5_TOL = 1e-5
K4_TOL = 1e-6


# ---------------------------------------------------------------------------
# K5 paged attention
# ---------------------------------------------------------------------------

PGS, MAXP, NPAGES, N, D = 4, 4, 13, 2, 16

# q_start cases: start of the pool, a page boundary, mid-page, and the
# last query at the last position of a full page table
Q_STARTS = {"zero": 0, "page_boundary": PGS, "mid_page": PGS + 2,
            "full_length": None}


def _paged_case(t, start, seed=0):
    rng = np.random.RandomState(seed)
    b = 3
    if start is None:
        start = MAXP * PGS - t
    q = rng.randn(b, N, t, D).astype(np.float32)
    kp = rng.randn(NPAGES, PGS, N, D).astype(np.float32)
    vp = rng.randn(NPAGES, PGS, N, D).astype(np.float32)
    pages = rng.permutation(np.arange(1, NPAGES))
    table = np.zeros((b, MAXP), np.int32)
    q_start = np.array([start, max(start - 1, 0), min(start + 1,
                                                       MAXP * PGS - t)],
                       np.int32)
    for r in range(b):
        live = (q_start[r] + t - 1) // PGS + 1
        table[r, :live] = pages[r * MAXP:r * MAXP + live]
    return q, kp, vp, table, q_start


def _port_paged(q, kp, vp, table, q_start, **kw):
    out = tpaged.paged_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(q_start),
        sm_scale=D ** -0.5, **kw)
    return out.numpy()


@pytest.mark.parametrize("oracle", ["reference", "pallas"])
@pytest.mark.parametrize("start", sorted(Q_STARTS))
@pytest.mark.parametrize("t", [1, 4])
def test_paged_plain_matches_jax(t, start, oracle):
    case = _paged_case(t, Q_STARTS[start])
    got = _port_paged(*case)
    if oracle == "reference":
        want = jpaged.paged_attention_reference(*case, sm_scale=D ** -0.5)
    else:
        want = jpaged.paged_attention(*case, sm_scale=D ** -0.5,
                                      force="pallas")
    np.testing.assert_allclose(got, np.asarray(want), atol=K5_TOL,
                               rtol=K5_TOL)


def test_paged_never_attends_trash_page():
    """Poisoning page 0 (the trash page) changes nothing: no row's mask
    exposes it."""
    q, kp, vp, table, q_start = _paged_case(4, PGS + 2)
    clean = _port_paged(q, kp, vp, table, q_start)
    kp[0] = 1e4
    vp[0] = -1e4
    np.testing.assert_array_equal(_port_paged(q, kp, vp, table, q_start),
                                  clean)


def test_paged_wrapper_checks():
    q, kp, vp, table, q_start = (torch.from_numpy(a)
                                 for a in _paged_case(1, 0))
    with pytest.raises(ValueError, match="one dtype"):
        tpaged.paged_attention(q, kp, vp.double(), table, q_start)
    with pytest.raises(ValueError, match="page_table"):
        tpaged.paged_attention(q, kp, vp, table[:1], q_start)
    with pytest.raises(ValueError, match="force"):
        tpaged.paged_attention(q, kp, vp, table, q_start, force="pallas")
    launches = tpaged.paged_attention.launches
    ref = tpaged.paged_attention(q, kp, vp, table, q_start,
                                 force="reference")
    assert tpaged.paged_attention.launches == launches  # no kernel on CPU
    assert ref.shape == q.shape


WARPS = 8  # the warps of K5's CTA, as its library reports them


@pytest.mark.parametrize("max_pages,page_size", [
    (1, 16), (8, 16), (9, 16), (64, 16), (64, 32), (40, 4), (33, 1)])
@pytest.mark.parametrize("b,n,t,d", [(8, 12, 1, 64), (1, 3, 32, 6)])
def test_paged_split_plan_covers_every_page_once(b, n, t, d, max_pages,
                                                 page_size):
    """K5's split plan, from shapes alone: its chunks cover each logical
    page exactly once, and the partials workspace is [B, n, T, splits,
    d + 2] fp32 with B * n * T arrival counters when there is more than
    one chunk, else none."""
    plan = tpaged.split_plan(b, n, t, d, max_pages, page_size, WARPS)
    assert plan == tpaged.split_plan(b, n, t, d, max_pages, page_size,
                                     WARPS)
    chunks = [_split_pages(plan, s, max_pages) for s in range(plan.splits)]
    assert [p for c in chunks for p in c] == list(range(max_pages))
    assert all(chunks)  # no chunk is empty
    assert plan.pages_per_split % WARPS == 0  # whole pages for each warp
    if plan.splits == 1:
        assert plan.workspace is None and plan.arrivals == 0
    else:
        assert plan.workspace == (b, n, t, plan.splits, d + 2)
        assert plan.arrivals == b * n * t
    if page_size == 16:  # one page a warp: 8 pages a split
        assert plan.pages_per_split == 8


def _split_pages(plan, split, max_pages):
    """The logical pages chunk ``split`` covers, as the kernel's CTA
    takes them: [split * pages_per_split, + pages_per_split) within the
    page table."""
    first = split * plan.pages_per_split
    return list(range(first, min(first + plan.pages_per_split, max_pages)))


class _FakeLib:
    """Stands in for the built library: a CTA of ``warps`` warps, and
    each launch's arguments recorded."""

    def __init__(self, warps):
        self.warps = warps
        self.calls = []

    def pt_paged_warps(self):
        return self.warps

    def pt_paged_attention_f32(self, *args):
        self.calls.append(args)
        return 0


def test_paged_wrapper_passes_the_shape_plan(monkeypatch):
    """The wrapper's kernel branch, driven on CPU tensors with the build
    stubbed (each pointer argument is handed over as its tensor): it
    plans with the library's warps, hands the kernel the plan's numbers,
    a workspace of the plan's shape and zeroed arrival counters, the same
    plan for other q_start and page-table values (nothing read from the
    tensors' values), and the same counters for the next launch in the
    stream."""
    lib = _FakeLib(warps=4)
    monkeypatch.setattr(tpaged, "_use_kernel", lambda *a: True)
    monkeypatch.setattr(_build, "load", lambda *a: lib)
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    monkeypatch.setattr(_build, "stream_of",
                        lambda dev: ctypes.c_void_p(1234))
    monkeypatch.setattr(tpaged, "_arrivals", {})
    rng = np.random.RandomState(0)
    b, n, t, d, pgs, maxp = 2, 3, 1, 16, 16, 64
    q = torch.from_numpy(rng.randn(b, n, t, d).astype(np.float32))
    pool = torch.zeros(2 * maxp + 1, pgs, n, d)
    plan = tpaged.split_plan(b, n, t, d, maxp, pgs, 4)
    assert (plan.pages_per_split, plan.splits) == (4, 16)
    before = tpaged.paged_attention.launches
    for starts in ([0, 5], [1023, 700]):
        table = torch.from_numpy(rng.randint(1, 2 * maxp + 1, (b, maxp))
                                 .astype(np.int32))
        tpaged.paged_attention(q, pool, pool, table,
                               torch.tensor(starts, dtype=torch.int32))
    assert tpaged.paged_attention.launches == before + 2
    for part, arrivals, *ints in (c[6:17] for c in lib.calls):
        assert part.shape == plan.workspace and part.dtype == torch.float32
        assert arrivals.dtype == torch.int32
        assert arrivals.numel() >= plan.arrivals and not arrivals.any()
        assert tuple(ints) == (b, n, t, d, pgs, maxp, 2 * maxp + 1,
                               plan.pages_per_split, plan.splits)
    assert lib.calls[0][7] is lib.calls[1][7]  # one set for the stream
    # one split: null workspace and counters
    lib.calls.clear()
    small = torch.zeros(5, pgs, n, d)
    one = tpaged.split_plan(b, n, t, d, 2, pgs, 4)
    tpaged.paged_attention(q, small, small,
                           torch.ones(b, 2, dtype=torch.int32),
                           torch.zeros(b, dtype=torch.int32))
    assert one.splits == 1 and one.workspace is None
    assert lib.calls[0][6:8] == (None, None)
    assert lib.calls[0][15:17] == (one.pages_per_split, 1)


def test_paged_cpu_wrapper_takes_plain_version_without_a_plan(monkeypatch):
    """On CPU tensors the wrapper runs the plain version: no split plan,
    no workspace, no build, no launch counted."""
    def boom(*a, **kw):
        raise AssertionError("the kernel branch ran on CPU tensors")

    monkeypatch.setattr(tpaged, "split_plan", boom)
    monkeypatch.setattr(_build, "load", boom)
    q, kp, vp, table, q_start = (torch.from_numpy(a)
                                 for a in _paged_case(1, PGS + 2))
    launches = tpaged.paged_attention.launches
    out = tpaged.paged_attention(q, kp, vp, table, q_start,
                                 sm_scale=D ** -0.5)
    assert tpaged.paged_attention.launches == launches
    np.testing.assert_array_equal(out.numpy(), _port_paged(
        *(a.numpy() for a in (q, kp, vp, table, q_start)),
        force="reference"))


@pytest.mark.parametrize("t", [1, 3])
def test_paged_plain_at_split_shapes_matches_jax(t):
    """The port's plain K5, which the card's tests hold the split form
    against, matches the JAX package's paged_attention_reference where
    the split form splits (40 pages of 4: two splits of 32 pages), with
    rows that end in the first split, on the split boundary and in the
    second."""
    rng = np.random.RandomState(t)
    b, n, d, pgs, maxp = 4, 2, 16, 4, 40
    npages = b * maxp + 1
    q = rng.randn(b, n, t, d).astype(np.float32)
    kp = rng.randn(npages, pgs, n, d).astype(np.float32)
    vp = rng.randn(npages, pgs, n, d).astype(np.float32)
    q_start = np.array([0, 127 - (t - 1), 128, 160 - t], np.int32)
    table = np.zeros((b, maxp), np.int32)
    perm = rng.permutation(np.arange(1, npages))
    for r in range(b):
        live = (q_start[r] + t - 1) // pgs + 1
        table[r, :live] = perm[r * maxp:r * maxp + live]
    assert tpaged.split_plan(b, n, t, d, maxp, pgs, WARPS).splits == 2
    got = _port_paged(q, kp, vp, table, q_start)
    want = jpaged.paged_attention_reference(q, kp, vp, table, q_start,
                                            sm_scale=D ** -0.5)
    np.testing.assert_allclose(got, np.asarray(want), atol=K5_TOL,
                               rtol=K5_TOL)


# ---------------------------------------------------------------------------
# K4 fused bias + GeLU (+ dropout mask)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dropout", [False, True])
@pytest.mark.parametrize("approximate", [False, True])
@pytest.mark.parametrize("h", [128, 256])
def test_bias_gelu_plain_matches_pallas_interpret(monkeypatch, h,
                                                  approximate, dropout):
    """Held against the JAX Pallas kernel in interpret mode; with
    dropout, the uint8 mask the JAX function drew is fed to the port."""
    monkeypatch.setenv("PT_FUSED_BIAS_ACT_IMPL", "interpret")
    rng = np.random.RandomState(h + 2 * approximate + dropout)
    x = rng.randn(5, 3, h).astype(np.float32) * 3
    bias = rng.randn(h).astype(np.float32)
    p = 0.25 if dropout else 0.0
    want, mask = jfba.fused_bias_gelu_dropout(
        x, bias, dropout_prob=p, approximate=approximate,
        rng_key=jax.random.key(7) if dropout else None)
    tmask = None if mask is None else torch.from_numpy(np.asarray(mask))
    got = tfba.fused_bias_gelu(torch.from_numpy(x), torch.from_numpy(bias),
                               mask=tmask, scale=1.0 / (1.0 - p),
                               approximate=approximate)
    assert (mask is not None) == dropout
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=K4_TOL,
                               rtol=K4_TOL)


def test_bias_gelu_ragged_width_plain():
    """The port keeps no H % 128 rule: any width runs (here against the
    JAX XLA branch, which is what the JAX package takes for H = 37)."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 37).astype(np.float32)
    bias = rng.randn(37).astype(np.float32)
    want, _ = jfba.fused_bias_gelu_dropout(x, bias)
    got = tfba.fused_bias_gelu(torch.from_numpy(x), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=K4_TOL,
                               rtol=K4_TOL)


def test_bias_gelu_wrapper_checks():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="bias"):
        tfba.fused_bias_gelu(x, torch.zeros(7))
    with pytest.raises(TypeError, match="float32"):
        tfba.fused_bias_gelu(x.double(), torch.zeros(8))
    with pytest.raises(ValueError, match="mask"):
        tfba.fused_bias_gelu(x, torch.zeros(8),
                             mask=torch.ones(2, 8, dtype=torch.bool))


# ---------------------------------------------------------------------------
# K0 launch layer
# ---------------------------------------------------------------------------


def test_build_failure_raises(monkeypatch, tmp_path):
    """A failed nvcc run raises with the compiler's output; nothing is
    loaded."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="kernel build failed"):
        _build.build_all(["paged_attention"])
    assert not list(tmp_path.glob("*.so"))


def test_build_names_library_by_source_hash():
    assert _build.sources() == ["flash_attention", "fused_bias_act",
                                "fused_update", "paged_attention",
                                "ragged_attention"]
    paths = [_build._so_path(n) for n in _build.sources()]
    assert all(p.parent == _build.BUILD_DIR for p in paths)
    assert len(set(paths)) == len(paths)
    a = paths[1]
    assert a == _build._so_path("fused_bias_act")  # stable


# ---------------------------------------------------------------------------
# K4's GeLU as the CUDA kernel evaluates it, and what the wrapper hands it
# ---------------------------------------------------------------------------

# gelu_exact in csrc/fused_bias_act.cu: u = min(|x|·√(log2(e)/2), UMAX),
# q = (u − 3)/(u + 3), h = 2^(−u²)·P(q) = 0.5·erfc(|x|/√2), Φ = 1 − h for
# x >= 0 else h.  P's coefficients, highest degree first.
GELU_U_SCALE, GELU_UMAX, GELU_K = 8.493218003e-01, 1.141066288e+01, 3.0
GELU_P = (1.417925960e-04, 3.844848543e-04, -1.354722423e-03,
          -1.940678339e-03, 1.988566667e-02, -6.243826821e-02,
          1.258567274e-01, -1.859859377e-01, 1.054900959e-01)
# the bounds the source note states, in fp32 ulps of the result: against
# the exact GeLU (float64) and against jax.nn.gelu, itself off in the
# tail by the same rounding of x² in its exponent
GELU_ULP_BOUND = {"exact": {"x >= -4": 32, "x < -4": 256},
                  "jax": {"x >= -4": 32, "x < -4": 320}}


def _gelu_kernel_f32(x, rcp_ulps=0, ex2_ulps=0):
    """The kernel's formula in float32, each operation rounded once (an
    FMA as one rounding of the exact product and sum).  The reciprocal
    and 2^y are correctly rounded, then moved by ``rcp_ulps`` and
    ``ex2_ulps`` ulps: the card's rcp.approx and ex2.approx may each be
    1-2 ulp off."""
    f32, f64 = np.float32, np.float64

    def off(a, ulps):
        return (a + f32(ulps) * np.spacing(a)).astype(f32)

    u = np.minimum(np.abs(x) * f32(GELU_U_SCALE), f32(GELU_UMAX))
    q = ((u - f32(GELU_K)) * off(f32(1) / (u + f32(GELU_K)), rcp_ulps))
    p = np.full_like(x, f32(GELU_P[0]))
    for c in GELU_P[1:]:
        p = (p.astype(f64) * q.astype(f64) + f64(f32(c))).astype(f32)
    e = off(np.exp2(-(u * u).astype(f32).astype(f64)).astype(f32), ex2_ulps)
    h = e * p
    return x * np.where(x >= 0, f32(1) - h, h)


def test_gelu_kernel_formula_matches_the_source():
    """The copy above is the kernel's formula: the same constants, in the
    same order, in csrc/fused_bias_act.cu."""
    import re

    src = (_build.CSRC / "fused_bias_act.cu").read_text()
    body = src[src.index("float gelu_exact(float x)"):]
    body = body[:body.index("\n}\n")]
    consts = [float(c) for c in re.findall(r"-?\d\.\d+e[+-]\d+", body)]
    assert consts == [GELU_U_SCALE, GELU_UMAX, *GELU_P]
    assert "(u - 3.0f) * rcp_approx(u + 3.0f)" in body


def test_gelu_kernel_formula_within_ulp_bound():
    """Over every bf16 value in [-12, 12] and a dense fp32 grid, the
    formula stays within the stated bounds of jax.nn.gelu (exact form)
    in fp32 ulps of the result.  Below |x| = 2^-100 the result is x/2
    near or under the smallest normal, where XLA on the CPU flushes to
    zero: held there to x/2 within an ulp."""
    bits = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    bf16 = bits[np.isfinite(bits) & (np.abs(bits) <= 12)]
    tiny = bf16[np.abs(bf16) < 2.0 ** -100]
    np.testing.assert_allclose(_gelu_kernel_f32(tiny), tiny * np.float32(.5),
                               rtol=2 ** -22, atol=0)
    bf16 = bf16[np.abs(bf16) >= 2.0 ** -100]
    x = np.concatenate([bf16, np.linspace(-12, 12, 600_001,
                                          dtype=np.float32)])
    got = _gelu_kernel_f32(x).astype(np.float64)
    x64 = x.astype(np.float64)
    wants = {"jax": np.asarray(jax.nn.gelu(x, approximate=False)).astype(
                 np.float64),
             "exact": 0.5 * x64 * erfc(-x64 / np.sqrt(2.0))}
    tail = x < -4
    for name, want in wants.items():
        ulp = np.spacing(np.maximum(np.abs(want), 2.0 ** -126).astype(
            np.float32)).astype(np.float64)
        # the card's approximate reciprocal and 2^y: 2 ulp off either way
        for rcp, ex2 in ((0, 0), (2, 2), (-2, -2), (2, -2), (-2, 2)):
            y = _gelu_kernel_f32(x, rcp, ex2).astype(np.float64)
            err = np.abs(y - want) / ulp
            bound = GELU_ULP_BOUND[name]
            assert err[~tail].max() <= bound["x >= -4"], (name, rcp, ex2)
            assert err[tail].max() <= bound["x < -4"], (name, rcp, ex2)
    assert np.array_equal(got[x >= 6], x64[x >= 6])  # Φ rounds to 1
    assert np.all(got[x == 0] == 0)


class _FakeK4:
    def __init__(self):
        self.calls = []

    def pt_fused_bias_gelu(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("x_dtype,b_dtype,codes", [
    (torch.bfloat16, torch.bfloat16, (1, 1)),
    (torch.bfloat16, torch.float32, (1, 0)),
    (torch.float32, torch.float32, (0, 0)),
    (torch.float16, torch.float32, (2, 0)),
    (torch.float16, torch.float16, (2, 2))])
def test_bias_gelu_wrapper_hands_kernel_its_arguments(monkeypatch, x_dtype,
                                                      b_dtype, codes):
    """The kernel branch with the build stubbed: the dtype codes, x, bias,
    the mask (or null), a fresh output of x's shape and dtype, R and H of
    the flattened [R, H] view, the scale and the GeLU form; one launch
    counted."""
    lib = _FakeK4()
    monkeypatch.setattr(tfba, "_use_kernel", lambda *a: True)
    monkeypatch.setattr(_build, "load", lambda *a: lib)
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    monkeypatch.setattr(_build, "stream_of",
                        lambda dev: ctypes.c_void_p(1234))
    x = torch.zeros(2, 3, 37, dtype=x_dtype)
    bias = torch.zeros(37, dtype=b_dtype)
    mask = torch.ones(2, 3, 37, dtype=torch.uint8)
    before = tfba.fused_bias_gelu.launches
    out = tfba.fused_bias_gelu(x, bias)
    out_m = tfba.fused_bias_gelu(x, bias, mask=mask, scale=1.25,
                                 approximate=True)
    assert tfba.fused_bias_gelu.launches == before + 2
    for (args, o, m, sc, ap) in ((lib.calls[0], out, None, 1.0, 0),
                                 (lib.calls[1], out_m, mask, 1.25, 1)):
        assert args[:2] == codes
        assert args[2] is x and args[3] is bias and args[4] is m
        assert args[5] is o and o.shape == x.shape and o.dtype == x_dtype
        assert args[6:10] == (6, 37, sc, ap)
    with pytest.raises(ValueError, match="contiguous"):
        tfba.fused_bias_gelu(x.transpose(0, 1), bias)
