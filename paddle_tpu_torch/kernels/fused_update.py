"""K8: the fused dequant → optimizer update → requant step.

Counterpart of ``paddle_tpu/kernels/fused_update.py``, whose Pallas
kernel (the body in ``_pallas_fused`` :305, launched by ``_pallas_call``
:272) this replaces with the hand-written CUDA kernel
``csrc/fused_update.cu``.  On the data-parallel lane
``c_allreduce_quant_keep`` keeps each reduced gradient bucket in its
wire format (int8 hi, int8 lo, one fp32 scale a block), and each
parameter's optimizer op becomes ``fused_<kind>_quant_grad``
(ops/optimizer_ops.py), which calls the entries here with the gradient
as a bucket slice ``(hi, lo, scales, offset_blocks, numel)``.  The
kernel reads that slice of the kept image in place, dequantizes
g = hi·s + lo·s/254 in registers, applies the update, and writes the
parameter and its moments back in place: the reduced fp32 gradient
never exists in device memory.  Kinds: sgd, momentum (heavy-ball or
Nesterov), adam, adamw.  With ``requant_pad`` the updated parameter is
written as dual int8 with a per-block scale instead (the requant leg,
which the ZeRO-1 lane of the JAX package uses; not on the data-parallel
path).

Each entry updates ``p`` and the moments in place and advances the beta
powers in place after the launch (the kernel reads lr and the powers
from device memory and computes the bias-corrected step itself, so no
host sync), and returns what the JAX function returns.

Dispatch: the wire-format gradient on a CUDA tensor launches K8; on a
CPU tensor (or a ``meta`` one) the plain version runs: the functions
``adam_math`` … ``quantize_for_gather`` below, term for term the JAX
package's.  An fp32 gradient always takes the plain version, as it
takes the XLA path in the JAX package.  ``force="reference"`` selects
the plain version explicitly; nothing on the training path sets it.
``fused_update_kernel.launches`` counts launches.

:func:`fused_update_group` is the form the data-parallel step runs
(the executor groups a run of fused optimizer ops, fluid/executor.py):
one launch updates every member of a table of up to
``pt_fused_update_group_capacity()`` parameters, so a step pays a few
launches where it paid one a parameter.  On the TPU the JAX package's
Pallas calls all ran inside one XLA executable; here each launch costs
a few microseconds, which is the whole update of a bias.
``fused_update_group.launches`` counts its launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from .quantized_collectives import (DEFAULT_BLOCK_SIZE,
                                    dequantize_block_scaled,
                                    quantize_block_scaled)

__all__ = [
    "bytes_saved", "dequant_slice", "adam_math", "adamw_math", "sgd_math",
    "momentum_math", "quantize_for_gather", "fused_adam_update",
    "fused_adamw_update", "fused_sgd_update", "fused_momentum_update",
    "fused_update_kernel", "fused_update_group", "launch_group",
    "GroupMember",
    "MAX_BLOCK_SIZE",
]

MAX_BLOCK_SIZE = 1024  # one CTA a block in the requant form
_KIND = {"sgd": 0, "momentum": 1, "adam": 2, "adamw": 3}

# (kind, requant, numel, block_size, offset_blocks, p, m1, m2, hi, lo,
#  scales, lr, b1p, b2p, c0..c5, q_hi, q_lo, q_sc, stream)
_SIGNATURES = {
    "pt_fused_update": [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                        ctypes.c_int, ctypes.c_longlong] +
                       [ctypes.c_void_p] * 9 +
                       [ctypes.c_float] * 6 +
                       [ctypes.c_void_p] * 4,
    "pt_fused_update_group_capacity": [],
    # (kind, dual, block_size, n, rows, c0..c5, stream)
    "pt_fused_update_group": [ctypes.c_int] * 4 + [ctypes.c_void_p] +
                             [ctypes.c_float] * 6 + [ctypes.c_void_p],
}


def bytes_saved(n_elements):
    """Modeled device bytes one fused update avoids a step: the unfused
    chain writes the fp32 reduced gradient and reads it back."""
    return 8 * int(n_elements)


def dequant_slice(q_hi, q_lo, scales, offset_blocks, numel, block_size,
                  shape=None):
    """Dequantize one block-aligned member of a kept bucket: blocks
    ``[offset_blocks, offset_blocks + ceil(numel/block))``, trimmed to
    ``numel`` and reshaped."""
    bs = int(block_size)
    off = int(offset_blocks) * bs
    nb = -(-int(numel) // bs)
    hi = q_hi[off:off + nb * bs]
    lo = q_lo[off:off + nb * bs] if q_lo is not None else None
    sc = scales[int(offset_blocks):int(offset_blocks) + nb]
    g = dequantize_block_scaled(hi, lo, sc, bs)[:int(numel)]
    return g.reshape(shape) if shape is not None else g


def _scalar(t):
    return t.reshape(()).float()


def adam_math(p, g32, m1, m2, lr, b1p, b2p, beta1, beta2, epsilon):
    """The Adam update in fp32, term for term the JAX package's
    ``adam_math`` (and its ``_adam`` op).  Returns ``(p_new32, m1n, m2n,
    b1pn, b2pn)``."""
    g32 = g32.float()
    p32 = p.float()
    m1n = beta1 * m1.float() + (1 - beta1) * g32
    m2n = beta2 * m2.float() + (1 - beta2) * torch.square(g32)
    b1pf, b2pf = _scalar(b1p), _scalar(b2p)
    lr_t = _scalar(lr) * torch.sqrt(1 - b2pf) / (1 - b1pf)
    p_new = p32 - lr_t * m1n / (torch.sqrt(m2n) + epsilon)
    return (p_new, m1n.to(m1.dtype), m2n.to(m2.dtype),
            (b1pf * beta1).reshape(b1p.shape).to(b1p.dtype),
            (b2pf * beta2).reshape(b2p.shape).to(b2p.dtype))


def adamw_math(p, g32, m1, m2, lr, b1p, b2p, beta1, beta2, epsilon, coeff):
    """Adam plus the decoupled decay ``p -= lr_raw · coeff · p`` on the
    parameter before the update, with the raw learning rate."""
    outs = adam_math(p, g32, m1, m2, lr, b1p, b2p, beta1, beta2, epsilon)
    p_new = outs[0] - _scalar(lr) * coeff * p.float()
    return (p_new,) + outs[1:]


def sgd_math(p, g32, lr):
    """The SGD update in fp32."""
    return p.float() - _scalar(lr) * g32.float()


def momentum_math(p, g32, v, lr, mu, use_nesterov=False):
    """The momentum update in fp32, heavy-ball or Nesterov.  Returns
    ``(p_new32, v_new)``."""
    g32 = g32.float()
    p32 = p.float()
    lr_ = _scalar(lr)
    v_new = mu * v.float() + g32
    if use_nesterov:
        p_new = p32 - (g32 + mu * v_new) * lr_
    else:
        p_new = p32 - lr_ * v_new
    return p_new, v_new.to(v.dtype)


def quantize_for_gather(p_new32, block_size, dual_int8=True,
                        pad_multiple=None):
    """The updated parameter as a dual-int8 payload: flat, zero-padded
    to ``pad_multiple`` (default one block), block-scaled."""
    bs = int(block_size)
    mult = int(pad_multiple) if pad_multiple else bs
    flat = p_new32.reshape(-1).float()
    pad = (-flat.numel()) % mult
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return quantize_block_scaled(flat, bs, dual_int8=dual_int8)


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _check_kernel_args(p, grad, moments, block_size):
    q_hi, q_lo, scales, offset_blocks, numel = grad
    bs = int(block_size)
    if not 1 <= bs <= MAX_BLOCK_SIZE:
        raise ValueError(f"fused_update: block_size {bs} outside "
                         f"[1, {MAX_BLOCK_SIZE}]")
    if p.numel() != int(numel):
        raise ValueError(f"fused_update: numel {numel} != the parameter's "
                         f"{p.numel()}")
    nb = -(-int(numel) // bs)
    if (int(offset_blocks) + nb) * bs > q_hi.numel() \
            or int(offset_blocks) + nb > scales.numel():
        raise ValueError("fused_update: the member's blocks run past the "
                         "bucket's wire image")
    for name, t in [("Param", p)] + moments:
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.numel() != p.numel():
            raise ValueError(f"fused_update: {name} must be contiguous "
                             f"float32 of the parameter's size")
    for name, t, dt in (("QHi", q_hi, torch.int8), ("QLo", q_lo, torch.int8),
                        ("QScale", scales, torch.float32)):
        if t is not None and (t.dtype != dt or not t.is_contiguous()):
            raise ValueError(f"fused_update: {name} must be contiguous {dt}")
    for t in [q_hi, q_lo, scales] + [m for _, m in moments]:
        if t is not None and t.device != p.device:
            raise ValueError(f"fused_update: tensors on {p.device} and "
                             f"{t.device}")


def _consts(kind, beta1=0.9, beta2=0.999, epsilon=1e-8, coeff=0.0, mu=0.9,
            use_nesterov=False):
    """The kernel's six constants of ``kind``: adam and adamw (beta1,
    1 - beta1, beta2, 1 - beta2, epsilon, coeff; adam's coeff 0),
    momentum (mu, use_nesterov), sgd none; zero-padded."""
    if kind == "momentum":
        c = (mu, 1.0 if use_nesterov else 0.0)
    elif kind in ("adam", "adamw"):
        c = (beta1, 1 - beta1, beta2, 1 - beta2, epsilon,
             coeff if kind == "adamw" else 0.0)
    else:
        c = ()
    return [float(x) for x in c] + [0.0] * (6 - len(c))


def fused_update_kernel(kind, p, grad, m1, m2, lr, b1p, b2p, consts,
                        block_size, requant=False):
    """Launch K8 once on CUDA tensors.  ``grad`` is the bucket slice
    ``(hi, lo, scales, offset_blocks, numel)``; ``consts`` the kind's
    six constants (:func:`_consts`).  Updates p (unless
    ``requant``), m1 and m2 in place; with ``requant`` returns the
    updated parameter's ``(hi, lo, scales)`` over ceil(numel/block)
    blocks, else None.  The beta powers are read, not advanced."""
    moments = [(n, t) for n, t in (("Moment1", m1), ("Moment2", m2))
               if t is not None]
    _check_kernel_args(p, grad, moments, block_size)
    q_hi, q_lo, scales, offset_blocks, numel = grad
    bs = int(block_size)
    nb = -(-int(numel) // bs)
    out = (None, None, None)
    if requant:
        out = (torch.empty(nb * bs, dtype=torch.int8, device=p.device),
               torch.empty(nb * bs, dtype=torch.int8, device=p.device),
               torch.empty(nb, dtype=torch.float32, device=p.device))
    lib = _build.load("fused_update", _SIGNATURES)

    def ptr(t):
        return _build.ptr(t) if t is not None else None

    err = lib.pt_fused_update(
        _KIND[kind], int(bool(requant)), int(numel), bs, int(offset_blocks),
        ptr(p), ptr(m1), ptr(m2), ptr(q_hi), ptr(q_lo), ptr(scales),
        ptr(lr), ptr(b1p), ptr(b2p), *consts,
        ptr(out[0]), ptr(out[1]), ptr(out[2]), _build.stream_of(p.device))
    fused_update_kernel.launches += 1
    _build.check("fused_update", err)
    return out if requant else None


fused_update_kernel.launches = 0


def _use_kernel(p, grad, force):
    if force not in (None, "reference"):
        raise ValueError(f"fused_update: force={force!r} (use None or "
                         f"'reference')")
    if force == "reference" or not isinstance(grad, tuple) \
            or p.device.type in ("cpu", "meta"):
        return False
    if p.device.type != "cuda":
        raise RuntimeError(f"fused_update: no kernel for {p.device}")
    return True


def _grad_value(grad, block_size, shape):
    if isinstance(grad, tuple):
        q_hi, q_lo, scales, offset_blocks, numel = grad
        return dequant_slice(q_hi, q_lo, scales, offset_blocks, numel,
                             block_size, shape)
    return grad


def _requant_out(p, q, block_size, requant_pad):
    """From the kernel's payload over ceil(numel/block) blocks: the
    dequantized image as the new parameter (written into p), and the
    payload zero-padded to ``requant_pad`` as the plain version pads it
    (zero blocks: codes 0, scale 1e-30)."""
    hi, lo, sc = q
    bs = int(block_size)
    n = p.numel()
    p.copy_(dequantize_block_scaled(hi, lo, sc, bs)[:n].reshape(p.shape))
    target = n + (-n) % int(requant_pad)
    extra = target // bs - sc.numel()
    if extra > 0:
        hi = torch.nn.functional.pad(hi, (0, extra * bs))
        lo = torch.nn.functional.pad(lo, (0, extra * bs))
        sc = torch.nn.functional.pad(sc, (0, extra), value=1e-30)
    return hi, lo, sc


def _finish_plain(p, p_new32, moments, block_size, requant_pad):
    """Write the plain version's results in place; the requant payload
    (if asked for) from the exact fp32 update."""
    q = None
    if requant_pad is not None:
        q = quantize_for_gather(p_new32, block_size,
                                pad_multiple=requant_pad)
    p.copy_(p_new32.reshape(p.shape))
    for dst, src in moments:
        dst.copy_(src)
    return q


def _adam_like(kind, p, grad, m1, m2, lr, b1p, b2p, beta1, beta2, epsilon,
               coeff, block_size, requant_pad, force):
    bs = int(block_size)
    if _use_kernel(p, grad, force):
        q = fused_update_kernel(
            kind, p, grad, m1, m2, lr, b1p, b2p,
            _consts(kind, beta1, beta2, epsilon, coeff), bs,
            requant=requant_pad is not None)
        # after the launch: the kernel reads the powers on the stream
        b1p.mul_(beta1)
        b2p.mul_(beta2)
        if q is not None:
            q = _requant_out(p, q, bs, requant_pad)
    else:
        g = _grad_value(grad, bs, p.shape)
        if kind == "adamw":
            outs = adamw_math(p, g, m1, m2, lr, b1p, b2p, beta1, beta2,
                              epsilon, coeff)
        else:
            outs = adam_math(p, g, m1, m2, lr, b1p, b2p, beta1, beta2,
                             epsilon)
        q = _finish_plain(p, outs[0], [(m1, outs[1]), (m2, outs[2]),
                                       (b1p, outs[3]), (b2p, outs[4])],
                          bs, requant_pad)
    res = (p, m1, m2, b1p, b2p)
    return res + tuple(q) if q is not None else res


def fused_adam_update(p, grad, m1, m2, lr, b1p, b2p, *, beta1=0.9,
                      beta2=0.999, epsilon=1e-8,
                      block_size=DEFAULT_BLOCK_SIZE, requant_pad=None,
                      force=None):
    """The fused Adam step.  ``grad`` is an fp32 tensor shaped like
    ``p`` or a bucket slice ``(hi, lo, scales, offset_blocks, numel)``.
    Returns ``(p, m1, m2, b1p, b2p)`` updated in place, plus the
    updated parameter's ``(hi, lo, scales)`` padded to ``requant_pad``
    when that is given (then ``p`` holds the payload's dequantized
    image on the kernel's path, the exact update on the plain one)."""
    return _adam_like("adam", p, grad, m1, m2, lr, b1p, b2p, beta1, beta2,
                      epsilon, 0.0, block_size, requant_pad, force)


def fused_adamw_update(p, grad, m1, m2, lr, b1p, b2p, *, beta1=0.9,
                       beta2=0.999, epsilon=1e-8, coeff=0.01,
                       block_size=DEFAULT_BLOCK_SIZE, requant_pad=None,
                       force=None):
    """The fused AdamW step: :func:`fused_adam_update` plus the decoupled
    decay."""
    return _adam_like("adamw", p, grad, m1, m2, lr, b1p, b2p, beta1, beta2,
                      epsilon, float(coeff), block_size, requant_pad, force)


def fused_sgd_update(p, grad, lr, *, block_size=DEFAULT_BLOCK_SIZE,
                     requant_pad=None, force=None):
    """The fused SGD step: returns ``p`` updated in place (plus the
    payload with ``requant_pad``)."""
    bs = int(block_size)
    if _use_kernel(p, grad, force):
        q = fused_update_kernel("sgd", p, grad, None, None, lr, None, None,
                                _consts("sgd"), bs,
                                requant=requant_pad is not None)
        if q is not None:
            q = _requant_out(p, q, bs, requant_pad)
    else:
        q = _finish_plain(p, sgd_math(p, _grad_value(grad, bs, p.shape), lr),
                          [], bs, requant_pad)
    return (p,) + tuple(q) if q is not None else p


def fused_momentum_update(p, grad, v, lr, *, mu=0.9, use_nesterov=False,
                          block_size=DEFAULT_BLOCK_SIZE, requant_pad=None,
                          force=None):
    """The fused momentum step (heavy-ball, or Nesterov): returns
    ``(p, v)`` updated in place (plus the payload with
    ``requant_pad``)."""
    bs = int(block_size)
    if _use_kernel(p, grad, force):
        q = fused_update_kernel("momentum", p, grad, v, None, lr, None, None,
                                _consts("momentum", mu=mu,
                                        use_nesterov=use_nesterov), bs,
                                requant=requant_pad is not None)
        if q is not None:
            q = _requant_out(p, q, bs, requant_pad)
    else:
        p_new, v_new = momentum_math(p, _grad_value(grad, bs, p.shape), v,
                                     lr, mu, use_nesterov)
        q = _finish_plain(p, p_new, [(v, v_new)], bs, requant_pad)
    return (p, v) + tuple(q) if q is not None else (p, v)


# ---------------------------------------------------------------------------
# the group form: one launch over many parameters
# ---------------------------------------------------------------------------


class GroupMember(NamedTuple):
    """One parameter of a group update: the tensors its fused op reads
    and updates.  ``grad`` is the bucket slice ``(hi, lo, scales,
    offset_blocks, numel)``; ``m1`` is momentum's velocity; the kinds
    without moments or beta powers leave them None."""

    p: torch.Tensor
    grad: tuple
    lr: torch.Tensor
    m1: torch.Tensor = None
    m2: torch.Tensor = None
    b1p: torch.Tensor = None
    b2p: torch.Tensor = None


def _member_plain(kind, m, hyper, bs, force):
    """One member through its per-parameter entry."""
    kw = dict(block_size=bs, force=force)
    if kind == "sgd":
        fused_sgd_update(m.p, m.grad, m.lr, **kw)
    elif kind == "momentum":
        fused_momentum_update(m.p, m.grad, m.m1, m.lr, mu=hyper["mu"],
                              use_nesterov=hyper["use_nesterov"], **kw)
    else:
        fn = fused_adam_update if kind == "adam" else fused_adamw_update
        extra = {"coeff": hyper["coeff"]} if kind == "adamw" else {}
        fn(m.p, m.grad, m.m1, m.m2, m.lr, m.b1p, m.b2p,
           beta1=hyper["beta1"], beta2=hyper["beta2"],
           epsilon=hyper["epsilon"], **extra, **kw)


def _group_rows(kind, members, bs):
    """The launch table's rows (int64: the nine pointers, 0 for none,
    then offset_blocks and numel), each member checked as the
    per-parameter entry checks it."""
    rows = []
    dual = members[0].grad[1] is not None
    for m in members:
        q_hi, q_lo, scales, offset_blocks, numel = m.grad
        moments = [(n, t) for n, t in (("Moment1", m.m1), ("Moment2", m.m2))
                   if t is not None]
        _check_kernel_args(m.p, m.grad, moments, bs)
        if (q_lo is not None) != dual:
            raise ValueError("fused_update_group: members mix a dual-int8 "
                             "and a single-int8 wire")
        state = (m.lr, m.b1p, m.b2p)
        for t in state:
            if t is not None and (t.dtype != torch.float32
                                  or t.device != m.p.device):
                raise ValueError("fused_update_group: LearningRate and the "
                                 "beta powers must be float32 on the "
                                 "parameter's device")
        rows.append([0 if t is None else t.data_ptr() for t in (
            m.p, m.m1, m.m2, q_hi, q_lo, scales) + state]
            + [int(offset_blocks), int(numel)])
    return np.asarray(rows, dtype=np.int64), dual


def fused_update_group(kind, members, hyper, block_size, force=None):
    """The fp32 update of every member (a :class:`GroupMember`) of one
    ``kind`` in place, as its per-parameter entry would: on CUDA tensors
    one launch per device per table-full of members, the beta powers
    then advanced by one ``torch._foreach_mul_`` a list; on CPU tensors
    (or with ``force="reference"``) the plain version member by member.
    ``hyper``: adam and adamw ``beta1``, ``beta2``, ``epsilon`` (adamw
    also ``coeff``); momentum ``mu``, ``use_nesterov``; sgd none."""
    if kind not in _KIND:
        raise ValueError(f"fused_update_group: kind {kind!r}")
    bs = int(block_size)
    by_device = {}
    for m in members:
        if not isinstance(m.grad, tuple):
            raise ValueError("fused_update_group: a member's gradient must "
                             "be a bucket slice (hi, lo, scales, "
                             "offset_blocks, numel)")
        by_device.setdefault(m.p.device, []).append(m)
    for device, group in by_device.items():
        if not _use_kernel(group[0].p, group[0].grad, force):
            for m in group:
                _member_plain(kind, m, hyper, bs, force)
            continue
        with torch.cuda.device(device):
            launch_group(kind, group, hyper, bs)
            if kind in ("adam", "adamw"):
                # after the launches: the kernels read the powers on the
                # stream
                torch._foreach_mul_([m.b1p for m in group], hyper["beta1"])
                torch._foreach_mul_([m.b2p for m in group], hyper["beta2"])


def launch_group(kind, group, hyper, block_size):
    """The group kernel over ``group`` (members on the current CUDA
    device), one launch a table-full of members; the beta powers are
    read, not advanced."""
    bs = int(block_size)
    rows, dual = _group_rows(kind, group, bs)
    lib = _build.load("fused_update", _SIGNATURES)
    cap = lib.pt_fused_update_group_capacity()
    consts = _consts(kind, **hyper)
    stream = _build.stream_of(group[0].p.device)
    for i in range(0, len(rows), cap):
        table = np.ascontiguousarray(rows[i:i + cap])
        err = lib.pt_fused_update_group(
            _KIND[kind], int(dual), bs, len(table),
            table.ctypes.data_as(ctypes.c_void_p), *consts, stream)
        fused_update_group.launches += 1
        _build.check("fused_update_group", err)


fused_update_group.launches = 0
