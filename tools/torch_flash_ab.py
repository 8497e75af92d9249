"""Flash attention kernels of several kernel sources, on one card, in
turns: the fp32 K1, the fp32 K1-K3 at their timed shapes, and the bf16
K1-K3 at their paths' head dim 64.

Each arm is a ``csrc`` directory of the port (``paddle_tpu_torch/csrc``
of a checkout).  Its ``flash_attention.cu`` is built into a library of
its own (the flags of ``kernels/_build.py``) and bound in place of the
tree's, so one process times every arm through the same wrapper,
``primitives.flash.flash_fwd``: this tree (``this``) and the arms named
on the command line.

Shapes: fp32 K1 at the predictor path's [96, 128, 64] (b8 s128, 12
heads, a key bias with pads, ``chip_smoke._flash_inputs``) and the same
at D 128; fp32 K1, K2 and K3 at ``chip_smoke.FLASH_CASES``' timed fp32
cases (the fp32 train step's [1536, 128, 64], GPT-2 small's causal
[96, 1024, 64], [96, 128, 128]); bf16 K1, K2 and K3 at its timed D 64
cases (the BERT path's [1536, 128, 64], a dp shard's [384, 128, 64],
GPT-2 small's causal [96, 1024, 64]).  Each shape runs the arms in
turns, A B C ... C B A, each reading ``chip_smoke._time_ms`` (30 calls),
with its max abs error against the plain version.  A named arm whose
entry point refuses a head dim above 64 (the parent's, whose kernels
took D <= 64) reads "refused" at D 128; any other error, and any error
of this tree's kernels, is raised.  For fp32, SDPA in fp32
with the same float mask and the restated bound
(``chip_smoke._flash_bounds``) stand beside them; the launch floor
beside all.

Usage (on a machine with the card; the parent commit's sources unpacked
into a directory git ignores)::

    git archive <parent> paddle_tpu_torch/csrc | tar -x -C <dir>
    python3 tools/torch_flash_ab.py \
        parent=<dir>/paddle_tpu_torch/csrc --out flash_ab.json

Prints one JSON line a shape (``AB ...``), then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FP32_SHAPES = ((8, 12, 128, 64), (8, 12, 128, 128))  # b, h, s, d
# of chip_smoke.FLASH_CASES
FP32_CASES = ("fp32_path", "fp32_gpt", "fp32_d128")
BF16_CASES = ("path", "dp_shard", "gpt")
ITERS = 30
# what the wrapper raises when an entry point returns
# cudaErrorInvalidValue, as bad_shape makes it do for a head dim it lacks
REFUSAL = "kernel launch failed with cudaError_t 1"


def _build_all(arms, work):
    """{label: bound library}: one nvcc an arm, all started together;
    each arm's split-TF32 kernels' registers and spills printed."""
    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels.primitives import flash

    procs = {}
    for label, src in arms:
        so = os.path.join(work, f"{label}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               so, os.path.join(src, "flash_attention.cu")]
        procs[label] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True), so)
    sigs = dict(flash._SIGNATURES, pt_device_launch_counts=(
        ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int))
    libs = {}
    for label, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"arm {label}: build failed\n{log[-3000:]}")
        tf32 = {fn: {k: p[k] for k in ("registers", "spill_bytes") if k in p}
                for fn, p in cs._ptxas_parse(log).items()
                if "flash_tf32" in fn}
        print(f"AB ptxas {label} {json.dumps(tf32)}", flush=True)
        lib = ctypes.CDLL(so)
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[label] = lib
    return libs


def _in_turns(labels, libs, kernels, refusable=()):
    """{label: {kernel: {"ms": [...], "max_abs_err": x}} or "refused"}:
    ``kernels`` maps a name to (call, plain result), each arm bound in
    turns, A B ... B A.  Only the arms in ``refusable`` may read
    "refused", and only for the entry point's refusal."""
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build

    out = {label: {name: {"ms": []} for name in kernels} for label in labels}
    for label in labels + labels[::-1]:
        if out[label] == "refused":
            continue
        _build._libs["flash_attention"] = libs[label]
        for name, (call, want) in kernels.items():
            try:
                got = call()
                torch.cuda.synchronize()
            except RuntimeError as e:
                if label not in refusable or not str(e).endswith(REFUSAL):
                    raise
                out[label] = "refused"
                break
            out[label][name]["max_abs_err"] = max(
                (g.float() - w.float()).abs().max().item()
                for g, w in zip(got, want))
            out[label][name]["ms"].append(cs._time_ms(call, ITERS))
    return out


def _fp32_k1(labels, libs, b, h, s, d, rng):
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from paddle_tpu_torch.kernels.primitives import flash

    dev = torch.device("cuda", 0)
    q, k, v, _, rows = cs._flash_inputs(dev, b, h, s, d, torch.float32, rng)
    scale = d ** -0.5
    o_ref, _ = flash.flash_fwd(q, k, v, rows, False, scale,
                               force="reference")
    # the named trees may predate D 128 (the parent's K1 took D <= 64)
    refusable = [label for label in labels if label != "this"] \
        if d > 64 else []
    out = _in_turns(labels, libs, {"flash_fwd": (
        lambda: flash.flash_fwd(q, k, v, rows, False, scale)[:1], (o_ref,))},
        refusable)
    mask = rows.reshape(b, h, 1, s)
    out["sdpa_fp32_ms"] = cs._time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale), ITERS)
    (out["bound_ms"], out["bound_by"]), _, _ = cs._flash_bounds(
        b * h, s, d, torch.float32, False)
    return out


def _k1_k3(labels, libs, case, rng):
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.kernels.primitives import flash

    (_, b, h, s, d, dtype, causal, bias_mode, _), = [
        c for c in cs.FLASH_CASES if c[0] == case]
    dev = torch.device("cuda", 0)
    q, k, v, do, rows = cs._flash_inputs(dev, b, h, s, d, dtype, rng,
                                         bias_mode)
    scale = d ** -0.5
    o_ref, lse_ref = flash.flash_fwd(q, k, v, rows, causal, scale,
                                     force="reference")
    delta = (do.float() * o_ref.float()).sum(-1).reshape(b * h, s)
    bargs = (q, k, v, rows, do, lse_ref.reshape(b * h, s), delta, causal,
             scale)
    return _in_turns(labels, libs, {
        "flash_fwd": (lambda: flash.flash_fwd(q, k, v, rows, causal,
                                              scale)[:1], (o_ref,)),
        "flash_bwd_dq": (lambda: (flash.flash_bwd_dq(*bargs),),
                         (flash.flash_bwd_dq(*bargs, force="reference"),)),
        "flash_bwd_dkv": (lambda: flash.flash_bwd_dkv(*bargs)[:2],
                          flash.flash_bwd_dkv(*bargs,
                                              force="reference")[:2])})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arms", nargs="*", help="LABEL=CSRC_DIR")
    ap.add_argument("--out", help="write every reading here as JSON")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    import chip_smoke as cs
    from paddle_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("torch_flash_ab: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    here = os.path.join(ROOT, "paddle_tpu_torch", "csrc")
    work = tempfile.mkdtemp(prefix="pt_flash_ab_", dir=ROOT)
    try:
        arms = [("this", here)] + [tuple(a.split("=", 1))
                                   for a in args.arms]
        libs = _build_all(arms, work)
        labels = [label for label, _ in arms]
        rng = np.random.RandomState(cs.SEED)
        result = {"card": cs._smi(), "launch_floor_ms": cs.launch_floor_ms(),
                  "arms": dict(arms), "fp32_k1": {}, "fp32_k1_k3": {},
                  "bf16_d64": {}}
        for b, h, s, d in FP32_SHAPES:
            name = f"[{b * h}, {s}, {d}]"
            result["fp32_k1"][name] = _fp32_k1(labels, libs, b, h, s, d, rng)
            print(f"AB fp32 K1 {name} {json.dumps(result['fp32_k1'][name])}",
                  flush=True)
        for case in FP32_CASES:
            result["fp32_k1_k3"][case] = _k1_k3(labels, libs, case, rng)
            print(f"AB fp32 {case} "
                  f"{json.dumps(result['fp32_k1_k3'][case])}", flush=True)
        for case in BF16_CASES:
            result["bf16_d64"][case] = _k1_k3(labels, libs, case, rng)
            print(f"AB bf16 {case} {json.dumps(result['bf16_d64'][case])}",
                  flush=True)
    finally:
        _build._libs.pop("flash_attention", None)
        shutil.rmtree(work, ignore_errors=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(result["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
