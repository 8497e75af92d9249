"""bf16 K3 (``flash_bwd_dkv``) at the NMT encoder's shape over many
seeds, against its plain version and against the exact answer.

The case is ``chip_smoke.NMT_FLASH_CASES``' ``nmt_enc_s256``: [32, 16,
256, 64] bf16 q, k, v, dO, each sentence's keys past a length uniform in
[1, 256] at -1e9 as bf16 holds it.  Seed ``i`` draws every input from a
``torch.Generator`` of its own (``chip_smoke.k3_seed_inputs``).  For
each seed the script reads, for dK and dV:

- the kernel against the plain bf16 version (the gate phase 3 applies,
  ``FLASH_TOL`` 2e-2);
- the kernel and the plain bf16 version against the exact answer: the
  plain version's fp32 arithmetic on the same bf16 inputs, not rounded
  (``flash.flash_bwd_dkv_truth``);
- each error over the rounding bound of the kernel's arithmetic
  (``flash.flash_bwd_dkv_bf16_bound``): a ratio at most 1 is within it;
- the worst element of the kernel against the plain version: its row
  (batch, head), key, column, the sentence's length, whether the key is
  a pad key, the last real key or the first pad key, and the three
  values there.

Usage, on a machine with the card::

    python3 tools/torch_k3_seeds.py [--seeds 64] [--out PATH]

Prints one JSON line a seed (``SEED ...``), a summary line
(``SUMMARY ...``), then the card's name and power limit.  Exits 1 when
the kernel leaves the rounding bound on any seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, default=64)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k3_seeds: no card", file=sys.stderr)
        return 2
    import chip_smoke
    from paddle_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all(["flash_attention"])
    dev = torch.device("cuda", 0)
    rows, worst_ratio = [], 0.0
    for seed in range(args.seeds):
        r = chip_smoke.k3_seed_reading(dev, seed)
        rows.append(r)
        worst_ratio = max(worst_ratio, r["kernel_over_bound"])
        print("SEED " + json.dumps(r), flush=True)
    summary = {
        "seeds": args.seeds,
        "old_gate_failures": sum(not r["within_flash_tol"] for r in rows),
        "kernel_over_bound_max": worst_ratio,
        "plain_over_bound_max": max(r["plain_over_bound"] for r in rows),
        "kernel_vs_truth_max": max(max(r["dk"]["kernel_vs_truth"],
                                       r["dv"]["kernel_vs_truth"])
                                   for r in rows),
        "plain_vs_truth_max": max(max(r["dk"]["plain_vs_truth"],
                                      r["dv"]["plain_vs_truth"])
                                  for r in rows),
        "kernel_vs_plain_max": max(max(r["dk"]["kernel_vs_plain"],
                                       r["dv"]["kernel_vs_plain"])
                                   for r in rows),
        "card": chip_smoke._smi()}
    print("SUMMARY " + json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"seeds": rows, "summary": summary}, f)
    print(summary["card"])
    return 0 if worst_ratio <= 1.0 else 1


if __name__ == "__main__":
    sys.exit(main())
