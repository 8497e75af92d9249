"""int8_weight_storage — store inference matmul weights dual-int8 at
rest (counterpart of ``paddle_tpu/passes/int8_weights.py``;
kernels/primitives/int8.py).

A served model pins its fp32 weight matrices in device memory whole.
This pass rewrites each eligible weight ``W`` to the dual-int8 layout —
``W__qhi``/``W__qlo`` (int8, same shape) plus a per-row fp32
``W__scale`` — and prepends ONE ``dequantize_weight_storage`` op that
rebuilds fp32 ``W`` on the device:

    W = (W__qhi + W__qlo / 254) * W__scale        # ~14.6 significant bits

2x smaller at rest, and (unlike plain int8) enough mantissa that greedy
decode stays token-stable.  The saving is at rest only: each program
run rebuilds every claimed weight in fp32 for its matmuls.

Eligibility is deliberately narrow — a weight is rewritten only when it
is persistable fp32, statically 2-D, produced by no op, and EVERY
consumer (across all blocks) is a forward ``mul``/``matmul`` reading it
through the ``Y`` slot.  Anything else — bias vectors, embeddings
(lookup tables read by ``embedding``), norm scales, anything a backward
op touches — keeps full precision.  Inference-only by construction: a
single backward consumer vetoes the weight.

The pass rewrites the PROGRAM; the matching scope-side conversion is
:func:`quantize_scope_weights`, which callers run once after the pass
(weights must already be loaded).  Opt-in: registered in ``PASS_ORDER``
but not ``DEFAULT_PASSES`` — engaged via
``PassManager(["int8_weight_storage"])`` or ``DecodeEngine(...,
int8_weights=True)``.
"""

from __future__ import annotations

from paddle_tpu_torch.fluid.framework import Operator

from .framework import (ProgramPass, consumer_map, is_backward,
                        register_program_pass)

# storage-var suffixes (shared with kernels/primitives/int8.py naming)
SUFFIX_HI, SUFFIX_LO, SUFFIX_SCALE = "__qhi", "__qlo", "__scale"
_SUFFIXES = (SUFFIX_HI, SUFFIX_LO, SUFFIX_SCALE)

_CONSUMER_TYPES = frozenset(("mul", "matmul"))


def storage_var_names(name):
    """The dual-int8 storage triple for weight ``name``."""
    return name + SUFFIX_HI, name + SUFFIX_LO, name + SUFFIX_SCALE


def _eligible_weights(program, ctx):
    """Names of weights the rewrite may claim, in deterministic order."""
    block = program.global_block()
    cons = consumer_map(program)
    produced = set()
    for b in program.blocks:
        for op in b.ops:
            produced.update(op.output_arg_names)
    keep = set(getattr(ctx, "keep_vars", ()) or ())
    out = []
    for name in sorted(block.vars):
        var = block.vars[name]
        if (not var.persistable or name in keep or name in produced
                or name.endswith(_SUFFIXES)):
            continue
        if str(var.dtype) != "float32":
            continue
        shape = var.shape
        if (shape is None or len(shape) != 2
                or any(d is None or d < 0 for d in shape)):
            continue
        users = cons.get(name, [])
        if not users:
            continue
        if all((not is_backward(op)) and op.type in _CONSUMER_TYPES
               and op.input("Y") == [name] and name not in op.input("X")
               for op in users):
            out.append(name)
    return out


@register_program_pass
class Int8WeightStoragePass(ProgramPass):
    """Rewrite eligible fp32 matmul weights to dual-int8 at-rest storage
    plus an on-chip ``dequantize_weight_storage`` reconstruction op."""

    name = "int8_weight_storage"

    def apply(self, program, ctx):
        block = program.global_block()
        targets = _eligible_weights(program, ctx)
        modeled = 0
        new_ops = []
        for name in targets:
            var = block.vars[name]
            r, c = (int(d) for d in var.shape)
            hi_n, lo_n, sc_n = storage_var_names(name)
            hi = block.create_var(name=hi_n, shape=[r, c], dtype="int8",
                                  persistable=True)
            lo = block.create_var(name=lo_n, shape=[r, c], dtype="int8",
                                  persistable=True)
            sc = block.create_var(name=sc_n, shape=[r, 1],
                                  dtype="float32", persistable=True)
            # the weight becomes an in-graph intermediate: the dequant op
            # is now its producer, the int8 triple is what persists
            var.persistable = False
            deq = Operator(block, "dequantize_weight_storage",
                           inputs={"Hi": [hi.name], "Lo": [lo.name],
                                   "Scale": [sc.name]},
                           outputs={"Out": [name]})
            var.op = deq
            new_ops.append(deq)
            # fp32 4rc  ->  2rc int8 + 4r per-row scales
            modeled += 4 * r * c - (2 * r * c + 4 * r)
        if new_ops:
            block.ops = new_ops + block.ops
            program._bump_version()
        return {"changed": bool(new_ops), "sites": len(new_ops),
                "modeled_bytes_saved": int(modeled)}


def quantize_scope_weights(scope, program, book=True):
    """Scope-side half of the rewrite: quantize each claimed weight into
    its dual-int8 triple and DROP the fp32 array from the scope.

    Run once after :class:`Int8WeightStoragePass` on a scope that already
    holds the model parameters.  Idempotent — weights whose triple is
    already installed are skipped (the fp32 copy, if any survives, is
    still dropped).  Books the realized saving on
    ``pt_int8_bytes_saved_total{kind="weights"}`` unless ``book=False``.
    """
    from paddle_tpu_torch.kernels.primitives import int8 as prims

    converted, saved = 0, 0
    for op in program.global_block().ops:
        if op.type != "dequantize_weight_storage":
            continue
        name = op.output("Out")[0]
        hi_n, lo_n, sc_n = op.input("Hi")[0], op.input("Lo")[0], \
            op.input("Scale")[0]
        if scope.get(hi_n) is None:
            w = scope.get(name)
            if w is None:
                raise KeyError(
                    f"int8_weight_storage: weight '{name}' is claimed by "
                    f"the program rewrite but absent from the scope — run "
                    f"quantize_scope_weights after parameters are loaded")
            hi, lo, sc = prims.quantize_lastdim(w.float())
            scope.set(hi_n, hi)
            scope.set(lo_n, lo)
            scope.set(sc_n, sc)
            converted += 1
            saved += prims.bytes_saved(w.numel(), w.shape[-1])
        scope._vars.pop(name, None)
    if book and saved:
        prims.book_bytes_saved("weights", saved)
    return {"weights": converted, "bytes_saved": int(saved)}
