"""fuse_attention: pattern-match the unfused attention subgraph and
rewrite it to the ``flash_attention`` op.

The composed path our models emit when ``use_flash_attention=False``
(models/bert.py / gpt.py / transformer.py — the reference's own
dist_transformer composition):

    matmul(Q, K, transpose_Y=True, alpha=1/sqrt(d))      -> scores
    [elementwise_add(scores, bias[B,1,1,S])]             -> scores
    softmax | softmax_mask_fuse_upper_triangle           -> weights
    [dropout(is_test, upscale_in_train)]                 -> weights
    matmul(weights, V)                                   -> ctx

materializes the [B, heads, S, S] score tensor (twice, plus the softmax
output that backward re-reads).  The rewrite collapses the chain to ONE
``flash_attention`` op: the hand-written CUDA kernels K1 (forward) and
K2/K3 (backward) on the card, which never hold an S×S tensor in device
memory, their plain PyTorch versions on the CPU.  On training programs
the matching backward chain (grad ops located by their ``fwd_op_idx``
stamp) is replaced by the single ``flash_attention_grad`` desc, which
the registry derives from the forward lowering.  This is the JAX
package's pass (it rewrites the IR only), so both packages fuse the
same sites into the same ops.

Match contract (each condition regression-tested):

- Q/K/V are rank-4 with pairwise-equal static shape tuples AND a proven
  common sequence source: each walks up through its projection chain
  (transpose/reshape/bias-add back to the mul/fc) to the SAME input
  activation.  Static tuples alone are not enough — encoder-decoder
  CROSS-attention has identical (-1, n, -1, d) declared shapes while
  the runtime query/key lengths differ (the transformer NMT decoder),
  and the kernel computes self-attention over one [B, n, S, d]; a
  decode-step query against a longer KV cache is rejected the same way.
- an additive bias must broadcast as a KEY bias: rank-4 with dims 1 and
  2 equal to 1 (a full [B, n, S, S] bias is not expressible).
- ``softmax_mask_fuse_upper_triangle`` maps to ``causal=True``.
- a dropout between softmax and the context matmul only matches when it
  is provably the identity (``is_test`` with upscale_in_train) — probs
  dropout is not expressible in the kernel, so TRAINING programs with
  attention dropout keep the exact composed path.
- every intermediate is single-use (consumers across ALL blocks counted;
  grad ops of the matched chain excepted) and neither persistable nor in
  ``ctx.keep_vars`` (fetch targets).
- the backward chain, when present, must be the closed canonical set —
  a wanted BIAS gradient vetoes the match (the fused op declares Bias
  no-grad, matching the models' stop-gradient masks).
"""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.fluid.framework import Operator

from .framework import (ProgramPass, consumer_map, grad_groups,
                        rebuild_block, register_program_pass,
                        single_forward_consumer, static_numel)

_SOFTMAX_TYPES = ("softmax", "softmax_mask_fuse_upper_triangle")
_GRAD_TYPES = frozenset(t + "_grad" for t in (
    "matmul", "elementwise_add", "dropout") + _SOFTMAX_TYPES)


def _var(block, name):
    return block._find_var_recursive(name)


def _shape4(block, name):
    v = _var(block, name)
    if v is None or v.shape is None or len(v.shape) != 4:
        return None
    return tuple(v.shape)


# ops a q/k/v projection chain may pass through on the walk back to its
# mul/fc projection (bias add follows X; layout ops are shape-neutral)
_CHAIN_PASSTHRU = frozenset({"transpose", "transpose2", "reshape",
                             "reshape2", "elementwise_add", "scale",
                             "cast"})
_PROJECTION_TYPES = frozenset({"mul", "fc", "matmul", "matmul_v2"})


def _producer_map(block):
    prod = {}
    for op in block.ops:
        if op.attrs.get("op_role") in ("backward", "optimize"):
            continue
        for n in op.output_arg_names:
            prod[n] = op  # last forward writer wins
    return prod


def _sequence_source(prod, name, limit=8):
    """Walk a q/k/v head tensor up through its projection chain
    (transpose ← reshape ← [bias add] ← mul/fc) and return the
    projection's INPUT activation name — the sequence the head was
    computed from.  None when the walk doesn't land on a projection
    (conservative: no proof of a common source, no match)."""
    cur = name
    for _ in range(limit):
        op = prod.get(cur)
        if op is None:
            return None
        if op.type in _CHAIN_PASSTHRU:
            xs = op.inputs.get("X") or op.inputs.get("Input") or []
            if len(xs) != 1:
                return None
            cur = xs[0]
            continue
        if op.type in _PROJECTION_TYPES:
            xs = op.inputs.get("X") or op.inputs.get("Input") or []
            return xs[0] if xs else None
        return None
    return None


def _is_identity_dropout(op, program):
    return ((op.attrs.get("is_test", False)
             or getattr(program, "_is_test", False))
            and op.attrs.get("dropout_implementation",
                             "downgrade_in_infer") == "upscale_in_train")


@register_program_pass
class FuseAttentionPass(ProgramPass):
    name = "fuse_attention"

    def apply(self, program, ctx):
        block = program.global_block()
        cons = consumer_map(program)
        groups = grad_groups(block)
        self._prod = _producer_map(block)
        claimed = set()
        matches = []
        for idx, op in enumerate(block.ops):
            if id(op) in claimed:
                continue
            m = self._match(program, block, cons, idx, op, ctx, claimed)
            if m is None:
                continue
            g = self._match_backward(block, cons, groups, m)
            if g is None:
                continue  # a backward chain exists but is not canonical
            m["grad"] = g
            for o in m["chain_ops"] + g["ops"]:
                claimed.add(id(o))
            matches.append(m)
        if not matches:
            return {"changed": False, "sites": 0}
        modeled = self._rewrite(program, block, matches)
        return {"changed": True, "sites": len(matches),
                "modeled_bytes_saved": modeled,
                "causal_sites": sum(1 for m in matches if m["causal"]),
                "bias_sites": sum(1 for m in matches if m["bias"])}

    # -- matching ------------------------------------------------------
    def _match(self, program, block, cons, idx, op, ctx, claimed):
        if op.type != "matmul" or not op.attrs.get("transpose_Y") \
                or op.attrs.get("transpose_X"):
            return None
        q, k = op.input("X")[0], op.input("Y")[0]
        qs, ks = _shape4(block, q), _shape4(block, k)
        if qs is None or ks is None or qs != ks:
            return None
        # self-attention proof: q and k must project from the SAME
        # sequence (static -1 dims compare equal for cross-attention too)
        src_q = _sequence_source(self._prod, q)
        if src_q is None or _sequence_source(self._prod, k) != src_q:
            return None
        chain = [op]
        internals = []
        cur = op.output("Out")[0]
        bias = None
        nxt = self._next(cons, cur, ctx, block)
        if nxt is not None and nxt.type == "elementwise_add" \
                and nxt.input("X") == [cur]:
            bshape = _shape4(block, nxt.input("Y")[0])
            if bshape is None or bshape[1] != 1 or bshape[2] != 1:
                return None
            bias = nxt.input("Y")[0]
            chain.append(nxt)
            internals.append(cur)
            cur = nxt.output("Out")[0]
            nxt = self._next(cons, cur, ctx, block)
        if nxt is None or nxt.type not in _SOFTMAX_TYPES \
                or nxt.input("X") != [cur]:
            return None
        causal = nxt.type == "softmax_mask_fuse_upper_triangle"
        if not causal and nxt.attrs.get("axis", -1) not in (-1, 3):
            return None
        chain.append(nxt)
        internals.append(cur)
        cur = nxt.output("Out")[0]
        nxt = self._next(cons, cur, ctx, block)
        if nxt is not None and nxt.type == "dropout" \
                and nxt.input("X") == [cur]:
            if not _is_identity_dropout(nxt, program):
                return None
            mask = nxt.outputs.get("Mask", [])
            if mask and (cons.get(mask[0]) or mask[0] in ctx.keep_vars):
                return None  # someone reads/fetches the mask: keep it
            chain.append(nxt)
            internals.append(cur)
            cur = nxt.output("Out")[0]
            nxt = self._next(cons, cur, ctx, block)
        if nxt is None or nxt.type != "matmul" \
                or nxt.attrs.get("transpose_X") \
                or nxt.attrs.get("transpose_Y") \
                or nxt.attrs.get("alpha", 1.0) != 1.0 \
                or nxt.input("X") != [cur]:
            return None
        v = nxt.input("Y")[0]
        if _shape4(block, v) != ks:
            return None
        if _sequence_source(self._prod, v) != src_q:
            return None
        chain.append(nxt)
        internals.append(cur)
        if any(id(o) in claimed for o in chain):
            return None
        for n in internals:
            if n in ctx.keep_vars:
                return None
            var = _var(block, n)
            if var is not None and var.persistable:
                return None
        return {"chain_ops": chain, "internals": internals,
                "q": q, "k": k, "v": v, "bias": bias, "causal": causal,
                "sm_scale": float(op.attrs.get("alpha", 1.0)),
                "out": chain[-1].output("Out")[0],
                "op_role": chain[0].attrs.get("op_role")}

    def _next(self, cons, name, ctx, block):
        # block-scoped: a sub-block consumer (while/cond body) ends the
        # chain — the matcher's indices and rewrite cover block 0 only
        return single_forward_consumer(cons, name, block=block)

    def _match_backward(self, block, cons, groups, m):
        """Collect the chain's grad ops and verify the closed canonical
        structure.  Returns {"ops": [...], names...}; {"ops": []} for a
        forward-only program; None to veto the whole match."""
        idx_of = {id(op): i for i, op in enumerate(block.ops)}
        fwd_idxs = [idx_of[id(o)] for o in m["chain_ops"]]
        gops = [g for i in fwd_idxs for g in groups.get(i, [])]
        if not gops:
            return {"ops": []}
        if any(g.type not in _GRAD_TYPES for g in gops):
            return None
        first_mm, last_mm = m["chain_ops"][0], m["chain_ops"][-1]
        g_first = [g for g in gops
                   if g.attrs.get("fwd_op_idx") == idx_of[id(first_mm)]]
        g_last = [g for g in gops
                  if g.attrs.get("fwd_op_idx") == idx_of[id(last_mm)]]
        if len(g_first) != 1 or len(g_last) != 1:
            return None
        out_grad = g_last[0].inputs.get("Out@GRAD", [None])[0]
        if out_grad is None:
            return None
        qg = g_first[0].outputs.get("X@GRAD", [None])[0]
        kg = g_first[0].outputs.get("Y@GRAD", [None])[0]
        vg = g_last[0].outputs.get("Y@GRAD", [None])[0]
        # a wanted bias gradient rides the fused op too (the kernel's
        # custom VJP computes db; the models' mask chain is live through
        # the scale/reshape ops even under the stop_gradient stamp)
        bg = None
        for g in gops:
            if g.type == "elementwise_add_grad":
                bg = g.outputs.get("Y@GRAD", [None])[0]
        # closure: everything the group produces is consumed only inside
        # the group, except the exit gradients
        group_ids = {id(g) for g in gops}
        chain_ids = {id(o) for o in m["chain_ops"]}
        exits = {n for n in (qg, kg, vg, bg) if n}
        internal_ok = chain_ids | group_ids
        for g in gops:
            for n in g.output_arg_names:
                if n in exits:
                    continue
                for user in cons.get(n, []):
                    if id(user) not in internal_ok:
                        return None
        # and the forward internals may only be read by the chain+group
        for n in m["internals"]:
            for user in cons.get(n, []):
                if id(user) not in internal_ok:
                    return None
        return {"ops": gops, "out_grad": out_grad,
                "qg": qg, "kg": kg, "vg": vg, "bg": bg}

    # -- rewriting -----------------------------------------------------
    def _rewrite(self, program, block, matches):
        idx_of = {id(op): i for i, op in enumerate(block.ops)}
        remove, inserts = set(), {}
        modeled = 0
        for m in matches:
            for n in m["internals"]:
                numel = static_numel(block, n)
                if numel is not None:
                    modeled += 8 * numel  # fp32 write + read per tensor
            attrs = {"causal": m["causal"], "sm_scale": m["sm_scale"]}
            if m["op_role"] is not None:
                attrs["op_role"] = m["op_role"]
            inputs = {"Q": [m["q"]], "K": [m["k"]], "V": [m["v"]]}
            if m["bias"]:
                inputs["Bias"] = [m["bias"]]
            fused = Operator(block, "flash_attention", inputs=inputs,
                             outputs={"Out": [m["out"]]}, attrs=attrs)
            out_var = _var(block, m["out"])
            if out_var is not None:
                out_var.op = fused
            chain_idxs = [idx_of[id(o)] for o in m["chain_ops"]]
            for o in m["chain_ops"]:
                remove.add(id(o))
            inserts[id(m["chain_ops"][0])] = ([fused], chain_idxs)
            g = m["grad"]
            if g["ops"]:
                gin = dict(inputs)
                gin["Out@GRAD"] = [g["out_grad"]]
                gouts = {}
                for slot, n in (("Q@GRAD", g["qg"]), ("K@GRAD", g["kg"]),
                                ("V@GRAD", g["vg"]),
                                ("Bias@GRAD", g.get("bg"))):
                    if n:
                        gouts[slot] = [n]
                gattrs = dict(attrs)
                gattrs["op_role"] = "backward"
                # renumbered to the fused op's final index by
                # rebuild_block's redirect map
                gattrs["fwd_op_idx"] = chain_idxs[0]
                gop = Operator(block, "flash_attention_grad",
                               inputs=gin, outputs=gouts, attrs=gattrs)
                earliest = min(g["ops"], key=lambda o: idx_of[id(o)])
                for o in g["ops"]:
                    remove.add(id(o))
                prev = inserts.get(id(earliest))
                if prev is None:
                    inserts[id(earliest)] = ([gop], [])
                else:  # anchor shared with another insert (cannot happen
                    prev[0].append(gop)  # across disjoint matches; safe)
        rebuild_block(block, remove, inserts)
        return modeled
