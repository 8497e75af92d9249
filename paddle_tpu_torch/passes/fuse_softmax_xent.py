"""fuse_softmax_cross_entropy: pattern-match the softmax→cross_entropy
chain and rewrite it to the ``fused_softmax_cross_entropy`` op.

The classifier-head spelling the book scripts (and the MLM-head-style
graphs that compose ``softmax`` + ``cross_entropy`` instead of calling
``softmax_with_cross_entropy``) emit:

    softmax(logits)            -> probs     [.., C]
    cross_entropy(probs, lbl)  -> loss      [.., 1]

materializes the [positions, C] probability tensor as a program
variable — written by the softmax, re-read by ``cross_entropy`` AND by
both backward ops (the residual).  The rewrite replaces the
``cross_entropy`` op (and, on training programs, the
``cross_entropy_grad`` +
``softmax_grad`` backward pair, located by their ``fwd_op_idx`` stamps)
with ONE ``fused_softmax_cross_entropy`` op whose lowering is the
BIT-EXACT composition of the two originals (ops/math_ops.py — same
primitives, same eps clamp), so the passes-on and passes-off programs
agree to the last bit.

The softmax op itself is RETAINED, now consumer-less: the probability
tensor is the model's user-visible prediction in every book-script
head (``save_inference_model(target_vars=[predict])``, the post-train
parity fetch), so deleting its producer would break any fetch outside
the first run's pinned list.  Per-fetch-signature pruning
(fluid/executor.py ``_prune_ops``, run for each plan) drops the
dangling softmax from every plan that does not fetch it — the training
step stops
materializing the [positions, C] tensor, and a program that DOES fetch
probs computes them only then.

Match contract (the JAX package's, held against it in
tests/test_torch_port_passes.py):

- the softmax reduces over the LAST axis (attrs axis in {-1, rank-1}) —
  the fused lowering forwards the axis to softmax but cross_entropy
  always picks over -1, so any other axis keeps the composed path.
- ``cross_entropy`` is the probability tensor's ONLY forward consumer
  (consumers across ALL blocks counted) — a second reader (an accuracy
  op) would make the backward a partial-gradient accumulation the
  single fused grad cannot replace.
- the backward chain, when present, must be the closed canonical pair —
  an extra reader of the intermediate cotangent vetoes the match.
- ``cross_entropy2`` (with its XShape/MatchX side outputs) does not
  match; ``soft_label`` and ``ignore_index`` ride through as attrs.
"""

from __future__ import annotations

from paddle_tpu_torch.fluid.framework import Operator

from .framework import (ProgramPass, consumer_map, grad_groups,
                        rebuild_block, register_program_pass,
                        single_forward_consumer, static_numel)

_GRAD_TYPES = frozenset({"softmax_grad", "cross_entropy_grad"})


def _var(block, name):
    return block._find_var_recursive(name)


@register_program_pass
class FuseSoftmaxCrossEntropyPass(ProgramPass):
    name = "fuse_softmax_cross_entropy"

    def apply(self, program, ctx):
        block = program.global_block()
        cons = consumer_map(program)
        groups = grad_groups(block)
        claimed = set()
        matches = []
        for op in block.ops:
            if id(op) in claimed:
                continue
            m = self._match(block, cons, op, ctx)
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
        modeled = self._rewrite(block, matches)
        return {"changed": True, "sites": len(matches),
                "modeled_bytes_saved": modeled,
                "soft_label_sites": sum(1 for m in matches
                                        if m["soft_label"])}

    # -- matching ------------------------------------------------------
    def _match(self, block, cons, op, ctx):
        if op.type != "softmax" \
                or op.attrs.get("op_role") in ("backward", "optimize"):
            return None
        sm_out = op.output("Out")[0]
        v = _var(block, sm_out)
        rank = len(v.shape) if (v is not None and v.shape) else None
        axis = op.attrs.get("axis", -1)
        if axis != -1 and (rank is None or axis != rank - 1):
            return None
        nxt = single_forward_consumer(cons, sm_out, block=block)
        if nxt is None or nxt.type != "cross_entropy" \
                or nxt.input("X") != [sm_out]:
            return None
        return {"chain_ops": [op, nxt], "x": op.input("X")[0],
                "label": nxt.input("Label")[0], "sm_out": sm_out,
                "out": nxt.output("Y")[0],
                "soft_label": bool(nxt.attrs.get("soft_label", False)),
                "ignore_index": nxt.attrs.get("ignore_index", -100),
                "axis": axis,
                "op_role": op.attrs.get("op_role")}

    def _match_backward(self, block, cons, groups, m):
        """The closed canonical pair: cross_entropy_grad feeding
        softmax_grad, nothing else reading their intermediates.
        Returns {"ops": []} for a forward-only program; None vetoes."""
        idx_of = {id(op): i for i, op in enumerate(block.ops)}
        sm_op, ce_op = m["chain_ops"]
        gops = [g for i in (idx_of[id(sm_op)], idx_of[id(ce_op)])
                for g in groups.get(i, [])]
        if not gops:
            return {"ops": []}
        if any(g.type not in _GRAD_TYPES for g in gops) or len(gops) != 2:
            return None
        ce_g = [g for g in gops if g.type == "cross_entropy_grad"]
        sm_g = [g for g in gops if g.type == "softmax_grad"]
        if len(ce_g) != 1 or len(sm_g) != 1:
            return None
        ce_g, sm_g = ce_g[0], sm_g[0]
        out_grad = ce_g.inputs.get("Y@GRAD", [None])[0]
        d_sm = ce_g.outputs.get("X@GRAD", [None])[0]
        xg = sm_g.outputs.get("X@GRAD", [None])[0]
        if out_grad is None or d_sm is None or xg is None:
            return None
        if sm_g.inputs.get("Out@GRAD", [None])[0] != d_sm:
            return None
        # closure: the intermediate cotangent is read only inside the
        # group (the probability tensor's only forward reader is already
        # proven to be the cross_entropy; its producer stays)
        internal_ok = {id(o) for o in m["chain_ops"]} | \
            {id(g) for g in gops}
        for user in cons.get(d_sm, []):
            if id(user) not in internal_ok:
                return None
        return {"ops": [ce_g, sm_g], "out_grad": out_grad, "xg": xg}

    # -- rewriting -----------------------------------------------------
    def _rewrite(self, block, matches):
        idx_of = {id(op): i for i, op in enumerate(block.ops)}
        remove, inserts = set(), {}
        modeled = 0
        for m in matches:
            numel = static_numel(block, m["sm_out"])
            if numel is not None:
                modeled += 8 * numel  # fp32 write + read of the probs
            attrs = {"axis": m["axis"], "soft_label": m["soft_label"],
                     "ignore_index": m["ignore_index"]}
            if m["op_role"] is not None:
                attrs["op_role"] = m["op_role"]
            inputs = {"X": [m["x"]], "Label": [m["label"]]}
            fused = Operator(block, "fused_softmax_cross_entropy",
                             inputs=inputs,
                             outputs={"Out": [m["out"]]}, attrs=attrs)
            out_var = _var(block, m["out"])
            if out_var is not None:
                out_var.op = fused
            # the softmax op is RETAINED (now consumer-less): prediction
            # fetches / save_inference_model keep their producer, and
            # BlockPlan pruning drops it from executables that never
            # fetch the probabilities
            ce_op = m["chain_ops"][1]
            ce_idx = idx_of[id(ce_op)]
            remove.add(id(ce_op))
            inserts[id(ce_op)] = ([fused], [ce_idx])
            g = m["grad"]
            if g["ops"]:
                gin = dict(inputs)
                gin["Out@GRAD"] = [g["out_grad"]]
                gattrs = dict(attrs)
                gattrs["op_role"] = "backward"
                # renumbered to the fused op's final index by
                # rebuild_block's redirect map
                gattrs["fwd_op_idx"] = ce_idx
                gop = Operator(block, "fused_softmax_cross_entropy_grad",
                               inputs=gin,
                               outputs={"X@GRAD": [g["xg"]]},
                               attrs=gattrs)
                earliest = min(g["ops"], key=lambda o: idx_of[id(o)])
                for o in g["ops"]:
                    remove.add(id(o))
                inserts.setdefault(id(earliest), ([], []))[0].append(gop)
        rebuild_block(block, remove, inserts)
        return modeled
