"""Program-level IR graph and pass registry (counterpart of
``paddle_tpu/fluid/ir.py``).  Ported so far: the Graph / Pass /
PassRegistry / PassManager interface and ``fc_fuse_pass``, the rewrite
``inference.AnalysisPredictor`` runs on a loaded model.  The JAX
package's other registered passes (graph_viz, conv_bn_fuse,
amp_rewrite, quant_transform, multi_devices_graph) are still to be
ported.
"""

from __future__ import annotations

__all__ = ["Graph", "Node", "Pass", "PassRegistry", "PassManager",
           "register_pass", "get_pass", "apply_pass"]


class Node:
    """Graph node: an op or a var."""

    OP, VAR = "op", "var"

    def __init__(self, kind, payload, name):
        self.kind = kind
        self.payload = payload          # Operator or Variable
        self.name = name
        self.inputs: list[Node] = []    # producing/consuming edges
        self.outputs: list[Node] = []

    def is_op(self):
        return self.kind == Node.OP

    def is_var(self):
        return self.kind == Node.VAR

    def __repr__(self):
        return f"Node({self.kind}:{self.name})"


class Graph:
    """Dataflow view over one block.  Mutations happen on the underlying
    Program; the graph is an index, re-derivable at any time."""

    def __init__(self, program, block_idx=0):
        self.program = program
        self.block_idx = block_idx
        self._build()

    def _build(self):
        block = self.program.block(self.block_idx)
        self.var_nodes: dict[str, Node] = {}
        self.op_nodes: list[Node] = []

        def var_node(name):
            if name not in self.var_nodes:
                v = block._find_var_recursive(name)
                self.var_nodes[name] = Node(Node.VAR, v, name)
            return self.var_nodes[name]

        for op in block.ops:
            n = Node(Node.OP, op, op.type)
            self.op_nodes.append(n)
            for name in op.input_arg_names:
                vn = var_node(name)
                n.inputs.append(vn)
                vn.outputs.append(n)
            for name in op.output_arg_names:
                vn = var_node(name)
                n.outputs.append(vn)
                vn.inputs.append(n)

    def nodes(self):
        return self.op_nodes + list(self.var_nodes.values())

    def all_op_nodes(self):
        return list(self.op_nodes)

    def all_var_nodes(self):
        return list(self.var_nodes.values())

    def refresh(self):
        self._build()
        return self


class Pass:
    """Base pass: apply(graph) -> graph."""

    name = "pass"

    def apply(self, graph):
        raise NotImplementedError

    def __call__(self, graph):
        out = self.apply(graph)
        return (out or graph).refresh()


class _FnPass(Pass):
    def __init__(self, name, fn):
        self.name = name
        self._fn = fn

    def apply(self, graph):
        self._fn(graph)
        return graph


class PassRegistry:
    """name -> pass factory."""

    _passes: dict = {}

    @classmethod
    def register(cls, name, factory):
        cls._passes[name] = factory

    @classmethod
    def get(cls, name, **kwargs):
        if name not in cls._passes:
            raise KeyError(f"unknown pass {name!r}; known: "
                           f"{sorted(cls._passes)}")
        return cls._passes[name](**kwargs)

    @classmethod
    def has(cls, name):
        return name in cls._passes

    @classmethod
    def list(cls):
        return sorted(cls._passes)


def register_pass(name):
    """Decorator: register a Pass subclass or a `fn(graph)` function."""

    def deco(obj):
        if isinstance(obj, type) and issubclass(obj, Pass):
            PassRegistry.register(name, lambda **kw: obj(**kw))
        else:
            def factory(**kw):
                if kw:  # function passes take no construction args
                    raise TypeError(
                        f"pass {name!r} is a function pass and accepts no "
                        f"kwargs: {sorted(kw)}")
                return _FnPass(name, obj)

            PassRegistry.register(name, factory)
        return obj

    return deco


def get_pass(name, **kwargs):
    return PassRegistry.get(name, **kwargs)


def apply_pass(program, name, block_idx=0, **kwargs):
    g = Graph(program, block_idx)
    get_pass(name, **kwargs)(g)
    return program


class PassManager:
    """Ordered pass pipeline."""

    def __init__(self, passes=()):
        self.passes = [get_pass(p) if isinstance(p, str) else p
                       for p in passes]

    def append(self, p, **kwargs):
        self.passes.append(get_pass(p, **kwargs) if isinstance(p, str)
                           else p)
        return self

    def apply(self, program, block_idx=0):
        g = Graph(program, block_idx)
        for p in self.passes:
            g = p(g)
        return program


@register_pass("fc_fuse_pass")
class FcFusePass(Pass):
    """mul + elementwise_add(bias) [+ relu] -> one ``fc`` op, as the
    reference's ir/fc_fuse_pass.cc (and the JAX package's) rewrites an
    exported inference program."""

    name = "fc_fuse_pass"

    def __init__(self, with_relu=True, keep_vars=()):
        self.with_relu = with_relu
        # fetch targets live outside the program (the executor takes a
        # fetch-name list), invisible to the use count: pin them
        self.keep_vars = frozenset(keep_vars)

    def apply(self, graph):
        block = graph.program.block(graph.block_idx)
        # consumer counts across every block: an intermediate read inside
        # a sub-block must not be fused away
        uses = {}
        for b in graph.program.blocks:
            for op in b.ops:
                for n in op.input_arg_names:
                    uses[n] = uses.get(n, 0) + 1

        def single_use_tmp(name):
            v = block._find_var_recursive(name)
            return (uses.get(name, 0) == 1 and name not in self.keep_vars
                    and (v is None or not v.persistable))

        i = 0
        while i < len(block.ops):
            m = block.ops[i]
            if m.type != "mul" or i + 1 >= len(block.ops):
                i += 1
                continue
            # the fc op takes a 2-D weight only
            w_var = block._find_var_recursive(m.input("Y")[0])
            if (m.attrs.get("y_num_col_dims", 1) != 1 or w_var is None
                    or w_var.shape is None or len(w_var.shape) != 2):
                i += 1
                continue
            a = block.ops[i + 1]
            if (a.type != "elementwise_add"
                    or a.input("X")[0] != m.output("Out")[0]
                    or not single_use_tmp(m.output("Out")[0])):
                i += 1
                continue
            bias_v = block._find_var_recursive(a.input("Y")[0])
            if bias_v is None or bias_v.shape is None \
                    or len(bias_v.shape) != 1:
                i += 1
                continue
            # the bias must broadcast along the last axis, which is what
            # the fc op's right-aligned `out + bias` computes
            xd = m.attrs.get("x_num_col_dims", 1)
            if a.attrs.get("axis", -1) not in (-1, xd):
                i += 1
                continue
            act = ""
            out_name = a.output("Out")[0]
            span = 2
            if (self.with_relu and i + 2 < len(block.ops)
                    and block.ops[i + 2].type == "relu"
                    and block.ops[i + 2].input("X")[0] == out_name
                    and single_use_tmp(out_name)):
                act = "relu"
                out_name = block.ops[i + 2].output("Out")[0]
                span = 3
            x_v = block._find_var_recursive(m.input("X")[0])
            out_v = block._find_var_recursive(out_name)
            attrs = {"in_num_col_dims": xd, "activation_type": act}
            if "op_role" in m.attrs:
                attrs["op_role"] = m.attrs["op_role"]
            for _ in range(span):
                block._remove_op(i)
            block._insert_op(i, "fc",
                             inputs={"Input": [x_v], "W": [w_var],
                                     "Bias": [bias_v]},
                             outputs={"Out": [out_v]}, attrs=attrs)
            i += 1
        block.program._bump_version()
        return graph
