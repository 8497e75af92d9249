"""Legacy Evaluator classes (counterpart of
``paddle_tpu/fluid/evaluator.py``, the reference's
python/paddle/fluid/evaluator.py).

Deprecated in the reference in favour of fluid.metrics (the deprecation
warning is kept) but still public 1.5 API: graph-state accumulators,
persistable state vars summed every mini-batch, reset and read by small
side programs, each built once an evaluator.
"""

from __future__ import annotations

import warnings

import numpy as np

from . import layers, unique_name
from .framework import Program, Variable, program_guard
from .layer_helper import LayerHelper

__all__ = ["ChunkEvaluator", "EditDistance", "DetectionMAP"]


def _clone_var_(block, var):
    return block.create_var(name=var.name, shape=var.shape, dtype=var.dtype,
                            persistable=True)


class Evaluator:
    """Base evaluator (reference evaluator.py:45): state vars are
    persistable, zeroed by `reset`, folded every mini-batch by the ops the
    subclass appended to the main program."""

    def __init__(self, name, **kwargs):
        warnings.warn(
            f"The {type(self).__name__} is deprecated, please use "
            f"fluid.metrics.{type(self).__name__} instead.", Warning)
        self.states = []
        self.metrics = []
        self.helper = LayerHelper(name, **kwargs)
        # memoized side programs: rebuilding one a call would make a new
        # plan (and, on the card, a new graph) in the executor every epoch
        self._reset_program = None
        self._eval_program = None

    def reset(self, executor, reset_program=None):
        if reset_program is None:
            if self._reset_program is None:
                self._reset_program = Program()
                with program_guard(main_program=self._reset_program):
                    for var in self.states:
                        assert isinstance(var, Variable)
                        g_var = _clone_var_(
                            self._reset_program.current_block(), var)
                        layers.fill_constant(shape=g_var.shape, value=0.0,
                                             dtype=g_var.dtype, out=g_var)
            executor.run(self._reset_program)
            return
        with program_guard(main_program=reset_program):
            for var in self.states:
                assert isinstance(var, Variable)
                g_var = _clone_var_(reset_program.current_block(), var)
                layers.fill_constant(shape=g_var.shape, value=0.0,
                                     dtype=g_var.dtype, out=g_var)
        executor.run(reset_program)

    def eval(self, executor, eval_program=None):
        raise NotImplementedError

    def _fetch_states(self, executor, eval_program):
        if eval_program is None:
            if self._eval_program is None:
                self._eval_program = Program()
                block = self._eval_program.current_block()
                for s in self.states:
                    _clone_var_(block, s)
            eval_program = self._eval_program
        else:
            block = eval_program.current_block()
            for s in self.states:
                _clone_var_(block, s)
        return executor.run(eval_program,
                            fetch_list=[s.name for s in self.states])

    def _create_state(self, suffix, dtype, shape):
        state = self.helper.create_variable(
            name="_".join([unique_name.generate(self.helper.name), suffix]),
            persistable=True, dtype=dtype, shape=shape)
        self.states.append(state)
        return state


class ChunkEvaluator(Evaluator):
    """Accumulate chunk_eval counts across batches; eval() returns
    (precision, recall, f1) over the whole pass (reference
    evaluator.py:127)."""

    def __init__(self, input, label, chunk_scheme, num_chunk_types,
                 excluded_chunk_types=None, length=None):
        super().__init__("chunk_eval")
        main_program = self.helper.main_program
        if main_program.current_block().idx != 0:
            raise ValueError("You can only invoke Evaluator in root block")

        self.num_infer_chunks = self._create_state(
            dtype="int64", shape=[1], suffix="num_infer_chunks")
        self.num_label_chunks = self._create_state(
            dtype="int64", shape=[1], suffix="num_label_chunks")
        self.num_correct_chunks = self._create_state(
            dtype="int64", shape=[1], suffix="num_correct_chunks")
        (precision, recall, f1_score, num_infer_chunks, num_label_chunks,
         num_correct_chunks) = layers.chunk_eval(
            input=input, label=label, chunk_scheme=chunk_scheme,
            num_chunk_types=num_chunk_types, length=length)
        cast = lambda v: layers.cast(v, "int64")  # noqa: E731
        layers.sums(input=[self.num_infer_chunks, cast(num_infer_chunks)],
                    out=self.num_infer_chunks)
        layers.sums(input=[self.num_label_chunks, cast(num_label_chunks)],
                    out=self.num_label_chunks)
        layers.sums(input=[self.num_correct_chunks, cast(num_correct_chunks)],
                    out=self.num_correct_chunks)
        self.metrics.extend([precision, recall, f1_score])

    def eval(self, executor, eval_program=None):
        num_infer, num_label, num_correct = (
            float(np.asarray(v).reshape(-1)[0])
            for v in self._fetch_states(executor, eval_program))
        precision = num_correct / num_infer if num_infer else 0.0
        recall = num_correct / num_label if num_label else 0.0
        f1 = (2 * precision * recall / (precision + recall)
              if num_correct else 0.0)
        return (np.array([precision], "float32"),
                np.array([recall], "float32"),
                np.array([f1], "float32"))


class EditDistance(Evaluator):
    """Accumulate edit distances; eval() returns (avg_distance,
    avg_instance_error) over the pass (reference evaluator.py:218)."""

    def __init__(self, input, label, ignored_tokens=None, input_length=None,
                 label_length=None):
        super().__init__("edit_distance")
        main_program = self.helper.main_program
        if main_program.current_block().idx != 0:
            raise ValueError("You can only invoke Evaluator in root block")

        self.total_distance = self._create_state(
            dtype="float32", shape=[1], suffix="total_distance")
        self.seq_num = self._create_state(
            dtype="int64", shape=[1], suffix="seq_num")
        self.instance_error = self._create_state(
            dtype="int64", shape=[1], suffix="instance_error")
        if ignored_tokens:
            raise NotImplementedError(
                "ignored_tokens is not supported by the dense edit_distance "
                "layer; strip the tokens before feeding")
        distances, seq_num = layers.edit_distance(
            input=input, label=label, normalized=False,
            input_length=input_length, label_length=label_length)
        zero = layers.fill_constant(shape=[1], value=0.0, dtype="float32")
        compare_result = layers.equal(distances, zero)
        seq_right_count = layers.reduce_sum(
            layers.cast(x=compare_result, dtype="int64"))
        instance_error_count = layers.elementwise_sub(
            layers.cast(seq_num, "int64"), seq_right_count)
        total_distance = layers.reduce_sum(distances)
        layers.sums(input=[self.total_distance, total_distance],
                    out=self.total_distance)
        layers.sums(input=[self.seq_num, layers.cast(seq_num, "int64")],
                    out=self.seq_num)
        layers.sums(input=[self.instance_error, instance_error_count],
                    out=self.instance_error)
        self.metrics.append(distances)

    def eval(self, executor, eval_program=None):
        total, seq_num, inst_err = (
            float(np.asarray(v).reshape(-1)[0])
            for v in self._fetch_states(executor, eval_program))
        avg_distance = total / seq_num if seq_num else 0.0
        avg_instance_error = inst_err / seq_num if seq_num else 0.0
        return (np.array([avg_distance], "float32"),
                np.array([avg_instance_error], "float32"))


class DetectionMAP(Evaluator):
    """The reference's graph-state DetectionMAP rides the detection_map op
    (evaluator.py:299).  Here, as in the JAX package, detection mAP is a
    host metric (fluid.metrics.DetectionMAP accumulates detections and
    ground truth in numpy); the graph-state form raises."""

    def __init__(self, *args, **kwargs):  # noqa: D401
        raise NotImplementedError(
            "graph-state DetectionMAP is not supported; use "
            "fluid.metrics.DetectionMAP (host-side accumulation)")
