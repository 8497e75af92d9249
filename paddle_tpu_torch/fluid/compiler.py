"""CompiledProgram, BuildStrategy and ExecutionStrategy (counterpart of
``paddle_tpu/fluid/compiler.py``): the data-parallel entry point.

``CompiledProgram(main, build_strategy=bs).with_data_parallel(
loss_name=..., places=[...])`` run by ``Executor.run`` transpiles the
program for data parallelism and runs it over one replica a place
(parallel/data_parallel.py).  Below two replicas it falls back to the
plain executor, as a one-GPU ParallelExecutor does.

One difference from the JAX package: there the replica count is
``jax.device_count()`` (every device of the mesh); here it is
``len(places)``, or the number of CUDA cards when ``places`` is None,
because a place may repeat (four replicas on one card).
"""

from __future__ import annotations

__all__ = ["CompiledProgram", "BuildStrategy", "ExecutionStrategy"]


class BuildStrategy:
    """The knobs of ``details/build_strategy.h`` that the data-parallel
    lane reads.  None defers to the flag of the same name
    (fluid/flags.py); ``gspmd_executor`` raises, the lane is not
    ported."""

    def __init__(self):
        self.sync_batch_norm = False
        self.quant_allreduce = None
        self.quant_allreduce_algo = None
        self.overlap_allreduce = None
        self.fused_update = None
        self.gspmd_executor = None


class ExecutionStrategy:
    """Accepted for scripts; the eager replica loop reads none of it."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.num_iteration_per_run = 1
        self.use_thread_barrier = False


class CompiledProgram:
    def __init__(self, program_or_graph, build_strategy=None):
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()
        self._is_data_parallel = False
        self._loss_name = None
        self._places = None
        self._dp_runner = None

    def with_data_parallel(self, loss_name=None, build_strategy=None,
                           exec_strategy=None, share_vars_from=None,
                           places=None):
        if share_vars_from is not None:
            raise NotImplementedError(
                "with_data_parallel(share_vars_from=...) is not ported")
        self._is_data_parallel = True
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        self._places = list(places) if places is not None else None
        return self

    def _num_replicas(self):
        if self._places is not None:
            return len(self._places)
        import torch

        return torch.cuda.device_count() if torch.cuda.is_available() else 0

    def _run(self, executor, feed, fetch_list, scope, return_numpy):
        if not self._is_data_parallel or self._num_replicas() < 2:
            # one replica: the plain path, as a one-GPU ParallelExecutor
            return executor.run(self._program, feed=feed,
                                fetch_list=fetch_list, scope=scope,
                                return_numpy=return_numpy)
        if self._dp_runner is None:
            from paddle_tpu_torch.parallel import data_parallel

            self._dp_runner = data_parallel.DataParallelRunner(
                self._program, self._loss_name, self._build_strategy,
                places=self._places)
        return self._dp_runner.run(executor, feed, fetch_list, scope,
                                   return_numpy)
