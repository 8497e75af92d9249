"""Reader decorators (counterpart of the JAX package's top-level
``reader.py``; reference python/paddle/reader/decorator.py).

A *reader creator* is a zero-arg callable returning an iterator of samples.
These combinators compose reader creators; they are pure Python (the
standard library only), and give the same samples in the same order as
the JAX package's.
"""

from __future__ import annotations

import itertools
import queue
import random as _random
import sys
import threading

__all__ = [
    "batch", "shuffle", "buffered", "cache", "chain", "compose",
    "map_readers", "firstn", "xmap_readers", "ComposeNotAligned",
]


def batch(reader, batch_size, drop_last=False):
    """Group samples into lists of batch_size (reference paddle.batch)."""

    def batch_reader():
        it = reader()
        b = []
        for sample in it:
            b.append(sample)
            if len(b) == batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batch_reader


def shuffle(reader, buf_size, seed=None):
    def shuffle_reader():
        rng = _random.Random(seed)
        buf = []
        for sample in reader():
            buf.append(sample)
            if len(buf) >= buf_size:
                rng.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            rng.shuffle(buf)
            yield from buf

    return shuffle_reader


def buffered(reader, size):
    """Background-thread prefetch of up to `size` samples (reference
    decorator.py buffered) — the host-side half of the double-buffer pipeline
    (reference operators/reader/buffered_reader.cc).  Reader errors are
    re-raised in the consumer, not swallowed by the fill thread."""

    class _End:
        pass

    def buffered_reader():
        q = queue.Queue(maxsize=size)
        error = []

        def fill():
            try:
                for sample in reader():
                    q.put(sample)
            except BaseException as e:
                error.append(e)
            finally:
                q.put(_End)

        t = threading.Thread(target=fill, daemon=True)
        t.start()
        while True:
            s = q.get()
            if s is _End:
                if error:
                    raise error[0]
                break
            yield s

    return buffered_reader


def cache(reader):
    all_data = []
    filled = []

    def cache_reader():
        if not filled:
            all_data.extend(reader())
            filled.append(True)
        return iter(all_data)

    return cache_reader


def chain(*readers):
    def chain_reader():
        return itertools.chain(*[r() for r in readers])

    return chain_reader


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, check_alignment=True):
    def compose_reader():
        iters = [iter(r()) for r in readers]
        _sentinel = object()
        while True:
            items = [next(it, _sentinel) for it in iters]
            ended = [it is _sentinel for it in items]
            if all(ended):
                return
            if any(ended):
                if check_alignment:
                    raise ComposeNotAligned(
                        "composed readers have different lengths")
                return
            out = ()
            for it in items:
                out += it if isinstance(it, tuple) else (it,)
            yield out

    return compose_reader


def map_readers(func, *readers):
    def mapped_reader():
        for items in zip(*[r() for r in readers]):
            yield func(*items)

    return mapped_reader


def firstn(reader, n):
    def firstn_reader():
        return itertools.islice(reader(), n)

    return firstn_reader


def xmap_readers(mapper, reader, process_num=1, buffer_size=64, order=False):
    """Parallel map over a reader with worker threads (reference
    decorator.py xmap_readers)."""

    class _End:
        pass

    def xmap_reader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)
        error = []

        def feed():
            try:
                for i, sample in enumerate(reader()):
                    in_q.put((i, sample))
            except BaseException as e:
                error.append(e)
            finally:
                # always deliver sentinels so workers (and the consumer
                # counting _End) terminate even when the source reader raises
                for _ in range(process_num):
                    in_q.put(_End)

        def work():
            try:
                while True:
                    item = in_q.get()
                    if item is _End:
                        return
                    i, sample = item
                    out_q.put((i, mapper(sample)))
            except BaseException as e:
                error.append(e)
            finally:
                out_q.put(_End)

        threading.Thread(target=feed, daemon=True).start()
        workers = [threading.Thread(target=work, daemon=True) for _ in range(process_num)]
        for w in workers:
            w.start()
        done = 0
        pending = {}
        next_i = 0
        while done < process_num:
            item = out_q.get()
            if item is _End:
                done += 1
                continue
            if not order:
                yield item[1]
            else:
                pending[item[0]] = item[1]
                while next_i in pending:
                    yield pending.pop(next_i)
                    next_i += 1
        if error:
            raise error[0]
        for i in sorted(pending):
            yield pending[i]

    return xmap_reader


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    """Interleave several readers, each drained on its own worker thread
    (reference decorator.py multiprocess_reader; threads instead of fork —
    a fork after CUDA is initialized leaves the child without a usable
    device context, and the host-side decode work these wrap releases the
    GIL in numpy anyway)."""
    assert isinstance(readers, (list, tuple)) and readers, "readers required"

    def reader():
        out_q = queue.Queue(maxsize=queue_size)
        errors = []
        stop = threading.Event()

        def drain(r):
            try:
                for sample in r():
                    # bounded put that re-checks stop: an abandoned consumer
                    # must not leave this thread blocked forever
                    while not stop.is_set():
                        try:
                            out_q.put(sample, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # surfaced in the consumer
                errors.append(e)
            finally:
                # END must reach an active consumer (else it waits forever);
                # only drop it once the consumer has signalled stop
                while not stop.is_set():
                    try:
                        out_q.put(_MP_END, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        threads = [threading.Thread(target=drain, args=(r,), daemon=True)
                   for r in readers]
        for t in threads:
            t.start()
        done = 0
        try:
            while done < len(readers):
                if errors:  # surface a worker failure immediately
                    raise errors[0]
                item = out_q.get()
                if item is _MP_END:
                    done += 1
                else:
                    yield item
            if errors:
                raise errors[0]
        finally:
            stop.set()

    return reader


_MP_END = object()


class PipeReader:
    """Stream samples out of a shell command's stdout (reference
    decorator.py PipeReader)."""

    def __init__(self, command, bufsize=8192, file_type="plain"):
        if not isinstance(command, str):
            raise TypeError("command must be a string")
        self.command = command
        self.bufsize = bufsize
        self.file_type = file_type

    def get_line(self, cut_lines=True, line_break="\n"):
        import subprocess

        proc = subprocess.Popen(
            self.command, shell=True, bufsize=self.bufsize,
            stdout=subprocess.PIPE)
        out = proc.stdout
        if self.file_type == "gzip":
            import gzip

            out = gzip.GzipFile(fileobj=out)
        remained = b""
        while True:
            buf = out.read(self.bufsize)
            if not buf:
                break
            if cut_lines:
                lines = (remained + buf).split(line_break.encode())
                remained = lines.pop()
                for line in lines:
                    yield line.decode("utf8", "ignore")
            else:
                yield buf.decode("utf8", "ignore")
        if remained:
            yield remained.decode("utf8", "ignore")
        proc.wait()


class Fake:
    """Caches the first sample of the wrapped reader and replays it
    (reference decorator.py Fake) — for data-independent perf runs."""

    def __init__(self):
        self.data = None
        self.yield_num = 0

    def __call__(self, reader, fake_num):
        def fake_reader():
            if self.data is None:
                self.data = next(reader())
            while self.yield_num < fake_num:
                self.yield_num += 1
                yield self.data
            self.yield_num = 0

        return fake_reader


# ---------------------------------------------------------------------------
# paddle.reader.creator (reference python/paddle/reader/creator.py)
# ---------------------------------------------------------------------------


def _creator_np_array(x):
    """Reader creator over the rows of a numpy array."""

    def reader():
        for row in x:
            yield row

    return reader


def _creator_text_file(path):
    """Reader creator yielding stripped lines of a text file."""

    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def _creator_recordio(paths, buf_size=100):
    """Reader creator over RecordIO file(s).  The scanner is the JAX
    package's C++ runtime (``native/``), which this package has no copy
    of yet: calling the creator raises."""
    raise NotImplementedError(
        "reader.creator.recordio needs the native RecordIO scanner, which "
        "is not ported yet")


def _make_creator_module():
    import types

    m = types.ModuleType("paddle_tpu_torch.reader.creator",
                         "reader creators (reference paddle.reader.creator)")
    m.np_array = _creator_np_array
    m.text_file = _creator_text_file
    m.recordio = _creator_recordio
    sys.modules[m.__name__] = m
    return m


creator = _make_creator_module()
__all__ += ["multiprocess_reader", "PipeReader", "Fake", "creator"]
