"""
Host pipeline primitives: generator stages behind bounded queues, each
in its own thread or process, ordered parallel maps over threads and
processes, and the device stage that keeps the card fed.

The basecall chain (read -> chunk -> batchify -> prepare -> device ->
stitch -> format -> align -> write) is lazy; each stage runs in a
background thread so host work overlaps the device work enqueued by the
device stage. The readers parse files in worker processes
(``process_map``).

Worker processes start with ``spawn``, never ``fork``: the process that
starts them holds a CUDA context and live threads, and a forked child of
such a process can deadlock or corrupt the context. So a process worker
must be picklable by import path (a module-level function, or a
``functools.partial`` of one), and it imports the package afresh.
"""

import multiprocessing
import queue
import signal
import threading
import time
import traceback
from collections import deque

from bonito_tpu_torch.profiling import batch_timing


class _End:
    """Sentinel marking the end of a stream."""


class _Error:
    """Carries a producer exception to the consuming thread."""

    def __init__(self, exc):
        self.exc = exc


END = _End()

# the start method of every worker process (module docstring)
_MP = multiprocessing.get_context("spawn")


def process_cancel():
    """SIGINT -> cooperative cancel event (checked by read generators)."""
    event = _MP.Event()
    signal.signal(signal.SIGINT, lambda *args: event.set())
    return event


class ThreadIterator:
    """Runs an iterator in a background thread behind a bounded queue. A
    producer exception re-raises in the consumer, so a failure propagates
    up the pipeline instead of truncating the output."""

    def __init__(self, iterator, maxsize=8):
        self.iterator = iterator
        self.queue = queue.Queue(maxsize)
        self.runner = threading.Thread(target=self._run, daemon=True)

    def __iter__(self):
        self.runner.start()
        while True:
            item = self.queue.get()
            if isinstance(item, _End):
                break
            if isinstance(item, _Error):
                self.runner.join()
                raise item.exc
            yield item
        self.runner.join()

    def _run(self):
        try:
            for item in self.iterator:
                self.queue.put(item)
        except BaseException as e:  # noqa: BLE001 — forwarded, not dropped
            self.queue.put(_Error(e))
        finally:
            self.queue.put(END)


def thread_iter(iterator, maxsize=8):
    return ThreadIterator(iterator, maxsize=maxsize)


def _run_into(iterator, q):
    """Process body of ``process_iter``: the items, then END, into ``q``;
    a producer exception goes across as a RuntimeError with its
    traceback (the exception itself may not pickle)."""
    try:
        for item in iterator:
            q.put(item)
    except BaseException:  # noqa: BLE001 — forwarded, not dropped
        q.put(_Error(RuntimeError(
            f"process_iter producer failed:\n{traceback.format_exc()}")))
    finally:
        q.put(END)


def process_iter(iterator, maxsize=8):
    """Run a picklable iterable in a worker process behind a bounded
    queue; its items come back in order, and an exception there re-raises
    here."""
    q = _MP.Queue(maxsize)
    proc = _MP.Process(target=_run_into, args=(iterator, q), daemon=True)

    def gen():
        proc.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, _End):
                    break
                if isinstance(item, _Error):
                    raise item.exc
                yield item
        finally:
            proc.join(timeout=1.0)
            if proc.is_alive():
                proc.terminate()
                proc.join()

    return gen()


# ---------------------------------------------------------------------------
# ordered parallel maps over a stream of (key, value) items
# ---------------------------------------------------------------------------

def _put_or_stop(q, item, stop):
    """Bounded put that gives up when ``stop`` is set, so that a producer
    never blocks for ever on a consumer that has gone. True if put."""
    while True:
        try:
            q.put(item, timeout=0.2)
            return True
        except queue.Full:
            if stop.is_set():
                return False


def _get_or_stop(q, stop):
    """Bounded get that gives up (None) when ``stop`` is set."""
    while True:
        try:
            return q.get(timeout=0.2)
        except queue.Empty:
            if stop.is_set():
                return None


def _drain_until_end(q, stop):
    """Consume ``q`` up to its END (the feeder stays unblocked after a
    worker's error) or until ``stop`` aborts the stream."""
    while not stop.is_set():
        try:
            item = q.get(timeout=0.2)
        except queue.Empty:
            continue
        if isinstance(item, _End):
            return


def _work(fn, inq, outq, stop, on_error):
    """One worker's loop: apply ``fn`` to each (key, value) of ``inq``
    into ``outq`` until END. A raising ``fn`` puts ``on_error(exc)``, then
    END, and drains its input."""
    while True:
        item = _get_or_stop(inq, stop)
        if item is None:
            return
        if isinstance(item, _End):
            _put_or_stop(outq, END, stop)
            return
        key, value = item
        try:
            out = (key, fn(value))
        except BaseException as e:  # noqa: BLE001 — sent to the consumer
            _put_or_stop(outq, on_error(e), stop)
            _put_or_stop(outq, END, stop)
            _drain_until_end(inq, stop)
            return
        if not _put_or_stop(outq, out, stop):
            return


def _error_in_process(exc):
    # the exception may not pickle: its traceback as text always does
    return _Error(RuntimeError(
        f"process_map worker failed:\n{traceback.format_exc()}"))


def _ordered_map(workers, inqs, outqs, items, stop, alive):
    """Feed ``items`` round-robin to the workers' input queues and yield
    their outputs in the same order. A worker's error ends the stream and
    re-raises here at once; so does a worker that died (``alive``)."""
    n = len(workers)
    feed_error = []

    def feeder():
        try:
            for i, item in enumerate(items):
                if stop.is_set() or not _put_or_stop(inqs[i % n], item, stop):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised below
            feed_error.append(e)
        finally:
            # END always goes out, so that workers drain and the stream
            # ends even when upstream raised
            for q in inqs:
                if not _put_or_stop(q, END, stop):
                    return

    def next_item(k):
        while True:
            try:
                return outqs[k].get(timeout=1.0)
            except queue.Empty:
                if not alive(workers[k]):
                    # a worker killed by a signal never puts its END
                    stop.set()
                    raise RuntimeError(f"map worker {k} died without "
                                       f"finishing its items")

    def gen():
        for w in workers:
            w.start()
        feed = threading.Thread(target=feeder, daemon=True)
        feed.start()
        finished = [False] * n
        i = 0
        try:
            while not all(finished):
                k = i % n
                i += 1
                if finished[k]:
                    continue
                item = next_item(k)
                if isinstance(item, _End):
                    finished[k] = True
                elif isinstance(item, _Error):
                    raise item.exc
                else:
                    yield item
            if feed_error:
                raise feed_error[0]
        finally:
            stop.set()  # unblock the feeder and the workers
            feed.join(timeout=1.0)
            for w in workers:
                w.join(timeout=1.0)
                if hasattr(w, "terminate") and w.is_alive():
                    w.terminate()
                    w.join()

    return gen()


def thread_map(fn, items, n_thread=4, maxsize=2):
    """Apply ``fn`` to the value of each (key, value) item on ``n_thread``
    threads, in the input's order. An exception of ``fn`` ends the stream
    at that item and re-raises in the consumer."""
    if n_thread == 0:
        return ((k, fn(v)) for k, v in items)
    stop = threading.Event()
    inqs = [queue.Queue(maxsize) for _ in range(n_thread)]
    outqs = [queue.Queue(maxsize) for _ in range(n_thread)]
    workers = [threading.Thread(target=_work, daemon=True,
                                args=(fn, iq, oq, stop, _Error))
               for iq, oq in zip(inqs, outqs)]
    return _ordered_map(workers, inqs, outqs, items, stop,
                        alive=lambda w: w.is_alive())


def thread_starmap(fn, items, n_thread=4):
    return thread_map(lambda args: fn(*args), items, n_thread=n_thread)


def thread_itemmap(fn, items, n_thread=4):
    """Apply ``fn`` to each whole (key, value) item, yielding its results
    in order."""
    indexed = ((i, item) for i, item in enumerate(items))
    return (out for _, out in thread_map(
        lambda kv: fn(*kv), indexed, n_thread=n_thread))


def process_map(fn, items, n_proc=4, maxsize=2):
    """``thread_map`` on ``n_proc`` worker processes (spawned: module
    docstring). ``fn`` and the items must pickle; a worker's exception
    re-raises here as a RuntimeError carrying its traceback."""
    if n_proc == 0:
        return ((k, fn(v)) for k, v in items)
    stop = _MP.Event()
    inqs = [_MP.Queue(maxsize) for _ in range(n_proc)]
    outqs = [_MP.Queue(maxsize) for _ in range(n_proc)]
    workers = [_MP.Process(target=_work, daemon=True,
                           args=(fn, iq, oq, stop, _error_in_process))
               for iq, oq in zip(inqs, outqs)]
    return _ordered_map(workers, inqs, outqs, items, stop,
                        alive=lambda p: p.is_alive())


class _item_call:
    """Picklable: ``fn`` over a (key, value) pair."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, kv):
        return self.fn(*kv)


def process_itemmap(fn, items, n_proc=4):
    """``thread_itemmap`` on worker processes; ``fn`` must pickle."""
    indexed = ((i, item) for i, item in enumerate(items))
    return (out for _, out in process_map(_item_call(fn), indexed,
                                          n_proc=n_proc))


def device_stage(compute, batches, depth=2):
    """Keep ``depth`` batches in flight: batch k+1 is enqueued on the
    stream before batch k is fetched, so the card works on the next batch
    while the host waits for the previous one's result. ``compute``
    exposes ``.dispatch`` (enqueue, returns a handle) and ``.fetch``
    (wait for that handle only)."""
    pending = deque()
    t_end = None
    for spans, batch in batches:
        t0 = time.perf_counter()
        gap = (t0 - t_end) if t_end is not None else 0.0
        pending.append((spans, compute.dispatch(batch)))
        t1 = time.perf_counter()
        if len(pending) >= depth:
            spans_done, handle = pending.popleft()
            out = compute.fetch(handle)
            t_end = time.perf_counter()
            batch_timing(t1 - t0, t_end - t1, gap)
            yield spans_done, out
        else:
            t_end = time.perf_counter()
            batch_timing(t1 - t0, 0.0, gap)
    while pending:
        t1 = time.perf_counter()
        spans_done, handle = pending.popleft()
        out = compute.fetch(handle)
        batch_timing(0.0, time.perf_counter() - t1, 0.0)
        yield spans_done, out
