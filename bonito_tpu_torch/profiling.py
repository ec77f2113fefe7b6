"""
Pipeline observability. With BONITO_TPU_PROFILE=1 each basecall stage is
wrapped in a timer that records, per stage: items seen, time blocked on
the upstream stage (up-wait), time suspended at the yield because the
consumer was busy (down-wait), and the rate while not upstream-blocked.
The bottleneck is the stage whose up-wait and down-wait are both small.
BONITO_TPU_PROFILE=2 also prints every device-stage cycle.
"""

import atexit
import os
import sys
import time

_REPORTS = []
_BATCHES = []


def enabled():
    return os.environ.get("BONITO_TPU_PROFILE", "") not in ("", "0")


class StageStats:
    def __init__(self, name):
        self.name = name
        self.items = 0
        self.wait_s = 0.0
        self.down_s = 0.0
        self.first = None
        self.last = None

    def row(self):
        span = (self.last - self.first) if self.items else 0.0
        active = max(span - self.wait_s, 0.0)
        rate = self.items / active if active > 0 else 0.0
        return (f"  {self.name:<12} items={self.items:<7} "
                f"up-wait={self.wait_s:7.2f}s  "
                f"down-wait={self.down_s:7.2f}s  "
                f"rate={rate:8.1f}/s")


def instrument(name, iterable):
    """Wrap a pipeline stage; no-op unless profiling is enabled."""
    if not enabled():
        return iterable
    stats = StageStats(name)
    _REPORTS.append(stats)

    def gen():
        it = iter(iterable)
        while True:
            t0 = time.perf_counter()
            if stats.first is None:
                stats.first = t0
            try:
                item = next(it)
            except StopIteration:
                return
            now = time.perf_counter()
            stats.wait_s += now - t0
            stats.last = now
            stats.items += 1
            yield item
            stats.down_s += time.perf_counter() - now

    return gen()


def batch_timing(dispatch_s, fetch_s, gap_s=0.0):
    """Record one device-stage cycle: the host time to enqueue a batch,
    to fetch the previous one, and the wait for input before it."""
    if not enabled():
        return
    _BATCHES.append((dispatch_s, fetch_s, gap_s))
    if os.environ.get("BONITO_TPU_PROFILE") == "2":
        sys.stderr.write(f"  [batch {len(_BATCHES):3d}] "
                         f"dispatch={dispatch_s*1e3:7.1f} ms  "
                         f"fetch={fetch_s*1e3:7.1f} ms  "
                         f"gap={gap_s*1e3:7.1f} ms\n")


def report(reset=False):
    """The report's lines: the device stage's steady medians and each
    stage's row. ``reset`` forgets what was recorded, so that the next
    run reports alone."""
    lines = []
    if _BATCHES:
        import statistics
        tail = _BATCHES[max(2, len(_BATCHES) // 4):] or _BATCHES
        d = statistics.median(t[0] for t in tail)
        f = statistics.median(t[1] for t in tail)
        g = statistics.median(t[2] for t in tail)
        lines.append(f"> device stage: {len(_BATCHES)} batches, steady median "
                     f"dispatch={d*1e3:.1f} ms fetch={f*1e3:.1f} ms "
                     f"gap={g*1e3:.1f} ms")
    if _REPORTS:
        lines.append("> pipeline stage profile (rate = items per "
                     "non-upstream-blocked second):")
        lines += [s.row() for s in _REPORTS]
    if reset:
        _REPORTS.clear()
        _BATCHES.clear()
    return lines


def _report():
    for line in report():
        sys.stderr.write(line + "\n")


atexit.register(_report)
