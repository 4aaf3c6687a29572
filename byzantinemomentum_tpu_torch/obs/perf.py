"""Live performance measurement (`byzantinemomentum_tpu/obs/perf.py`):
sliding-window throughput, a chunk's device time, host RSS.

The JAX module's `StepTimer` drains the dispatch pipeline before and
after the chunk it times (a device-to-host barrier each side). The
port's times the chunk with two CUDA events recorded around its
dispatch and reads them once the next chunk is queued, so a telemetry
sample stalls nothing; on the CPU, where a chunk runs as it is issued,
it takes the host's clock. The JAX module's `peak_flops`, `mfu`,
`flops_of_compiled` and `logical_flops` serve `--telemetry-mfu`, which
the port does not have yet (`ROADMAP.md` section 1 item 4).
"""

import collections
import time

__all__ = ["SlidingRate", "StepTimer", "host_rss_mb"]


class SlidingRate:
    """Steps/s over a sliding wall-clock window: fed `(time, step)` at
    every dispatch (no device sync), read at the telemetry samples."""

    def __init__(self, window_s=30.0):
        self.window_s = float(window_s)
        self._points = collections.deque()

    def update(self, steps, now=None):
        now = time.monotonic() if now is None else now
        self._points.append((now, int(steps)))
        floor = now - self.window_s
        while len(self._points) > 2 and self._points[0][0] < floor:
            self._points.popleft()

    def rate(self):
        """Current steps/s, or None before two points span the window."""
        if len(self._points) < 2:
            return None
        (t0, s0), (t1, s1) = self._points[0], self._points[-1]
        if t1 <= t0:
            return None
        return (s1 - s0) / (t1 - t0)


class StepTimer:
    """The device time of a dispatched chunk, between two marks.

    Usage per measured chunk:
        begin = timer.mark()          # before the dispatch
        ... dispatch the chunk ...
        end = timer.mark()            # once it is queued
        ... queue the next chunk ...
        seconds = timer.seconds(begin, end)  # waits for the chunk only
    """

    def __init__(self, device):
        self._device = device
        self.total = 0.0

    def mark(self):
        """A CUDA event recorded on the device's current stream, or on the
        CPU the host's clock."""
        if self._device.type != "cuda":
            return time.perf_counter()
        import torch
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(self._device))
        return event

    def seconds(self, begin, end):
        """Seconds between two marks on the device's clock, once the work
        queued before `end` is done; added to `total`."""
        if isinstance(end, float):
            seconds = end - begin
        else:
            end.synchronize()
            seconds = begin.elapsed_time(end) / 1e3
        self.total += seconds
        return seconds


def host_rss_mb():
    """This process's resident set in MiB (Linux `/proc`, else
    `resource`), or None where neither is readable."""
    try:
        with open("/proc/self/status", encoding="ascii") as fd:
            for line in fd:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0  # kB -> MiB
    except OSError:
        pass
    try:
        import resource
        rss_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return float(rss_kb) / 1024.0
    except (ImportError, AttributeError, OSError, ValueError):
        return None
