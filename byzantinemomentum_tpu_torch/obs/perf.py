"""Live performance measurement (`byzantinemomentum_tpu/obs/perf.py`):
sliding-window throughput, a chunk's device time, host RSS, and the
FLOP/MFU helpers of `--telemetry-mfu`.

The JAX module's `StepTimer` drains the dispatch pipeline before and
after the chunk it times (a device-to-host barrier each side). The
port's times the chunk with two CUDA events recorded around its
dispatch and reads them once the next chunk is queued, so a telemetry
sample stalls nothing; on the CPU, where a chunk runs as it is issued,
it takes the host's clock.

`peak_flops`, `mfu` and `logical_flops` serve `--telemetry-mfu` as the
JAX module's do. `logical_flops` counts what one chunk of the run itself
does, with `torch.utils.flop_counter.FlopCounterMode`, where the JAX
module compiles a throwaway copy of the step program and reads XLA's
cost analysis (its `flops_of_compiled` has no counterpart: the port
compiles no step program). The count covers the GEMMs and convolutions,
forward and backward; the hand-written kernels are invisible to it, as
Pallas custom calls without a cost estimate are to `cost_analysis`.
"""

import collections
import time

__all__ = ["SlidingRate", "StepTimer", "host_rss_mb", "peak_flops", "mfu",
           "logical_flops", "PEAK_BF16_FLOPS", "H100_PEAKS", "h100_part",
           "card_peaks"]


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


# --------------------------------------------------------------------------- #
# FLOPs and MFU

# The published peaks of each H100 part (NVIDIA's data sheets; dense
# rates, the sheets quote twice the tensor-core ones with sparsity):
# memory bytes/s, f32 FLOP/s outside the tensor cores, bf16 tensor-core
# FLOP/s. The SXM part reports itself as "NVIDIA H100 80GB HBM3".
# `chip_smoke.py` takes its bounds from this table. MFU is quoted against
# the bf16 peak for every mode, as in the JAX package: an f32 step (TF32
# is off, `engine/step.py::pin_precision`) runs outside the tensor cores
# at 67 TFLOP/s at most, so it reads below 67 / 989.4, about 6.8%.
H100_PEAKS = {"pcie": (2.0e12, 51e12, 756e12), "nvl": (3.9e12, 60e12, 835e12),
              "sxm": (3.35e12, 67e12, 989.4e12)}
PEAK_BF16_FLOPS = {part: peaks[2] for part, peaks in H100_PEAKS.items()}


def h100_part(device_name):
    """The H100 part a `torch.cuda.get_device_name` string names
    ("pcie", "nvl" or "sxm"), or None for another device."""
    name = str(device_name).lower()
    if "h100" not in name:
        return None
    for part in ("pcie", "nvl"):
        if part in name:
            return part
    return "sxm"


def card_peaks(device_name):
    """(memory bytes/s, f32 FLOP/s) of the card, the SXM part's where the
    name is no H100's (the bounds of `chip_smoke.py`)."""
    return H100_PEAKS[h100_part(device_name) or "sxm"][:2]


def peak_flops(device_name):
    """Peak bf16 FLOP/s for a `torch.cuda.get_device_name` string (None
    for a card not in the table, and for the CPU, where MFU is not a
    meaningful quote)."""
    part = h100_part(device_name)
    return None if part is None else PEAK_BF16_FLOPS[part]


def mfu(flops_per_step, steps_per_sec, peak):
    """Model FLOPs utilization in [0, 1] (None when any input is unknown)."""
    if not flops_per_step or not steps_per_sec or not peak:
        return None
    return float(flops_per_step) * float(steps_per_sec) / float(peak)


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                         _padding, _dilation, transposed, _output_padding,
                         _groups, output_mask, out_shape=None):
    """FLOPs of `aten.convolution_backward`: each gradient asked for
    (input, weight) costs one forward convolution. `FlopCounterMode`'s own
    formula counts a grouped convolution's weight gradient `groups` times
    over (its transposed-shape trick drops the groups), and the grouped
    honest phase's convolutions have `groups=S`."""
    from torch.utils.flop_counter import conv_flop_count

    forward = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return forward * (int(bool(output_mask[0])) + int(bool(output_mask[1])))


def logical_flops(fn, *args, **kwargs):
    """`(fn(*args, **kwargs), FLOPs)`: the call, run under
    `FlopCounterMode` (with `_conv_backward_flops` for the convolutions'
    gradients), and the FLOPs it counted (the GEMMs and convolutions,
    forward and backward; None where it counted none). The mode only
    counts: the call computes and launches what it does without it.
    Where the counting fails, the call runs again without it and the
    count is None: FLOP counting is an estimate, never worth a run."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flops})
    try:
        with counter:
            result = fn(*args, **kwargs)
    except (RuntimeError, TypeError, ValueError, NotImplementedError):
        return fn(*args, **kwargs), None
    return result, float(counter.get_total_flops()) or None
