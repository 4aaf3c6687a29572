"""The port's phase attribution (`obs/attrib/`), `--trace-dir`,
`--attribution`, `--telemetry-mfu`, the SIGUSR1 window and `obs
--selfcheck`, against the JAX package's.

* The bucketers: `phase_of` and `op_class_of` give JAX's answers on the
  names both packages meet (HLO names, and the segment rule), and the
  card's and aten's names land in their classes.
* The arithmetic: the same seeded `OpEvent` lists go through the JAX
  `attribute_trace` (its `xplane.load_xspace`/`op_events` patched to
  hand them over) and the port's `attribute_events`; the dicts are equal
  to 1e-12.
* The trace: a synthetic Kineto trace shows the join by time (a kernel
  launched from the autograd engine's device thread, outside every range
  of that thread, takes the dispatching thread's range; a kernel whose
  launch is missing takes its stream's last scope) and the CPU's
  outermost ops; the size cap (`BMT_XPLANE_MAX_MB`) and a missing
  capture raise.
* The driver on `tests/test_attrib.py`'s line (simples-full, Median, 24
  steps, chunks of 8, a sample every 4): `attribution.json` with 8 steps,
  phases tiling `total_ms` to 1e-9, `honest` and `gar` above 0, `attack`
  0, the phase sum within 15% of the `device_step_ms` gauge of the traced
  chunk (step 16), the `attribution` event and the report's section;
  with the flag off no artifact; without a result directory a warning.
* SIGUSR1 on a live subprocess: `profile-<step>/` holds a trace, the
  `profiler_window` event spans the chunk, the window is attributed;
  then SIGTERM ends the bounded run with exit 130 and status
  `interrupted`.
* `--trace-dir` writes a trace with the engine's ranges and the
  `profiler_trace_start`/`_stop` events.
* `--telemetry-mfu` on the CPU: `flops_per_step` equals the analytic
  count of simples-full's dense FLOPs (forward, weight gradients, the
  second layer's input gradient); against the JAX driver's
  `flops_per_step` (XLA's cost analysis, every operation) on the same
  line it reads 0.5371 (held within 0.02); no `mfu` gauge (the CPU has
  no peak); the CSVs byte-equal with the flags on and off.
* `python -m byzantinemomentum_tpu_torch.obs --selfcheck --device cpu`
  exits 0 and prints its `attribution:` line.
"""

import json
import os
import pathlib
import random
import signal
import subprocess
import sys
import time

import pytest

from byzantinemomentum_tpu.obs.attrib import attribution as jax_attribution
from byzantinemomentum_tpu.obs.attrib import phases as jax_phases
from byzantinemomentum_tpu.obs.attrib import xplane as jax_xplane
from byzantinemomentum_tpu_torch import obs
from byzantinemomentum_tpu_torch.cli import attack as driver
from byzantinemomentum_tpu_torch.obs import attrib
from byzantinemomentum_tpu_torch.obs.attrib import kineto, phases
from byzantinemomentum_tpu_torch.obs.report import render_report

from tests.test_attrib import DRIVER_BASE
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
# Subprocesses: the small synthetic splits, one torch thread
ENV = {**os.environ, "BMT_SYNTH_TRAIN": "512", "BMT_SYNTH_TEST": "128",
       "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}
PORT = ["--device", "cpu", *DRIVER_BASE]


@pytest.fixture(autouse=True)
def small_synth(monkeypatch):
    monkeypatch.setenv("BMT_SYNTH_TRAIN", "512")
    monkeypatch.setenv("BMT_SYNTH_TEST", "128")


# --------------------------------------------------------------------------- #
# The bucketers

SHARED_SCOPES = ("jit(f)/jit(main)/honest/dot_general",
                 "jit(f)/while/body/gar/jit(sort)/sort",
                 "jit(f)/gar_masked/reduce", "jit(f)/gar_diag/scores",
                 "jit(f)/attack/probe/gar/krum", "jit(f)/gargle/add",
                 "jit(f)/transpose/relayout", "update", "metrics/honest",
                 "attack/gar", "", None)
SHARED_NAMES = ("dot.7", "convolution.12", "loop_convolution_fusion",
                "copy.3", "reshape.1", "transpose", "bitcast.2",
                "broadcast_add_fusion", "reduce-window", "sort.0",
                "cudnn-conv", "gemm_fusion", "add.4")


@pytest.mark.parametrize("scope", SHARED_SCOPES)
def test_phase_of_matches_jax(scope):
    assert phases.phase_of(scope) == jax_phases.phase_of(scope)


@pytest.mark.parametrize("name", SHARED_NAMES)
def test_op_class_of_matches_jax(name):
    assert phases.op_class_of(name) == jax_phases.op_class_of(name)


@pytest.mark.parametrize("name, cls", [
    ("sm90_xmma_gemm_f32f32_tf32f32_f32_nt_n_tilesize128x128x32", "mxu"),
    ("void cutlass::Kernel2<cutlass_80_simt_sgemm_128x128_8x4_nn_align1>",
     "mxu"),
    ("sm80_xmma_fprop_implicit_gemm_indexed_f32f32", "mxu"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<float>", "mxu"),
    ("ampere_sgemm_128x64_nn", "mxu"),
    ("Memcpy HtoD (Pageable -> Device)", "relayout"),
    ("Memset (Device)", "memory"),
    ("void at::native::elementwise_kernel<128, 2, at::native::"
     "gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda>>",
     "relayout"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>>", "memory"),
    ("sq_gram_kernel", "memory"), ("selected_median_mean_kernel", "memory"),
    ("aten::mm", "mxu"), ("aten::addmm", "mxu"), ("aten::convolution", "mxu"),
    ("aten::convolution_backward", "mxu"), ("aten::copy_", "relayout"),
    ("aten::reshape", "relayout"), ("aten::transpose", "relayout"),
    ("aten::contiguous", "relayout"), ("aten::clone", "relayout"),
    ("aten::add", "memory"), ("aten::mean", "memory"),
    ("autograd::engine::evaluate_function: AddmmBackward0", "mxu"),
])
def test_op_class_of_card_and_aten_names(name, cls):
    assert phases.op_class_of(name) == cls


# --------------------------------------------------------------------------- #
# The arithmetic, against the JAX function on the same events

NAMES = ("dot.7", "convolution.3", "copy.1", "transpose", "add.2",
         "sort.0", "fusion.9")
SCOPES = ("honest", "attack", "attack/gar", "gar", "gar_masked",
          "gar_diag", "update", "metrics", "honest/metrics", None)


def seeded_events(seed, count=300):
    """OpEvents with overlapping intervals, gaps and every scope."""
    rng = random.Random(seed)
    events, t = [], 0
    for _ in range(count):
        t += rng.choice((0, 0, 1, 5, 40)) * 1000 * rng.randint(1, 9)
        dur = rng.randint(1, 90) * 10_000
        events.append(kineto.OpEvent(rng.choice(NAMES), dur / 1e9,
                                     scope=rng.choice(SCOPES), start_ps=t,
                                     end_ps=t + dur))
        t += rng.randint(-dur, dur)  # overlap the next one, or not
    return events


def assert_close(got, want, tol=1e-12, path="att"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for key in want:
            assert_close(got[key], want[key], tol, f"{path}.{key}")
    elif isinstance(want, float):
        assert abs(got - want) <= tol * max(1.0, abs(want)), (path, got, want)
    else:
        assert got == want, (path, got, want)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("flops, peak", [(None, None), (2.5e9, 1e12)])
def test_attribution_arithmetic_matches_jax(seed, flops, peak, monkeypatch):
    events = seeded_events(seed)
    monkeypatch.setattr(jax_xplane, "load_xspace", lambda _: object())
    monkeypatch.setattr(jax_xplane, "op_events",
                        lambda space, planes=None: events)
    want = jax_attribution.attribute_trace(
        "unused", 3, flops_per_step=flops, peak_flops=peak, backend="cpu",
        device_kind="cpu")
    got = attrib.attribute_events(events, 3, flops_per_step=flops,
                                  peak_flops=peak, backend="cpu",
                                  device_kind="cpu")
    assert_close(got, want)
    total = sum(p["ms"] for p in got["phases"].values())
    assert total == pytest.approx(got["total_ms"], rel=1e-12)


# --------------------------------------------------------------------------- #
# The trace: the join by time, the CPU's outermost ops, the cap

def _x(cat, name, ts, dur, tid, corr=None, pid=1):
    event = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "tid": tid, "pid": pid}
    if corr is not None:
        event["args"] = {"correlation": corr}
    return event


def test_kernels_join_the_dispatching_threads_ranges():
    """A kernel launched by the autograd engine's device thread (tid 2,
    which opened no range) takes the range of the dispatching thread
    (tid 1) that holds its launch; a kernel with no launch in the trace
    takes the scope of the kernel before it on its stream."""
    trace = {"traceEvents": [
        _x("user_annotation", "honest", 0, 100, 1),
        _x("user_annotation", "attack", 200, 100, 1),
        _x("user_annotation", "gar", 220, 30, 1),
        _x("user_annotation", "ProfilerStep#3", 0, 400, 1),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 2, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 50, 2, 2, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 230, 2, 1, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 350, 2, 1, corr=4),
        _x("kernel", "sm90_xmma_fprop", 15, 20, 7, corr=1, pid=0),
        _x("kernel", "sm80_xmma_wgrad", 60, 30, 7, corr=2, pid=0),
        _x("kernel", "sq_gram_kernel", 240, 5, 7, corr=3, pid=0),
        _x("gpu_memcpy", "Memcpy DtoD", 246, 1, 7, corr=99, pid=0),
        _x("kernel", "elementwise", 360, 4, 7, corr=4, pid=0),
        _x("cpu_op", "aten::mm", 12, 1, 1),
    ]}
    events = kineto.op_events(trace)
    assert [(e.name, e.scope) for e in events] == [
        ("sm90_xmma_fprop", "honest"), ("sm80_xmma_wgrad", "honest"),
        ("sq_gram_kernel", "attack/gar"), ("Memcpy DtoD", "attack/gar"),
        ("elementwise", None)]
    assert events[1].dur_ms == pytest.approx(0.030)
    assert events[1].start_ps == 60_000_000
    att = attrib.attribute_events(events, 1)
    assert att["phases"]["attack"]["ops"] == 2  # outermost wins
    assert att["phases"]["other"]["ops"] == 1


def test_cpu_trace_takes_outermost_ops():
    trace = {"traceEvents": [
        _x("user_annotation", "update", 0, 100, 1),
        _x("cpu_op", "aten::add", 5, 20, 1),
        _x("cpu_op", "aten::empty", 6, 2, 1),       # inside aten::add
        _x("cpu_op", "aten::copy_", 40, 10, 1),
        _x("cpu_op", "aten::mul", 150, 10, 1),      # outside the range
    ]}
    events = kineto.op_events(trace)
    assert [(e.name, e.scope) for e in events] == [
        ("aten::add", "update"), ("aten::copy_", "update"),
        ("aten::mul", None)]
    assert kineto.aggregate_ops(trace)["aten::add"] == (pytest.approx(0.02),
                                                        1)
    assert kineto.window_span(events) == (pytest.approx(0.04),
                                          pytest.approx(0.155))


def test_load_trace_missing_capture(tmp_path):
    with pytest.raises(FileNotFoundError):
        kineto.load_trace(tmp_path)
    assert kineto.find_trace(tmp_path) is None


def test_load_trace_size_cap(tmp_path, monkeypatch):
    """A capture past the size cap is refused instead of stalling the
    run; the cap is the JAX package's knob."""
    fat = tmp_path / "host_1.1.pt.trace.json"
    fat.write_text(json.dumps({"traceEvents": []}) + " " * 4096)
    assert kineto.find_trace(tmp_path) == fat
    assert kineto.load_trace(tmp_path) == {"traceEvents": []}
    monkeypatch.setenv("BMT_XPLANE_MAX_MB", "0.001")
    with pytest.raises(ValueError, match="cap"):
        kineto.load_trace(tmp_path)
    monkeypatch.delenv("BMT_XPLANE_MAX_MB")
    (tmp_path / "host_1.2.pt.trace.json").write_text("{torn")
    with pytest.raises(ValueError, match="parse"):
        kineto.load_trace(tmp_path)


# --------------------------------------------------------------------------- #
# The driver: the --attribution window on tests/test_attrib.py's line

@pytest.fixture(scope="module")
def attributed_run(tmp_path_factory):
    """The port's driver with --attribution --telemetry-mfu, and without
    the flags, on the JAX acceptance line (24 steps)."""
    base = tmp_path_factory.mktemp("attrib")
    os.environ.update(BMT_SYNTH_TRAIN="512", BMT_SYNTH_TEST="128")
    runs = {}
    for name, flags in (("on", ["--attribution", "--telemetry-mfu"]),
                        ("off", [])):
        resdir = base / name
        rc = driver.main(PORT + ["--nb-steps", "24", *flags,
                                 "--result-directory", str(resdir)])
        assert rc == 0
        runs[name] = resdir
    return runs


def test_driver_attribution_acceptance(attributed_run):
    resdir = attributed_run["on"]
    att = attrib.load_attribution(resdir)
    assert att is not None, "attribution.json was not written"
    assert att["steps"] == 8  # one --steps-per-program chunk
    phase_sum = sum(p["ms"] for p in att["phases"].values())
    assert phase_sum == pytest.approx(att["total_ms"], rel=1e-9)
    assert att["phases"]["honest"]["ms"] > 0.0
    assert att["phases"]["gar"]["ms"] > 0.0
    assert att["phases"]["attack"]["ms"] == 0.0  # no attack rows here
    assert att["backend"] == "cpu" and att["device_kind"] == "cpu"

    records = obs.load_records(resdir)
    events = [r for r in records if r["kind"] == "event"
              and r["name"] == "attribution"]
    assert len(events) == 1
    assert events[0]["data"]["steps"] == 8
    assert events[0]["data"]["total_ms"] == pytest.approx(att["total_ms"])
    # The traced chunk (steps 8-16: the first chunk of M = 8 ran first)
    # has a forced device_step_ms sample; the phase sum lands within 15%
    gauges = [r["value"] for r in records if r["kind"] == "gauge"
              and r["name"] == "device_step_ms"
              and (r.get("data") or {}).get("step") == 16]
    assert gauges, "no device_step_ms sample on the traced chunk"
    assert phase_sum == pytest.approx(gauges[-1], rel=0.15)
    assert "perf attribution" in render_report(resdir)
    # The window directory keeps the raw capture
    assert kineto.find_trace(resdir / "attribution-trace") is not None


def test_driver_attribution_off_leaves_no_artifacts(attributed_run):
    resdir = attributed_run["off"]
    assert attrib.load_attribution(resdir) is None
    assert not (resdir / "attribution-trace").exists()
    assert not list(resdir.glob("profile-*"))
    names = {r["name"] for r in obs.load_records(resdir)}
    assert not names & {"attribution", "flops_per_step", "mfu",
                        "profiler_window", "profiler_trace_start"}


def test_driver_flags_leave_the_csvs_unchanged(attributed_run):
    on, off = attributed_run["on"], attributed_run["off"]
    assert (on / "study").read_bytes() == (off / "study").read_bytes()
    assert ((on / "study").read_text().count(os.linesep)) == 24


def test_driver_attribution_requires_result_directory(capsys):
    assert driver.main(PORT + ["--nb-steps", "0", "--attribution"]) == 0
    assert "'--attribution' needs '--result-directory'" in (
        capsys.readouterr().err)


# --------------------------------------------------------------------------- #
# --telemetry-mfu

@pytest.fixture(scope="module")
def jax_flops_per_step(tmp_path_factory):
    """The JAX driver's `flops_per_step` on the same line (XLA's cost
    analysis of the step program)."""
    from byzantinemomentum_tpu import obs as jax_obs
    from byzantinemomentum_tpu.cli.attack import main as jax_main

    resdir = tmp_path_factory.mktemp("jax_mfu") / "run"
    os.environ.update(BMT_SYNTH_TRAIN="512", BMT_SYNTH_TEST="128")
    assert jax_main(DRIVER_BASE + ["--nb-steps", "8", "--telemetry-mfu",
                                   "--result-directory", str(resdir)]) == 0
    return [r["data"]["flops"] for r in jax_obs.load_records(resdir)
            if r["name"] == "flops_per_step"][0]


def test_telemetry_mfu_counts_the_dense_flops(attributed_run,
                                              jax_flops_per_step):
    records = obs.load_records(attributed_run["on"])
    flops = [r["data"]["flops"] for r in records
             if r["name"] == "flops_per_step"]
    # simples-full (784-100-10) at S = 11 workers of B = 8: forward and
    # weight gradients of both layers, the input gradient of the second
    S, B = 11, 8
    layers = ((784, 100), (100, 10))
    dense = sum(2 * S * B * i * o for i, o in layers)
    assert flops == [2 * dense + 2 * S * B * 100 * 10]
    # XLA counts every operation of the step, the GEMMs about half of it
    assert flops[0] / jax_flops_per_step == pytest.approx(0.5371, abs=0.02)
    # The CPU has no peak: no MFU gauge, as in the JAX driver
    assert not [r for r in records if r["name"] == "mfu"]
    assert obs.peak_flops("cpu") is None
    assert obs.peak_flops("NVIDIA H100 80GB HBM3") == 989.4e12
    assert obs.mfu(1e9, 10.0, 1e12) == pytest.approx(0.01)


@pytest.mark.parametrize("groups", [1, 4])
def test_logical_flops_counts_grouped_convolution_gradients(groups):
    """Each gradient of a convolution costs one forward convolution, at
    any `groups` (the grouped honest phase's `groups=S`): torch's own
    formula counts a grouped weight gradient `groups` times over."""
    import torch

    B, cin, cout, H = 3, 5, 6, 8
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(B, groups * cin, H, H, generator=gen, requires_grad=True)
    w = torch.randn(groups * cout, cin, 3, 3, generator=gen,
                    requires_grad=True)

    def step(*wrt):
        y = torch.nn.functional.conv2d(x, w, padding=1, groups=groups)
        return torch.autograd.grad(y.sum(), wrt)

    forward = 2 * B * groups * cout * cin * 9 * H * H
    (gx, gw), flops = obs.logical_flops(step, x, w)
    assert flops == 3 * forward
    assert torch.equal(gw, step(x, w)[1])  # the count changes nothing
    assert obs.logical_flops(step, w)[1] == 2 * forward


# --------------------------------------------------------------------------- #
# --trace-dir

def test_trace_dir_covers_the_run(tmp_path):
    trace_dir, resdir = tmp_path / "trace", tmp_path / "run"
    assert driver.main(PORT + ["--nb-steps", "8", "--trace-dir",
                               str(trace_dir), "--result-directory",
                               str(resdir)]) == 0
    events = kineto.op_events(kineto.load_trace(trace_dir))
    scopes = {phases.phase_of(e.scope) for e in events}
    assert {"honest", "gar", "update", "metrics"} <= scopes
    names = [r["name"] for r in obs.load_records(resdir)
             if r["kind"] == "event"]
    assert names.index("profiler_trace_start") < names.index(
        "profiler_trace_stop") < names.index("run_end")


# --------------------------------------------------------------------------- #
# SIGUSR1, then SIGTERM, on a live subprocess

def _wait_for(predicate, proc, what, timeout=240.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        if proc.poll() is not None:
            break
        time.sleep(0.1)
    proc.kill()
    pytest.fail(f"{what} never came:\n{proc.communicate()[0]}")


def _events(resdir, name):
    return [r for r in obs.load_records(resdir)
            if r["kind"] == "event" and r["name"] == name]


def test_sigusr1_window_then_sigterm_subprocess(tmp_path):
    if not hasattr(signal, "SIGUSR1"):
        pytest.skip("platform without SIGUSR1")
    resdir = tmp_path / "live"
    proc = subprocess.Popen(
        [sys.executable, "-m", "byzantinemomentum_tpu_torch", *PORT,
         "--nb-steps", "100000", "--steps-per-program", "4",
         "--result-directory", str(resdir)],
        cwd=ROOT, env=ENV, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        _wait_for(lambda: obs.read_heartbeat(resdir) is not None, proc,
                  "the first heartbeat")
        proc.send_signal(signal.SIGUSR1)
        _wait_for(lambda: _events(resdir, "attribution"), proc,
                  "the SIGUSR1 window's attribution")
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 130, out  # a bounded run cut short
    windows = sorted(resdir.glob("profile-*"))
    assert len(windows) == 1, out
    assert kineto.find_trace(windows[0]) is not None
    event = _events(resdir, "profiler_window")[0]["data"]
    assert event["directory"] == str(windows[0])
    assert event["to_step"] == event["from_step"] + 4
    assert windows[0].name == f"profile-{event['from_step']}"
    att = attrib.load_attribution(windows[0])
    assert att is not None and att["total_ms"] > 0.0
    assert att["steps"] == 4 and att["phases"]["honest"]["ms"] > 0.0
    end = _events(resdir, "run_end")[-1]["data"]
    assert end["status"] == "interrupted"
    assert obs.read_heartbeat(resdir)["status"] == "interrupted"


# --------------------------------------------------------------------------- #
# obs --selfcheck

def test_obs_selfcheck_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "byzantinemomentum_tpu_torch.obs",
         "--selfcheck", "--device", "cpu"],
        cwd=ROOT, env=ENV, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith("attribution: ")]
    assert len(lines) == 1
    data = json.loads(lines[0][len("attribution: "):])
    assert data["backend"] == "cpu" and data["steps"] == 4
    assert {"honest", "gar", "update"} <= set(data["phases_ms"])
    assert "obs selfcheck: OK" in proc.stdout
