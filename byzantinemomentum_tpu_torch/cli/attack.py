"""The experiment driver (`byzantinemomentum_tpu/cli/attack.py`, the flags
of the training path ported so far).

Flags keep the JAX driver's names and defaults, except `--device`, which
defaults to `cuda`: `--device cpu` is the only way onto the CPU, and with
no card and no such request the driver exits with an error. Flags of the
JAX driver that the port does not have yet (`--mesh`, `--download`) are
refused by the parser rather than ignored.

The defense is `--gar` or a `--gars 'name[,freq[,json-args]];...'`
mixture (the JAX `_parse_gars`, with its messages), drawn once a step
from the step's mixture key, which the host mirrors so that only the
drawn member runs and nothing is read (the mirror is compared with the
device's key at each chunk's end), or with `--gars-per-call` at every
defense call on the device (`engine/step.py`). `--optimizer` takes
every name of the JAX registry (`optim.py`) with `--optimizer-args`;
`--init-multi`/`--init-mono` (with their `-args`) re-draw the model's
parameters under `fold_in(root key, 2)` (`models/core.py::
apply_named_init`); `--user-input-delta N` ends a chunk every N steps
and opens `code.interact` with `state` and `engine` (with stdin closed
it returns at once, and the run writes what it writes without the
flag).

Fused dispatch, as in the JAX driver: `--steps-per-program M` (default
8) runs up to M steps a dispatch (`Engine.train_multi_indexed`), each
chunk ending at the next evaluation, checkpoint or `--nb-steps` limit; a
chunk's batches are one draw of its M * S * k batches (so on a flipped
split they depend on M where an epoch ends inside a chunk, as in the
JAX driver), its learning rates are worked out per step from the
schedule (an f32 array, `jnp.asarray(lrs, jnp.float32)`), and nothing of
a step is read on the host: the driver keeps its own step and point
counters, and a chunk's study rows reach the host in one transfer once
the next chunk is queued. `--device-gar <device>` places the defense
phase (the attack with its line search, the GAR, the influence) on
another device, the honest rows hopping there and the results back every
step (`engine/program.py::device_gar_step`); it forces
`--steps-per-program 1`, as the JAX driver does.

`--seed` gives the JAX run: the root key is `PRNGKey(seed)`, the model's
weights come from `model.init(root key)` and the engine's step key from
`fold_in(root key, 1)`, so the initial parameters, every step's keys and
dropout masks, and the batches (`data/device.py`) are the JAX driver's.

Checkpoints (`checkpoint.py`, the JAX file format): `--checkpoint-delta`
saves the state and the samplers' snapshots every that many steps into
the result directory (`--keep-checkpoints` keeps the newest N,
`--checkpoint-mirror` writes a second copy); `--load-checkpoint` resumes
from a file; `--auto-resume` restarts from the newest valid checkpoint
of the result directory (or its mirror), keeps the CSV rows below the
resume step, counts `--nb-steps` from step 0 and appends the JAX
driver's `Rollbacks` and `Restarts` columns to the study CSV, so a
killed and resumed run writes the uninterrupted run's rows.
`BMT_CHAOS_KILL_AT_STEP=<step>` SIGKILLs the run when it reaches that
step (the preemption stand-in of the kill-and-resume checks).

Every attack of the JAX registry runs, with the JAX defaults: `--attack
empire` with no `--attack-args` is `factor:-16`, a line search of 16
evaluations of the configured GAR a step (`ops/linesearch.py`); a
stateful attack (`alie-warmup`) carries its history in the engine's
state from step to step.

`--nb-local-steps k` has each worker take k local SGD steps on k batches
a step and submit its displacement over the learning rate, as the JAX
engine does (the honest phase is then the vmapped one).

Batches come from the device-resident splits (`data/device.py`), as in
the JAX driver without `--mesh` (a flag the port does not have). Under
`--device-gar` the JAX driver samples on the host (`Dataset.sample`,
each batch's indices, then its flips); the port draws the indices and
flips in that order (`DeviceData.sample_batches`) and gathers them on
the device. The honest phase is the grouped program unless
`--no-grouped-workers`.

`--gar-diagnostics` (with `--result-directory` and `--nb-for-study`;
without them the JAX warning disables it) runs the outer aggregation
through the GAR's diagnose form and appends the JAX driver's
`FORENSIC_COLUMNS` to the study CSV, after the recovery columns: the
selected workers (';'-joined, '-' for none), the honest-vs-all median
distance, the variance-to-norm ratio, the clip fraction and the largest
suspicion of `obs/forensics.py::SuspicionTracker`, which the host folds
step by step from the selection and worker-distance vectors. Those
vectors reach the host in the chunk's one transfer of its study rows.
The tracker is not checkpointed (nor is the JAX driver's): a resumed run
starts it from zero.

`--fault-plan plan.json` (a `faults.FaultPlan`) injects the plan's
system faults into each step's honest rows before the aggregation, which
then runs the dynamic quorum with NaN-quarantine as the plan's policy
says (`engine/step.py`); a plan that does not fit the run is refused
with the JAX messages, a plan with no events attaches nothing (the
fault-free run, byte for byte). The study CSV gains the JAX driver's
`FAULT_COLUMNS` after the 24 study columns, the three integers moved in
the chunk's one transfer, and under `--gar-diagnostics` the suspicion
tracker sees the quarantined rows (`Active mask`). The plan's `fetch_*`
policy fields parameterize the JAX package's downloads; the port
downloads nothing and sets no `BMT_FETCH_*` variable.

Telemetry, as in the JAX driver, is on whenever there is a result
directory (`--no-telemetry` turns it off; `--telemetry` only says so):
`telemetry.jsonl` (`obs/recorder.py`) gets `run_start`, `data_setup`,
`restart` after an auto-resume, the `eval` and checkpoint spans, the
`faults_injected` counter, every `--telemetry-interval` steps a sample
(`device_step_ms` from CUDA events around a chunk, read once the next
chunk is queued, `steps_per_sec`, `host_rss_mb`, and the atomically
replaced `heartbeat.json`), the suspicion tracker's and the health
monitor's edges, `forensics_summary`, `health_summary` and `run_end`.
`python -m byzantinemomentum_tpu_torch.obs <run directory>` renders it
(`obs/report.py`).

`--health` (with `--result-directory` and `--nb-for-study`, else the JAX
warning drops it) adds the health vector to every step
(`engine/health.py`) and the JAX driver's `HEALTH_COLUMNS` to the study
CSV, after the forensic columns; the host folds each row into
`obs/health/monitor.py::HealthMonitor`, whose anomaly edges land on the
timeline and whose ring is dumped as `health_blackbox.json` at a
rollback, a give-up and the run's end. `--rollback-budget N` (with
`--checkpoint-delta`) watches `isfinite(max |theta|)` after each chunk:
the flag is a device scalar read with the chunk's rows once the next
chunk is queued, and before any evaluation, checkpoint, prompt or the
run's end, so none of them sees a poisoned state and a chunk between
milestones costs no wait. A non-finite state (or, with
`--rollback-on-anomaly`, the monitor's rising anomaly edge) dumps the
blackbox, restores the newest valid checkpoint of the result directory
or its mirror with the samplers' state, re-seeds the step key with
`fold_in(key, 0x5EED + rollbacks)` (the host's mirror of the key chain
with it), drops the chunks not yet written, truncates the CSVs to the
restored step and, with `--rollback-tighten-quorum`, raises f by one
where every defense's check allows it and rebuilds the engine. The
study CSV then carries the `Rollbacks`/`Restarts` columns, as under
`--auto-resume`; a spent budget or a failed reload ends the run with
exit code 1. `BMT_CHAOS_NAN_AT_STEP`, `BMT_CHAOS_NAN_REPEAT`,
`BMT_CHAOS_BLOWUP_AT_STEP` and `BMT_CHAOS_BLOWUP_FACTOR` poison the
parameters after a chunk as the JAX driver's hooks do (`_Chaos`).

Profiling, as in the JAX driver, on `torch.profiler` (CPU activity, and
on the card CUDA's; the traces are `tensorboard_trace_handler`'s
`*.pt.trace.json`), read by `obs/attrib/`: `--trace-dir DIR` traces from
before the loop to the run's end (`profiler_trace_start`/`_stop`
events). `--attribution` (with a result directory, else the JAX warning
drops it) traces exactly one chunk, the first whose step count M has run
once, into `attribution-trace/`: the device is drained before it, its
`device_step_ms` sample is forced, and it is drained and closed on
itself, not one chunk later with its rows; the window is attributed to
the engine's phase ranges (`engine/program.py::scope`) into
`attribution.json` with an `attribution` event. `--telemetry-mfu` counts
the first chunk's FLOPs (`obs/perf.py::logical_flops`, the
`flops_per_step` event) and adds an `mfu` gauge and heartbeat field at
every sample where `peak_flops` knows the card. SIGUSR1 (`main`) dumps
the health blackbox (reason `sigusr1`) and opens a one-chunk window into
`profile-<step>/` at the next loop top, closed on that chunk, attributed
into its own directory, with a `profiler_window` event. A window that
fails to open, close or parse is a warning; the run goes on with its
results unchanged. With none of these flags no profiler object exists
and the loop issues what it issues without them.

SIGINT and SIGTERM (`main`) set the JAX driver's one-time latch, read at
each loop top: the run then ends as a finished run does (the pending
chunk's rows written, `run_end` with status `"interrupted"`, the final
heartbeat), and `main` returns 130 where a bounded run was cut short (0
under `--nb-steps < 0`), so a supervisor does not take a truncated
directory for a finished one.

The `eval` and 24-column `study` CSVs have the JAX driver's headers and
row format byte for byte ('# '-prefixed tab-separated header, rows
prefixed with the line separator, values at the parameter dtype's
precision), so `study.py` reads the port's result directories unchanged.
"""

import argparse
import code
import dataclasses
import json
import math
import os
import pathlib
import signal
import sys
import time

import numpy as np
import torch

from byzantinemomentum_tpu_torch import attacks as attacks_mod
from byzantinemomentum_tpu_torch import checkpoint as checkpoint_mod
from byzantinemomentum_tpu_torch import data as data_mod
from byzantinemomentum_tpu_torch import faults as faults_mod
from byzantinemomentum_tpu_torch import losses as losses_mod
from byzantinemomentum_tpu_torch import models as models_mod
from byzantinemomentum_tpu_torch import ops as ops_mod
from byzantinemomentum_tpu_torch import obs, optim, prng, utils
from byzantinemomentum_tpu_torch.data.device import DeviceData
from byzantinemomentum_tpu_torch.engine import (
    DTYPES, FAULT_COLUMNS, FORENSIC_COLUMNS, HEALTH_COLUMNS, RECOVERY_COLUMNS,
    STUDY_COLUMNS, Engine, EngineConfig)
from byzantinemomentum_tpu_torch.engine import program
from byzantinemomentum_tpu_torch.models.core import apply_named_init, inits

__all__ = ["process_commandline", "run", "main"]

# The study row format of the JAX driver, by parameter dtype (bf16 has an
# f16-like significand width, so it shares "%.4e")
FLOAT_FORMATS = {torch.float16: "%.4e", torch.bfloat16: "%.4e",
                 torch.float32: "%.8e", torch.float64: "%.16e"}


def process_commandline(argv=None):
    """Parse the command line (the JAX driver's flags of this slice)."""
    parser = argparse.ArgumentParser(
        prog="python -m byzantinemomentum_tpu_torch",
        formatter_class=argparse.RawTextHelpFormatter)
    add = parser.add_argument
    add("--seed", type=int, default=-1,
        help="Fixed seed for reproducibility, negative for random seed")
    add("--device", type=str, default="cuda",
        help="Device to run on: 'cuda' (default), 'cuda:<index>' or 'cpu'")
    add("--device-gar", type=str, default="same",
        help="Device/platform on which to run the defense phase (attack + "
             "GAR), 'same' to fuse it into the training program (the fast "
             "default). E.g. 'cpu': the honest gradients hop to the CPU "
             "every step and the defense gradient hops back — the "
             "reference's heterogeneous placement")
    add("--dtype", type=str, default="float32",
        help="Parameter/gradient dtype: float32, bfloat16, float16, float64 "
             "(the reference Configuration's dtype, configuration.py:26-101)")
    add("--compute-dtype", type=str, default=None,
        help="Forward/backward compute dtype; default = --dtype. "
             "'--dtype float32 --compute-dtype bfloat16' = mixed "
             "precision (bf16 forward/backward, f32 master "
             "weights/momentum/GAR)")
    add("--nb-steps", type=int, default=-1,
        help="Number of training steps, negative for no limit")
    add("--nb-workers", type=int, default=11, help="Total number of workers")
    add("--nb-for-study", type=int, default=11,
        help="Gradients to compute for study purposes only")
    add("--nb-for-study-past", type=int, default=20,
        help="Past gradients kept for the curvature metric")
    add("--nb-decl-byz", type=int, default=4,
        help="Number of declared Byzantine workers")
    add("--nb-real-byz", type=int, default=0,
        help="Number of actually Byzantine workers")
    add("--init-multi", type=str, default=None,
        help="Multi-dimensional parameter init algorithm")
    add("--init-multi-args", nargs="*",
        help="key:value args for --init-multi")
    add("--init-mono", type=str, default=None,
        help="Mono-dimensional parameter init algorithm")
    add("--init-mono-args", nargs="*",
        help="key:value args for --init-mono")
    add("--gar", type=str, default="average", help="Aggregation rule")
    add("--gar-args", nargs="*", help="key:value args for the GAR")
    add("--gars", type=str, default=None,
        help="Random per-step GAR mixture: 'name[,freq[,json-args]];...'")
    add("--gars-per-call", action="store_true",
        help="Re-draw the --gars mixture GAR on every defense invocation "
             "(incl. inside adaptive attacks' line searches) — the "
             "reference's semantics; default draws once per step")
    add("--no-grouped-workers", action="store_true",
        help="Disable the merged-batch grouped honest phase (always use the "
             "vmapped per-worker path, even for models that provide the "
             "grouped execution)")
    add("--gar-diagnostics", action="store_true", default=False,
        help="Run the defense through its in-jit diagnostics kernel and "
             "append the aggregation-forensics columns to the study CSV "
             "('Sel workers', 'Dist honest med', 'Var/norm ratio', 'Clip "
             "frac', 'Suspicion max'), feeding the per-worker suspicion "
             "tracker (obs/forensics.py: suspect_worker telemetry events). "
             "Off by default: the diagnostic aux rides the compiled step "
             "as extra outputs (measured overhead documented in README)")
    add("--health", action="store_true", default=False,
        help="Numerics flight recorder: compute the tensor-health vector "
             "every step (engine/health.py — fixed-bin log-scale "
             "histogram of submitted-momentum norms, the paper's Var/norm "
             "ratio, weight/update norms, per-phase NaN/Inf counts), "
             "append the HEALTH_COLUMNS to the study CSV and feed the "
             "host-side SPC monitor (obs/health: EWMA+MAD z-scores with "
             "sustained-run rules, health_anomaly/health_cleared telemetry "
             "events, health_blackbox.json post-mortem ring). Off by "
             "default; when off the step runs exactly as without it")
    add("--rollback-on-anomaly", action="store_true", default=False,
        help="Upgrade the divergence-rollback trigger from 'training "
             "state went non-finite' to 'non-finite OR sustained health "
             "anomaly' (implies --health; needs '--rollback-budget'): the "
             "SPC monitor's rising anomaly edge rolls the run back to the "
             "last good checkpoint BEFORE the state is destroyed, reusing "
             "the pipelined rollback machinery")
    add("--attack", type=str, default="nan", help="Attack to use")
    add("--attack-args", nargs="*", help="key:value args for the attack")
    add("--fault-plan", type=str, default=None,
        help="JSON fault plan (faults.FaultPlan): deterministic per-step "
             "system faults — stragglers, dropped workers, corrupted/NaN "
             "shards, duplicated submissions, device loss — injected into "
             "the stacked gradient batch before aggregation, with the "
             "plan's degradation policy (NaN-quarantine, dynamic quorum, "
             "download retry). Adds the 'Faults injected'/'Workers "
             "active'/'Quorum f' columns to the study CSV")
    add("--telemetry", action="store_true", default=False,
        help="Record run telemetry — 'telemetry.jsonl' (spans/events/"
             "counters/gauges) and an atomic 'heartbeat.json' in the result "
             "directory. Default: ON whenever '--result-directory' is set "
             "(there is nowhere to write otherwise); this flag only makes "
             "the intent explicit")
    add("--no-telemetry", action="store_true", default=False,
        help="Disable run telemetry (no telemetry.jsonl, no heartbeat)")
    add("--telemetry-interval", type=int, default=50,
        help="Steps between telemetry samples: each sample times one "
             "chunk on the device (CUDA events, read once the next chunk "
             "is queued), then records steps/s, host RSS and refreshes the "
             "heartbeat")
    add("--telemetry-mfu", action="store_true", default=False,
        help="Also estimate MFU: count the step's logical FLOPs once "
             "(FlopCounterMode over the first chunk dispatched) and add an "
             "'mfu' gauge where the card's bf16 peak is known")
    add("--model", type=str, default="simples-conv", help="Model to train")
    add("--model-args", nargs="*", help="key:value args for the model")
    add("--loss", type=str, default="nll", help="Loss to use")
    add("--loss-args", nargs="*", help="key:value args for the loss")
    add("--criterion", type=str, default="top-k", help="Criterion to use")
    add("--criterion-args", nargs="*", help="key:value args for the criterion")
    add("--dataset", type=str, default="mnist", help="Dataset to use")
    add("--dataset-args", nargs="*",
        help="key:value args for the dataset loader (e.g. split:balanced)")
    add("--batch-size", type=int, default=25, help="Training batch size")
    add("--batch-size-test", type=int, default=100, help="Test batch size")
    add("--batch-size-test-reps", type=int, default=100,
        help="Number of test batches per evaluation")
    add("--no-transform", action="store_true", default=False,
        help="Disable dataset transformations (normalization, flips)")
    add("--learning-rate", type=float, default=0.01, help="Learning rate")
    add("--learning-rate-decay", type=int, default=5000,
        help="Hyperbolic half-decay time, non-positive for no decay")
    add("--learning-rate-decay-delta", type=int, default=1,
        help="Steps between two learning-rate updates")
    add("--learning-rate-schedule", type=str, default=None,
        help="Piecewise schedule '<init lr>[,<from step>,<new lr>]*'")
    add("--momentum", type=float, default=0.9, help="Momentum")
    add("--dampening", type=float, default=0., help="Dampening")
    add("--momentum-nesterov", action="store_true", default=False,
        help="Nesterov lookahead variant")
    add("--momentum-at", type=str, default="update",
        help="Momentum placement: 'update', 'server' or 'worker'")
    add("--weight-decay", type=float, default=0., help="Weight decay")
    add("--optimizer", type=str, default="sgd",
        help="Optimizer applying the final update")
    add("--optimizer-args", nargs="*", help="key:value args for the optimizer")
    add("--trace-dir", type=str, default=None,
        help="Capture a torch.profiler trace (CPU and, on the card, CUDA "
             "activity) from before the training loop to the run's end "
             "into this directory (opt-in, like the reference's "
             "TimedContext tools)")
    add("--attribution", action="store_true", default=False,
        help="Phase-attributed device profiling: trace exactly one fused "
             "chunk — deterministically, the first chunk whose step count "
             "has already run once — and attribute its device time to the "
             "engine's named phases (honest/attack/gar/update/metrics), "
             "op classes (GEMM/convolution vs memory-bound vs relayout "
             "copies) and the host gap — written as 'attribution.json' in "
             "the result directory with an 'attribution' telemetry event "
             "(obs/attrib; needs '--result-directory'). The flag only adds "
             "a one-chunk profiler window; the step itself is unchanged")
    add("--l1-regularize", type=float, default=None,
        help="L1 loss regularization factor")
    add("--l2-regularize", type=float, default=None,
        help="L2 loss regularization factor")
    add("--gradient-clip", type=float, default=None,
        help="Per-gradient L2 clip threshold")
    add("--nb-local-steps", type=int, default=1,
        help="Local SGD steps per global step (implemented here; the "
             "reference advertises but disables it)")
    add("--load-checkpoint", type=str, default=None,
        help="Checkpoint to resume from")
    add("--auto-resume", action="store_true", default=False,
        help="Restart from the newest VALID checkpoint found in the result "
             "directory (torn/corrupt tails are skipped). The study/eval "
             "CSVs are truncated to the resume step and appended to, so an "
             "interrupted run's concatenated output equals an "
             "uninterrupted run's. When a resume actually happens, "
             "'--nb-steps' counts TOTAL steps from step 0; cold starts are "
             "unaffected")
    add("--keep-checkpoints", type=int, default=0,
        help="Retention: keep only this run's newest N checkpoints, 0 to "
             "keep all")
    add("--checkpoint-mirror", type=str, default=None,
        help="Second directory every checkpoint is also written to; "
             "'--auto-resume' scans both for the newest valid checkpoint")
    add("--rollback-budget", type=int, default=0,
        help="Divergence rollback: when the training state goes non-finite "
             "mid-run, restore the last good checkpoint, re-seed the step "
             "RNG fold and continue — at most this many times per process "
             "(0 disables; needs '--checkpoint-delta' with a result "
             "directory). Exhausting the budget fails the run (exit 1) so "
             "a supervisor can retry it")
    add("--rollback-tighten-quorum", action="store_true", default=False,
        help="After each rollback, also raise the declared Byzantine count "
             "f by one (only while every defense's contract still holds) "
             "and rebuild the engine")
    add("--result-directory", type=str, default=None,
        help="Directory for results (eval/study CSVs, checkpoints)")
    add("--evaluation-delta", type=int, default=100,
        help="Steps between evaluations, 0 for none")
    add("--checkpoint-delta", type=int, default=0,
        help="Steps between checkpoints, 0 for none")
    add("--user-input-delta", type=int, default=0,
        help="Steps between interactive prompts, 0 for none")
    add("--steps-per-program", type=int, default=8,
        help="Training steps fused into one compiled dispatch (lax.scan); "
             "milestones always force a boundary, so the per-step trajectory "
             "and CSV output are identical to 1 (which disables fusion). "
             "Each distinct residual window (when a milestone delta is not a "
             "multiple of this) compiles a separate program — pick a divisor "
             "of the evaluation/checkpoint deltas to avoid extra compiles")
    return parser.parse_args(sys.argv[1:] if argv is None else argv)


def _postprocess(args):
    """Derivations and checks (the JAX driver's `_postprocess`)."""
    for name in ("init_multi", "init_mono", "gar", "attack", "model",
                 "dataset", "loss", "criterion", "optimizer"):
        name = f"{name}_args"
        setattr(args, name, utils.parse_keyval(getattr(args, name)))
    args.nb_honests = args.nb_workers - args.nb_real_byz
    if args.nb_honests < 0:
        utils.fatal(f"Invalid arguments: there are more real Byzantine "
                    f"workers ({args.nb_real_byz}) than total workers "
                    f"({args.nb_workers})")
    if args.nb_decl_byz > args.nb_workers:
        utils.fatal(f"Invalid arguments: there are more declared Byzantine "
                    f"workers ({args.nb_decl_byz}) than total workers "
                    f"({args.nb_workers})")
    if args.learning_rate_schedule is None:
        if args.learning_rate <= 0:
            utils.fatal(f"Invalid arguments: non-positive learning rate "
                        f"{args.learning_rate}")
        if args.learning_rate_decay_delta <= 0:
            utils.fatal(f"Invalid arguments: non-positive learning rate "
                        f"decay delta {args.learning_rate_decay_delta}")

        def compute_new_learning_rate(steps):
            if (args.learning_rate_decay > 0
                    and steps % args.learning_rate_decay_delta == 0):
                return args.learning_rate / (steps / args.learning_rate_decay + 1)
            return None

        def initial_lr(steps):
            # The rate in effect at loop entry (a resume's first step):
            # the one set at the last update boundary
            if args.learning_rate_decay <= 0:
                return args.learning_rate
            last = steps - steps % args.learning_rate_decay_delta
            return args.learning_rate / (last / args.learning_rate_decay + 1)
    else:
        numbers = args.learning_rate_schedule.split(",")
        try:
            flat = tuple(float(x) if i % 2 == 0 else int(x)
                         for i, x in enumerate(numbers))
        except ValueError as err:
            utils.fatal(f"Invalid arguments: malformed learning rate "
                        f"schedule {args.learning_rate_schedule!r} ({err})")
        if len(flat) % 2 == 0:
            utils.fatal(f"Invalid arguments: learning rate schedule "
                        f"{args.learning_rate_schedule!r} must have the form "
                        f"'<init lr>[,<from step>,<new lr>]*'")
        schedule = [(0, flat[0])]
        for i in range(1, len(flat), 2):
            step, lr = flat[i], flat[i + 1]
            if step <= schedule[-1][0]:
                utils.fatal("Invalid arguments: learning rate schedule step "
                            "numbers must be strictly increasing")
            schedule.append((step, lr))

        def compute_new_learning_rate(steps):
            for step, lr in schedule:
                if steps == step:
                    return lr
            return None

        def initial_lr(steps):
            current = schedule[0][1]
            for step, lr in schedule:
                if step <= steps:
                    current = lr
            return current
    args.compute_new_learning_rate = compute_new_learning_rate
    args.initial_lr = initial_lr
    for name in (args.dtype, args.compute_dtype):
        if name is not None and name not in DTYPES:
            utils.fatal_unavailable(sorted(set(DTYPES)), name, what="dtype")
    if args.momentum_at not in ("update", "server", "worker"):
        utils.fatal_unavailable(("update", "server", "worker"),
                                args.momentum_at, what="momentum position")
    if args.nb_local_steps < 1:
        utils.fatal(f"Invalid arguments: non-positive number of local steps "
                    f"{args.nb_local_steps}")
    # Checkpoint flags (the JAX driver's checks)
    if args.auto_resume:
        if args.load_checkpoint is not None:
            utils.fatal("Invalid arguments: '--auto-resume' and "
                        "'--load-checkpoint' are mutually exclusive "
                        "(auto-resume scans the result directory itself)")
        if args.result_directory is None:
            utils.fatal("Invalid arguments: '--auto-resume' requires "
                        "'--result-directory'")
    if args.keep_checkpoints < 0:
        utils.fatal(f"Invalid arguments: negative checkpoint retention "
                    f"{args.keep_checkpoints}")
    if args.checkpoint_mirror is not None and args.result_directory is None:
        utils.warning("'--checkpoint-mirror' needs '--result-directory' "
                      "(there is no primary to mirror); mirror disabled")
        args.checkpoint_mirror = None
    if args.result_directory is None and args.checkpoint_delta != 0:
        utils.warning("Argument '--checkpoint-delta' ignored as no "
                      "'--result-directory' was specified")
        args.checkpoint_delta = 0
    # Telemetry, health and rollback flags (the JAX driver's checks and
    # messages)
    if args.telemetry and args.no_telemetry:
        utils.fatal("Invalid arguments: '--telemetry' and '--no-telemetry' "
                    "are mutually exclusive")
    if args.telemetry_interval < 1:
        utils.fatal(f"Invalid arguments: non-positive telemetry interval "
                    f"{args.telemetry_interval}")
    if args.telemetry and args.result_directory is None:
        utils.warning("'--telemetry' needs '--result-directory' (there is "
                      "nowhere to write the timeline); telemetry disabled")
    if args.attribution and args.result_directory is None:
        utils.warning("'--attribution' needs '--result-directory' (there "
                      "is nowhere to write the trace window and "
                      "attribution.json); attribution disabled")
        args.attribution = False
    if args.gar_diagnostics and (args.result_directory is None
                                 or args.nb_for_study < 1):
        utils.warning("'--gar-diagnostics' needs the study pipeline "
                      "('--nb-for-study' with '--result-directory'); "
                      "diagnostics disabled")
        args.gar_diagnostics = False
    if args.rollback_budget < 0:
        utils.fatal(f"Invalid arguments: negative rollback budget "
                    f"{args.rollback_budget}")
    if args.rollback_budget > 0 and (args.result_directory is None
                                     or args.checkpoint_delta <= 0):
        utils.warning("'--rollback-budget' needs periodic checkpoints "
                      "('--checkpoint-delta' with '--result-directory'); "
                      "rollback disabled")
        args.rollback_budget = 0
    if args.rollback_on_anomaly and not args.health:
        args.health = True  # the early-warning trigger needs the stream
    if args.health and (args.result_directory is None
                        or args.nb_for_study < 1):
        utils.warning("'--health' needs the study pipeline "
                      "('--nb-for-study' with '--result-directory'); "
                      "health columns disabled")
        args.health = False
        args.rollback_on_anomaly = False
    if args.rollback_on_anomaly and args.rollback_budget <= 0:
        utils.warning("'--rollback-on-anomaly' needs '--rollback-budget' "
                      "(there is no rollback machinery to trigger); "
                      "anomaly trigger disabled")
        args.rollback_on_anomaly = False
    # Study coercions (the JAX driver's)
    if args.result_directory is None:
        args.nb_for_study = 0
        args.nb_for_study_past = 0
    elif args.nb_for_study_past < 1:
        utils.warning("At least one gradient must exist in the past to "
                      "study honest curvature; set '--nb-for-study-past 1'")
        args.nb_for_study_past = 1
    elif math.isclose(args.momentum, 0.0) and args.nb_for_study_past > 1:
        utils.warning("Momentum is (almost) zero; set "
                      "'--nb-for-study-past 1'")
        args.nb_for_study_past = 1
    return args


def _parse_gars(spec):
    """Parse the `--gars 'name,freq,json;...'` mixture string into
    `[(gar, cumulative_freq, kwargs)]` (the JAX driver's `_parse_gars`)."""
    freq_sum = 0.0
    defenses = []
    for info in spec.split(";"):
        info = info.split(",", maxsplit=2)
        name = info[0].strip()
        freq = 1.0
        if len(info) >= 2:
            raw = info[1].strip()
            freq = 1.0 if raw == "-" else float(raw)
        conf = {}
        if len(info) >= 3:
            try:
                conf = json.loads(info[2].strip())
            except json.decoder.JSONDecodeError as err:
                utils.fatal(f"Invalid GAR arguments for GAR {name!r}: "
                            f"{str(err).lower()}")
            if not isinstance(conf, dict):
                utils.fatal(f"Invalid GAR arguments for GAR {name!r}: "
                            f"expected a dictionary")
        if name not in ops_mod.gars:
            utils.fatal_unavailable(ops_mod.gars, name, what="aggregation rule")
        freq_sum += freq
        defenses.append((ops_mod.gars[name], freq_sum, conf))
    return defenses


def _config_text(args):
    """Human-readable run configuration (the JAX driver's rendering)."""
    lines = ["Configuration:"]
    for name in sorted(vars(args)):
        if name.startswith("_") or callable(getattr(args, name)):
            continue
        lines.append(f"  · {name} - {getattr(args, name)}")
    return os.linesep.join(lines)


class _ResultFiles:
    """The JAX driver's result files: '# '-prefixed tab-separated header,
    rows prefixed with the line separator (no trailing newline).
    `make(..., resume_step=s)` keeps an existing file's rows strictly
    below s (those a killed predecessor wrote before its last valid
    checkpoint; rows of another header, torn rows and unparsable step
    numbers go), so the rows on disk stay one trajectory; `truncate(s)`
    does the same to the open files after a rollback."""

    def __init__(self, directory):
        self.directory = directory
        self._fds = {}
        self._headers = {}

    def make(self, name, *fields, resume_step=None):
        header = "# " + "\t".join(str(field) for field in fields)
        self._headers[name] = header
        self._write(name, header, resume_step)

    def _write(self, name, header, limit_step=None):
        path = self.directory / name
        kept = ()
        if limit_step is not None and path.is_file():
            kept = self._surviving_rows(path, header, limit_step)
        fd = path.open("w")
        fd.write(header)
        for row in kept:
            fd.write(os.linesep + row)
        fd.flush()
        self._fds[name] = fd

    def truncate(self, step):
        """Rewind every open file to its rows strictly below `step` (a
        divergence rollback: the rows past the restored checkpoint belong
        to the abandoned trajectory)."""
        for name, fd in list(self._fds.items()):
            fd.close()
            self._write(name, self._headers[name], step)

    @staticmethod
    def _surviving_rows(path, header, limit_step):
        try:
            lines = path.read_text().split(os.linesep)
        except OSError:
            return ()
        if not lines or lines[0] != header:
            return ()
        nb_fields = len(header[2:].split("\t"))
        kept = []
        for line in lines[1:]:
            fields = line.split("\t")
            if len(fields) != nb_fields:
                continue
            try:
                step = int(fields[0])
            except ValueError:
                continue
            if step < limit_step:
                kept.append(line)
        return tuple(kept)

    def get(self, name):
        return self._fds.get(name)

    @staticmethod
    def store(fd, *entries):
        fd.write(os.linesep + "\t".join(str(entry) for entry in entries))
        fd.flush()

    def close(self):
        for fd in self._fds.values():
            fd.close()


# The forensic values written as they are, and the vectors the host
# formats and folds into the suspicion tracker (`Active mask` only under
# a fault plan)
FORENSIC_SCALARS = ("Dist honest med", "Var/norm ratio", "Clip frac")
FORENSIC_VECTORS = ("Sel mask", "Worker dist", "Active mask")
# The health values: the floats written at the dtype's precision, the
# counts written as integers, and the histogram (`Norm hist`, ';'-joined)
HEALTH_FLOATS = ("Var ratio", "Weight norm", "Update norm", "Update/weight")
HEALTH_COUNTS = ("Nonfinite submitted", "Nonfinite aggregate",
                 "Nonfinite state")


def _study_rows(metrics, steps, datapoints, increment, count, float_format,
                rng=None, recovery=(), tracker=None, monitor=None):
    """The study CSV rows of a chunk of `count` steps from `steps` (its
    first step's point count `datapoints`, `increment` points a step), and
    the words of the device key `rng` after the chunk (None without one):
    the chunk's stacked device columns (`stack_metrics`; `metrics` None
    for no rows) and the key move to the host in one transfer, widened to
    float64, which holds every dtype's value and every 32-bit word
    exactly. Under a fault plan the `FAULT_COLUMNS` integers follow the
    24 columns. Each row then ends with the `recovery` values, then, with
    a suspicion `tracker` (`--gar-diagnostics`), the forensic columns:
    the forensic scalars and the `[count, n]` selection, worker-distance
    and (under a fault plan) active-mask vectors join the same transfer,
    and the tracker folds the steps in order; then, with a health
    `monitor` (`--health`), the health columns: the health scalars and
    the `[count, 16]` histograms join the transfer, and the monitor folds
    each step's vector in order."""
    columns = STUDY_COLUMNS[2:] if metrics is not None else ()
    faulted = bool(columns) and FAULT_COLUMNS[0] in metrics
    forensic = bool(columns) and tracker is not None
    health = bool(columns) and monitor is not None
    ints = FAULT_COLUMNS if faulted else ()
    extra = ((FORENSIC_SCALARS if forensic else ())
             + (HEALTH_FLOATS + HEALTH_COUNTS if health else ()))
    scalars = columns + ints + extra
    parts = [torch.stack([metrics[column].double() for column in scalars])
             .flatten()] if columns else []
    vectors = ([name for name in FORENSIC_VECTORS
                if forensic and name in metrics]
               + (["Norm hist"] if health else []))
    parts += [metrics[name].double().flatten() for name in vectors]
    if rng is not None:
        parts.append(rng.double())
    if not parts:
        return [], None
    host = torch.cat(parts).tolist()
    words = tuple(int(word) for word in host[-2:]) if rng is not None else None
    table = dict(zip(scalars, (host[k * count:(k + 1) * count]
                               for k in range(len(scalars)))))
    vector, start = {}, len(scalars) * count
    for name in vectors:
        width = metrics[name].shape[-1]
        vector[name] = np.asarray(
            host[start:start + count * width]).reshape(count, width)
        start += count * width
    rows = []
    for i in range(count if columns else 0):
        row = [steps + i, datapoints + i * increment]
        row += [float_format % table[column][i] for column in columns[:-1]]
        row.append(float(table[columns[-1]][i]))
        row += [int(table[column][i]) for column in ints]
        row += recovery
        if forensic:
            sel = vector["Sel mask"][i]
            selected = np.nonzero(sel > 0)[0]
            row.append(";".join(str(w) for w in selected) or "-")
            row += [float_format % table[column][i]
                    for column in FORENSIC_SCALARS]
            active = vector["Active mask"][i] if "Active mask" in vector else None
            tracker.update(steps + i, sel, distances=vector["Worker dist"][i],
                           active=active)
            row.append(float_format % tracker.max())
        if health:
            value = {column: table[column][i]
                     for column in HEALTH_FLOATS + HEALTH_COUNTS}
            row += [float_format % value[column] for column in HEALTH_FLOATS]
            hist = [int(c) for c in vector["Norm hist"][i]]
            row.append(";".join(str(c) for c in hist))
            nonfinite = [int(value[column]) for column in HEALTH_COUNTS]
            row += nonfinite
            monitor.update(steps + i, {
                "var_ratio": value["Var ratio"],
                "update_ratio": value["Update/weight"],
                "weight_norm": value["Weight norm"],
                "update_norm": value["Update norm"],
                "nonfinite": sum(nonfinite),
                "norm_hist": hist,
            })
        rows.append(row)
    return rows, words


def _setup(args):
    """Device, seeds, registries, data and engine of a parsed run; returns
    `(device, engine, fresh state)`: the model's weights from
    `model.init(PRNGKey(seed))` and the state from
    `engine.init(PRNGKey(seed))`, the JAX driver's order."""
    device = utils.resolve_device(args.device)
    # The defense's placement, `args.gar_device` (the JAX driver's
    # checks and message)
    device_gar = (args.device_gar or "same").lower()
    args.gar_device = None
    if device_gar not in ("same", ""):
        try:
            args.gar_device = utils.resolve_device(device_gar)
        except (RuntimeError, utils.UserException) as err:
            utils.fatal(f"Invalid '--device-gar {args.device_gar}': {err}")
        if args.steps_per_program > 1:
            utils.info("'--device-gar' hops devices every step; "
                       "multi-step fusion disabled")
            args.steps_per_program = 1
    seed = args.seed if args.seed >= 0 else int.from_bytes(os.urandom(4), "little")
    np.random.seed(seed % 2**32)
    root_key = prng.PRNGKey(seed, device=device)

    if args.gars is None:
        if args.gar not in ops_mod.gars:
            utils.fatal_unavailable(ops_mod.gars, args.gar,
                                    what="aggregation rule")
        defenses = [(ops_mod.gars[args.gar], 1.0, args.gar_args)]
    else:
        defenses = _parse_gars(args.gars)
        args.gar_args = {}
    if args.attack not in attacks_mod.attacks:
        utils.fatal_unavailable(attacks_mod.attacks, args.attack, what="attack")
    attack = attacks_mod.attacks[args.attack]
    for gar, _, kwargs in defenses:
        message = gar.check(gradients=torch.zeros((args.nb_workers, 2)),
                            f=args.nb_decl_byz, **kwargs)
        if message is not None:
            utils.fatal(f"Aggregation rule {gar.name!r} cannot be used: "
                        f"{message}")
    for name in (args.init_multi, args.init_mono):
        if name is not None and name not in inits:
            utils.fatal_unavailable(inits, name, what="initialization")
    message = attack.check(
        grad_honests=torch.zeros((args.nb_honests, 2)),
        f_decl=args.nb_decl_byz, f_real=args.nb_real_byz,
        defense=lambda **kw: None, **args.attack_args)
    if message is not None:
        utils.fatal(f"Attack {attack.name!r} cannot be used: {message}")
    fault_plan, fault_schedule = _fault_plan(args)

    cfg = EngineConfig(
        nb_workers=args.nb_workers, nb_decl_byz=args.nb_decl_byz,
        nb_real_byz=args.nb_real_byz, nb_for_study=args.nb_for_study,
        nb_for_study_past=max(args.nb_for_study_past, 1),
        momentum=args.momentum, dampening=args.dampening,
        nesterov=args.momentum_nesterov, momentum_at=args.momentum_at,
        weight_decay=args.weight_decay, gradient_clip=args.gradient_clip,
        grouped_workers=not args.no_grouped_workers,
        nb_local_steps=args.nb_local_steps, gars_per_call=args.gars_per_call,
        gar_diagnostics=args.gar_diagnostics, health=args.health,
        fault_quarantine=(fault_plan.policy.nan_quarantine
                          if fault_plan is not None else True),
        fault_dynamic_quorum=(fault_plan.policy.dynamic_quorum
                              if fault_plan is not None else True),
        dtype=args.dtype, compute_dtype=args.compute_dtype)
    # Parameters are drawn in f32 and rounded to the parameter dtype, as
    # the JAX package casts its f32 init
    model = models_mod.build(args.model, device=device,
                             dtype=cfg.torch_dtype, **args.model_args)
    model.init(root_key)
    if args.init_multi or args.init_mono:
        apply_named_init(model, prng.fold_in(root_key, 2),
                         init_multi=args.init_multi,
                         init_multi_args=args.init_multi_args,
                         init_mono=args.init_mono,
                         init_mono_args=args.init_mono_args)
    t_data = time.perf_counter()
    trainset, testset = data_mod.make_datasets(
        args.dataset, args.batch_size, args.batch_size_test,
        no_transform=args.no_transform, seed=seed % 2**32,
        **args.dataset_args)
    # The seed taken and the data's set-up time, for the telemetry's
    # `run_start` and `data_setup` events
    args._seed, args._data_setup_s = seed, time.perf_counter() - t_data
    loss = losses_mod.Loss(args.loss, **args.loss_args)
    if args.l1_regularize is not None:
        loss = loss + args.l1_regularize * losses_mod.Loss("l1")
    if args.l2_regularize is not None:
        loss = loss + args.l2_regularize * losses_mod.Loss("l2")
    criterion = losses_mod.Criterion(args.criterion, **args.criterion_args)
    optimizer = optim.build(args.optimizer, weight_decay=args.weight_decay,
                            **args.optimizer_args)
    engine = Engine(cfg, model, loss, criterion, defenses, attack,
                    args.attack_args, optimizer, faults=fault_schedule)
    engine.attach_data(*DeviceData.pair(trainset, testset, device))
    return device, engine, engine.init(root_key)


def _fault_plan(args):
    """`--fault-plan`'s `(plan, schedule)` (the JAX driver's load, checks
    and messages): `(None, None)` without the flag; a plan with no events
    gives no schedule, and the run is the fault-free one."""
    if args.fault_plan is None:
        return None, None
    try:
        plan = faults_mod.FaultPlan.load(args.fault_plan)
    except (OSError, ValueError, TypeError) as err:
        utils.fatal(f"Unable to load fault plan {args.fault_plan!r}: {err}")
    message = plan.validate(args.nb_workers, args.nb_honests)
    if message is not None:
        utils.fatal(f"Fault plan {args.fault_plan!r} cannot be used: "
                    f"{message}")
    schedule = faults_mod.build_schedule(plan, nb_workers=args.nb_workers,
                                         nb_honests=args.nb_honests)
    if schedule is None:
        utils.info("Fault plan has no events; the fault machinery stays out "
                   "of the compiled step entirely")
    return plan, schedule


def _recovery(args):
    """Whether the study CSV carries `RECOVERY_COLUMNS` (the JAX driver's
    rule: crash recovery on, by `--auto-resume` or a rollback budget)."""
    return args.auto_resume or args.rollback_budget > 0


def _open_results(args, faulted=False):
    """The result directory's `eval`/`study` files and `config` files
    (None without a result directory), after the `--auto-resume` scan;
    returns `(results, resume step or None, restart count)`. An actual
    resume sets `args.load_checkpoint` to the checkpoint found. `faulted`:
    the run has a fault schedule (the study gains `FAULT_COLUMNS`)."""
    if args.result_directory is None:
        return None, None, 0
    resdir = pathlib.Path(args.result_directory).resolve()
    resdir.mkdir(mode=0o755, parents=True, exist_ok=True)
    args.result_directory = resdir
    if args.checkpoint_mirror is not None:
        args.checkpoint_mirror = pathlib.Path(args.checkpoint_mirror).resolve()
        args.checkpoint_mirror.mkdir(mode=0o755, parents=True, exist_ok=True)
    resume_step, restarts = None, 0
    if args.auto_resume:
        found = checkpoint_mod.find_latest_valid_any(
            (resdir, args.checkpoint_mirror))
        if found is None:
            utils.info(f"Auto-resume: no valid checkpoint in {str(resdir)!r}; "
                       f"cold start")
        else:
            args.load_checkpoint = str(found)
            resume_step = checkpoint_mod.checkpoint_step(found)
            restarts = checkpoint_mod.bump_restarts(resdir)
            utils.info(f"Auto-resume: restart #{restarts} from {found.name} "
                       f"(step {resume_step})")
    results = _ResultFiles(resdir)
    if args.evaluation_delta > 0:
        results.make("eval", "Step number", "Cross-accuracy",
                     resume_step=resume_step)
    if args.nb_for_study > 0:
        # The JAX driver's fault columns ride the study CSV only under a
        # fault schedule, its recovery columns only when crash recovery
        # (--auto-resume or a rollback budget) is on, its forensic columns
        # under diagnostics, its health columns under --health
        columns = (STUDY_COLUMNS
                   + (FAULT_COLUMNS if faulted else ())
                   + (RECOVERY_COLUMNS if _recovery(args) else ())
                   + (FORENSIC_COLUMNS if args.gar_diagnostics else ())
                   + (HEALTH_COLUMNS if args.health else ()))
        results.make("study", *columns, resume_step=resume_step)
    (resdir / "config").write_text(_config_text(args) + os.linesep)
    with (resdir / "config.json").open("w") as fd:
        def jsonable(x):
            return x if type(x) in (str, int, float, bool, type(None), dict,
                                    list) else str(x)
        json.dump({k: jsonable(v) for k, v in vars(args).items()
                   if not k.startswith("_") and not callable(getattr(args, k))},
                  fd, ensure_ascii=False, indent="\t")
    return results, resume_step, restarts


def _load(args, engine, state):
    """The state of `--load-checkpoint` (and the samplers' snapshots it
    carries, restored into the train and test samplers)."""
    path = args.load_checkpoint
    try:
        state, data_state = checkpoint_mod.load(path, state, return_data=True)
    except (OSError, ValueError, TypeError, KeyError) as err:
        utils.fatal(f"Unable to load checkpoint {path!r}: {err}")
    if data_state is None:
        utils.warning("Checkpoint carries no sampler state; resumed batch "
                      "order (seeded or not) will differ from the "
                      "uninterrupted run")
        return state
    try:
        engine.train_data.dataset.set_state(data_state["train"])
        engine.test_data.dataset.set_state(data_state["test"])
    except (KeyError, TypeError, ValueError) as err:
        utils.warning(f"Checkpoint sampler state only partially or not "
                      f"restored ({err}); resumed batch order may differ")
    else:
        if args.seed >= 0:
            utils.info("Seed argument superseded by the checkpoint's RNG and "
                       "sampler state (bit-exact resume)")
    return state


def _open_telemetry(args, resume_step, restarts):
    """The run's recorder, activated, with its first events (the JAX
    driver's): on by default with a result directory, off under
    `--no-telemetry`; None where it is off or its file cannot be opened.
    A recorder an earlier run of this process left active is deactivated
    first."""
    obs.deactivate()
    if args.result_directory is None or args.no_telemetry:
        return None
    try:
        telem = obs.Telemetry(args.result_directory,
                              interval=args.telemetry_interval)
    except OSError as err:
        utils.warning(f"Telemetry disabled: cannot open the timeline file "
                      f"({err})")
        return None
    obs.activate(telem)
    telem.event("run_start", seed=args._seed, restarts=restarts,
                resume_step=resume_step)
    telem.event("data_setup", seconds=round(args._data_setup_s, 3),
                dataset=args.dataset)
    if resume_step is not None:
        telem.event("restart", step=resume_step, count=restarts)
    return telem


class _Chaos:
    """The chaos hooks of the JAX driver, from the environment:
    `BMT_CHAOS_KILL_AT_STEP` SIGKILLs the run at a loop top at or past
    that step; `BMT_CHAOS_NAN_AT_STEP` multiplies the parameters by NaN
    after the first chunk that ends past that step (after every such
    chunk with `BMT_CHAOS_NAN_REPEAT=1`); `BMT_CHAOS_BLOWUP_AT_STEP`
    multiplies them by `BMT_CHAOS_BLOWUP_FACTOR` (default 1e12) after
    every chunk that ends past that step, a divergence that grows over
    several steps before it overflows."""

    def __init__(self):
        def step(name):
            value = os.environ.get(name)
            return int(value) if value else None

        self.kill = step("BMT_CHAOS_KILL_AT_STEP")
        self.nan = step("BMT_CHAOS_NAN_AT_STEP")
        self.nan_repeat = os.environ.get("BMT_CHAOS_NAN_REPEAT") == "1"
        self.blowup = step("BMT_CHAOS_BLOWUP_AT_STEP")
        self.blowup_factor = float(
            os.environ.get("BMT_CHAOS_BLOWUP_FACTOR", "1e12"))

    def poison(self, state, steps):
        """The state after a chunk that ended at `steps`: the blow-up,
        then the NaN, where they are armed."""
        theta = state.theta

        def scaled(factor):
            return theta * torch.full((), factor, dtype=theta.dtype,
                                      device=theta.device)

        if self.blowup is not None and steps > self.blowup:
            theta = scaled(self.blowup_factor)
        if self.nan is not None and steps > self.nan:
            if not self.nan_repeat:
                self.nan = None
            theta = scaled(math.nan)
        return (state if theta is state.theta
                else dataclasses.replace(state, theta=theta))


class Signals:
    """The driver's signal latches (the JAX driver's `main`): SIGINT and
    SIGTERM trigger a one-time exit latch (`exit_requested()`), which the
    loop reads at each loop top; SIGUSR1 raises `profile_request`, a
    one-chunk profiler window opened at the next loop top. `install`
    sets the handlers (main thread only) and returns the previous ones
    for `restore`."""

    def __init__(self):
        self.exit_trigger, self.exit_requested = utils.onetime(None)
        self.profile_request = False

    def request_profile(self, *_):
        self.profile_request = True

    def install(self):
        previous = {}
        try:
            for signum, handler in (
                    (signal.SIGINT, lambda *_: self.exit_trigger()),
                    (signal.SIGTERM, lambda *_: self.exit_trigger()),
                    (signal.SIGUSR1, self.request_profile)):
                previous[signum] = signal.signal(signum, handler)
        except (ValueError, AttributeError):
            pass  # not in the main thread, or a platform without SIGUSR1
        return previous

    @staticmethod
    def restore(previous):
        for signum, handler in previous.items():
            signal.signal(signum, handler)


def _start_profiler(directory, device, what):
    """A started `torch.profiler` session tracing the CPU and, on the
    card, CUDA into `directory` (`tensorboard_trace_handler`), or None
    with a warning where it cannot start (another session runs)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    try:
        prof = profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(str(directory)))
        prof.start()
    except (RuntimeError, OSError) as err:
        utils.warning(f"{what} profiler window failed to start ({err})")
        return None
    return prof


def _stop_profiler(prof, what):
    """Stop a session and write its trace; False with a warning where
    that fails (the run outlives its profiler window)."""
    try:
        prof.stop()
    except (RuntimeError, OSError) as err:
        utils.warning(f"{what} profiler window failed to stop ({err})")
        return False
    return True


@dataclasses.dataclass
class _Chunk:
    """A dispatched chunk whose rows, key, health flag and device time are
    read once the next chunk is queued."""
    metrics: dict        # its stacked study columns (None without a study)
    steps: int           # its first step
    datapoints: int      # its first step's point count
    count: int           # its steps
    rng: tuple           # (the device's key under a per-step mixture, else
    #                      None; the host's mirror)
    rollbacks: int       # the rollbacks as of its dispatch
    flag: object = None  # isfinite(max |theta|) after it, a 0-d bool
    #                      tensor (with a rollback budget)
    timed: tuple = None  # the StepTimer marks around its dispatch (a
    #                      telemetry sample)

    @property
    def end(self):
        return self.steps + self.count

    def poisoned(self):
        """Whether the chunk left a non-finite state (waits for it)."""
        return self.flag is not None and not bool(self.flag)


def run(argv=None, signals=None):
    """Run one experiment; `signals` gives the exit latch and the SIGUSR1
    request (`Signals`, which `main` installs; none is ever raised
    without it). Returns a summary dict: `steps`, `device`,
    `steps_per_s` (training steps per second over the steps run after the
    first chunk, whose time includes one-time set-up such as the kernel
    build; evaluations, checkpoints and rollbacks excluded, the steps a
    rollback rewound counted; None when the first chunk is the last),
    `steps_run` (the steps dispatched, rewound ones included),
    `rollbacks`, `diverged` (the rollback budget was spent, or a rollback
    could not reload: the run gave up), `status` (`run_end`'s:
    "completed", "interrupted" by the latch, or "diverged"), `cut_short`
    (a bounded run the latch ended before its last step), `result_directory`,
    `resume_step` (None on a cold start) and `counts` (the engine's counts of indexed
    steps and evaluations, of grouped and vmapped honest phases, of
    multi-step dispatches (chunks of more than one step) and of
    `--device-gar` hop steps)."""
    with utils.Context("cmdline"):
        args = _postprocess(process_commandline(argv))
    with utils.Context("setup"):
        device, engine, state = _setup(args)
        results, resume_step, restarts = _open_results(
            args, faulted=engine.faults is not None)
        telem = _open_telemetry(args, resume_step, restarts)
    try:
        return _train(args, device, engine, state, results, resume_step,
                      restarts, telem, signals or Signals())
    finally:
        if telem is not None:
            telem.close()
            obs.deactivate()


def _train(args, device, engine, state, results, resume_step, restarts,
           telem, signals):
    """`run`'s loop: the chunks, the milestones, the health verdicts and
    rollbacks, the telemetry and the profiler windows."""
    if args.load_checkpoint is not None:
        with utils.Context("load"):
            state = _load(args, engine, state)
    cfg = engine.cfg
    float_format = FLOAT_FORMATS[cfg.torch_dtype]
    fd_eval = results.get("eval") if results else None
    fd_study = results.get("study") if results else None
    recovery = _recovery(args)
    # The suspicion tracker of --gar-diagnostics and the health monitor of
    # --health (neither checkpointed, as in the JAX driver)
    tracker = (obs.SuspicionTracker(args.nb_workers) if engine.diagnostics
               else None)
    monitor = obs.HealthMonitor() if cfg.health and cfg.study else None
    hop = (program.build_step(engine, gar_device=args.gar_device)
           if args.gar_device is not None else None)
    # The host's own step and point counters (the JAX driver's mirrors):
    # they advance by the chunk's arithmetic, so the state is never read
    steps_host, datapoints_host = int(state.steps), int(state.datapoints)
    increment = args.batch_size * cfg.nb_honests * cfg.nb_local_steps
    # An actual auto-resume counts --nb-steps from step 0: a supervisor
    # re-issues the same command line
    steps_limit = (None if args.nb_steps < 0
                   else args.nb_steps if resume_step is not None
                   else steps_host + args.nb_steps)
    chaos = _Chaos()
    per_program = max(args.steps_per_program, 1)
    rollbacks, diverged, steps_run = 0, False, 0
    # Telemetry samples: every --telemetry-interval steps a chunk is timed
    # on the device, read with its rows
    rate_window = obs.SlidingRate()
    step_timer = obs.StepTimer(device)
    next_sample_step = steps_host
    # --telemetry-mfu: the logical FLOPs a step (counted over the first
    # chunk; False once the count failed) and the card's bf16 peak
    device_kind = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    mfu_flops = None
    mfu_peak = obs.peak_flops(device_kind) if telem is not None else None

    def health_hb():
        """The heartbeat's `health` block (none without --health)."""
        return {"health": monitor.summary()} if monitor is not None else {}

    if telem is not None:
        telem.heartbeat(step=steps_host, status="running", **health_hb())

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def flush(chunk):
        """A chunk's study rows to the file (the suspicion tracker and the
        health monitor fed), under a per-step mixture its key against the
        host's mirror, and its injected faults and telemetry sample to
        the timeline."""
        if chunk is None:
            return
        rng, rng_host = chunk.rng
        rows, words = _study_rows(
            chunk.metrics, chunk.steps, chunk.datapoints, increment,
            chunk.count, float_format, rng=rng,
            recovery=(chunk.rollbacks, restarts) if recovery else (),
            tracker=tracker, monitor=monitor)
        if fd_study is not None:
            for row in rows:
                results.store(fd_study, *row)
        if words is not None and words != tuple(rng_host):
            raise RuntimeError(f"the host's mirror of the key chain "
                               f"{tuple(rng_host)} differs from the "
                               f"device's key {words} after step "
                               f"{chunk.end}")
        if telem is None:
            return
        if engine.faults is not None:
            injected = sum(row[len(STUDY_COLUMNS)] for row in rows)
            if injected:
                telem.counter("faults_injected", injected)
        if chunk.timed is not None:
            device_ms = step_timer.seconds(*chunk.timed) * 1e3 / chunk.count
            rate, rss = rate_window.rate(), obs.host_rss_mb()
            telem.gauge("device_step_ms", device_ms, step=chunk.end)
            if rate is not None:
                telem.gauge("steps_per_sec", rate, step=chunk.end)
            if rss is not None:
                telem.gauge("host_rss_mb", rss, step=chunk.end)
            mfu_now = obs.mfu(mfu_flops or None, rate, mfu_peak)
            if mfu_now is not None:
                telem.gauge("mfu", mfu_now, step=chunk.end)
            telem.heartbeat(step=chunk.end, status="running",
                            steps_per_sec=rate, device_step_ms=device_ms,
                            rss_mb=rss, mfu=mfu_now, **health_hb())

    def tighten_quorum():
        """`--rollback-tighten-quorum`: f + 1 where every defense's check
        passes at it, with the engine (and the `--device-gar` hop)
        rebuilt."""
        nonlocal engine, hop
        new_f = engine.cfg.nb_decl_byz + 1
        if new_f > args.nb_workers:
            utils.info("Quorum not tightened: f already equals n")
            return
        dummy = torch.zeros((args.nb_workers, 2))
        for gar, _, kwargs in engine.defenses:
            message = gar.check(gradients=dummy, f=new_f, **kwargs)
            if message is not None:
                utils.info(f"Quorum not tightened: {gar.name!r} cannot run "
                           f"with f={new_f} ({message})")
                return
        engine = engine.with_config(
            dataclasses.replace(engine.cfg, nb_decl_byz=new_f))
        if args.gar_device is not None:
            hop = program.build_step(engine, gar_device=args.gar_device)
        utils.warning(f"Rollback: declared Byzantine count tightened to "
                      f"f={new_f} (engine rebuilt)")

    def roll_back(trigger, step):
        """Restore the newest valid checkpoint after a health trigger at
        `step` ('non-finite' state, or an 'anomaly' under
        --rollback-on-anomaly), re-seed the step key and rewind the
        result files; False when the run must give up (the budget spent,
        nothing valid to restore, or a reload that fails)."""
        nonlocal state, steps_host, datapoints_host, current_lr, \
            just_loaded, rollbacks, fd_eval, fd_study
        rollbacks += 1
        if rollbacks > args.rollback_budget:
            utils.error(f"Health trigger ({trigger}) at step {step} and the "
                        f"rollback budget ({args.rollback_budget}) is "
                        f"exhausted; giving up")
            return False
        found = checkpoint_mod.find_latest_valid_any(
            (args.result_directory, args.checkpoint_mirror))
        if found is None:
            utils.error("Non-finite training state and no valid checkpoint "
                        "to roll back to; giving up")
            return False
        try:
            restored, data_state = checkpoint_mod.load(found, state,
                                                       return_data=True)
        except (OSError, ValueError, TypeError, KeyError,
                utils.UserException) as err:
            utils.error(f"Rollback reload of {found.name} failed ({err}); "
                        f"giving up")
            return False
        if data_state is not None:
            try:
                engine.train_data.dataset.set_state(data_state["train"])
                engine.test_data.dataset.set_state(data_state["test"])
            except (KeyError, TypeError, ValueError) as err:
                utils.warning(f"Rollback sampler state only partially "
                              f"restored ({err})")
        # Re-seed the step key (replaying the trajectory that just
        # diverged would diverge again); the host's mirror of the key
        # chain moves with it
        salt = 0x5EED + rollbacks
        state = dataclasses.replace(
            restored, rng=prng.fold_in(restored.rng, salt),
            rng_host=(None if restored.rng_host is None
                      else prng.fold_in_words(restored.rng_host, salt)))
        steps_host, datapoints_host = int(state.steps), int(state.datapoints)
        current_lr = args.initial_lr(steps_host)
        just_loaded = True
        if results is not None:
            results.truncate(steps_host)
            fd_eval, fd_study = results.get("eval"), results.get("study")
        utils.warning(f"Rollback #{rollbacks}/{args.rollback_budget}: "
                      f"{trigger} health trigger; restored {found.name} "
                      f"(step {steps_host})")
        if telem is not None:
            telem.counter("rollbacks")
            telem.event("rollback", step=steps_host, restored=found.name,
                        trigger=trigger,
                        budget_left=args.rollback_budget - rollbacks)
            telem.heartbeat(step=steps_host, status="rolled-back",
                            **health_hb())
        if args.rollback_tighten_quorum:
            tighten_quorum()
        return True

    def recover(trigger, step):
        """A health trigger at `step`: the flag event, the blackbox, then
        the rollback (its reload and rebuild kept off the throughput
        clock), or the give-up; returns whether the run goes on. The
        caller drops the flagged chunk's rows after a rollback; after a
        give-up they are written, as the JAX driver writes them."""
        nonlocal diverged, steps_host
        if telem is not None:
            telem.event("health_flag", step=step, trigger=trigger)
        if monitor is not None:
            # The post-mortem before the trajectory rewinds
            monitor.dump_blackbox(args.result_directory, reason=trigger)
        t_pause = time.perf_counter()
        back = roll_back(trigger, step)
        if clock is not None:
            clock[1] += time.perf_counter() - t_pause
        if back:
            if monitor is not None:
                monitor.note_rollback()
            return True
        if telem is not None:
            telem.event("divergence_giveup", step=step)
        if monitor is not None:
            monitor.dump_blackbox(args.result_directory,
                                  reason="divergence_giveup")
        diverged, steps_host = True, step
        return False

    def attribute_window(trace_dir, steps, out_dir):
        """Attribute one closed trace window into `out_dir`'s
        `attribution.json` (and an `attribution` event); a warning where
        the trace cannot be read."""
        try:
            att = obs.attrib.attribute_trace(
                trace_dir, steps, flops_per_step=mfu_flops or None,
                peak_flops=mfu_peak, backend=device.type,
                device_kind=device_kind)
        except (FileNotFoundError, ValueError) as err:
            utils.warning(f"Attribution of {str(trace_dir)!r} failed "
                          f"({err})")
            return None
        path = obs.attrib.write_attribution(out_dir, att)
        if telem is not None:
            telem.event(
                "attribution", path=str(path), steps=steps,
                total_ms=att["total_ms"],
                relayout_ms=att["op_classes"]["relayout"],
                host_gap_fraction=att["host_gap_fraction"], mfu=att["mfu"],
                phases={k: round(v["ms"], 5)
                        for k, v in att["phases"].items() if v["ms"] > 0.0})
        utils.info(f"Attribution: {att['total_ms']:.3f} ms/step over {steps} "
                   f"traced steps -> {str(path)!r}")
        return att

    # --attribution: one traced chunk, the first whose step count M has
    # already run once (the first chunk of each M carries its one-time
    # costs: the kernels' build, cuDNN's plans), so the window is the same
    # steps in every run; (session, directory, M) while it is open
    attrib_armed = args.attribution
    attrib_seen_m = set()
    attrib_window = None
    # A SIGUSR1 window: (session, directory, from step) while open
    profile_active = None
    trace_session = None
    if args.trace_dir is not None:
        trace_session = _start_profiler(pathlib.Path(args.trace_dir), device,
                                        "--trace-dir")
        if trace_session is not None:
            obs.emit("profiler_trace_start", directory=str(args.trace_dir))

    # The last dispatched chunk, its rows, key, flag and sample still to
    # be read
    pending = None
    mirrored = engine.mixture and not engine.per_call
    clock = None            # (start, paused seconds) once chunk 1 is done
    timed_from = None       # the steps run the throughput counts from
    current_lr = args.initial_lr(steps_host)
    just_loaded = args.load_checkpoint is not None
    with utils.Context("training"):
        try:
            while not signals.exit_requested():
                steps = steps_host
                if chaos.kill is not None and steps >= chaos.kill:
                    os.kill(os.getpid(), signal.SIGKILL)
                milestone_eval = (args.evaluation_delta > 0
                                  and steps % args.evaluation_delta == 0)
                milestone_checkpoint = (args.checkpoint_delta > 0
                                        and steps % args.checkpoint_delta == 0)
                milestone_user_input = (args.user_input_delta > 0
                                        and steps % args.user_input_delta == 0)
                milestone = (milestone_eval or milestone_checkpoint
                             or milestone_user_input)
                at_end = steps_limit is not None and steps >= steps_limit
                # The health verdict (--rollback-budget) before any
                # milestone or the end reads the state, so none sees a
                # poisoned one, the hard signal first: the last chunk's
                # isfinite flag, then the monitor's anomaly edge
                # (--rollback-on-anomaly). Between milestones the flag is
                # read with the chunk's rows, once the next one is queued
                trigger = None
                if (args.rollback_on_anomaly and monitor is not None
                        and monitor.rollback_pending()):
                    trigger = "anomaly"
                if ((trigger is not None or milestone or at_end)
                        and pending is not None and pending.poisoned()):
                    trigger = "non-finite"
                if trigger is not None:
                    if not recover(trigger, steps):
                        break
                    pending = None  # its rows are dropped, not flushed
                    continue
                t_pause = time.perf_counter()
                if milestone:
                    # The rows before this step reach the disk before a
                    # checkpoint can be taken
                    flush(pending)
                    pending = None
                milestone_checkpoint = milestone_checkpoint and not just_loaded
                # The samplers' snapshot before the evaluation draws, so a
                # resumed run replays this step's evaluation
                data_snapshot = ({"train": engine.train_data.dataset.get_state(),
                                  "test": engine.test_data.dataset.get_state()}
                                 if milestone_checkpoint else None)
                if milestone_eval:
                    # `tolist` waits for the result: the span is the
                    # evaluation's whole time
                    with obs.span("eval", step=steps):
                        correct, total = engine.eval_many_indexed(
                            state.theta, state.net_state,
                            *engine.test_data.sample_indices(
                                args.batch_size_test_reps)).tolist()
                    acc = correct / total
                    utils.info(f"Accuracy (step {steps}): {acc * 100.:.2f}%")
                    if fd_eval is not None:
                        results.store(fd_eval, steps, acc)
                if milestone_checkpoint:
                    try:
                        checkpoint_mod.save(
                            args.result_directory / f"checkpoint-{steps}",
                            state, data_state=data_snapshot,
                            keep=args.keep_checkpoints or None,
                            mirror=args.checkpoint_mirror)
                    except OSError as err:
                        # A failed write (a full disk) does not end the
                        # run; the next milestone tries again
                        utils.warning(f"Checkpoint save failed: {err}")
                just_loaded = False
                if telem is not None and (milestone_eval
                                          or milestone_checkpoint):
                    telem.heartbeat(step=steps, status="running",
                                    steps_per_sec=rate_window.rate(),
                                    **health_hb())
                if milestone_user_input:
                    sync()  # the chunk before the prompt is drained
                    code.interact(banner=f"Interactive prompt (step {steps}); "
                                  "Ctrl-D to resume",
                                  local={"state": state, "engine": engine})
                if clock is not None:
                    clock[1] += time.perf_counter() - t_pause
                if at_end:
                    break
                if signals.profile_request and profile_active is None:
                    # SIGUSR1: the live-debug hook, a one-chunk window
                    signals.profile_request = False
                    if monitor is not None:
                        monitor.dump_blackbox(args.result_directory,
                                              reason="sigusr1")
                    if args.result_directory is None:
                        utils.warning("SIGUSR1 profiling needs "
                                      "'--result-directory'; ignored")
                    else:
                        pdir = args.result_directory / f"profile-{steps}"
                        session = _start_profiler(pdir, device, "SIGUSR1")
                        if session is not None:
                            profile_active = (session, pdir, steps)
                            utils.info(f"SIGUSR1: profiling one chunk into "
                                       f"{str(pdir)!r}")
                # The chunk runs to the next milestone boundary, at most
                # --steps-per-program steps (the JAX driver's horizon)
                bounds = [(steps // delta + 1) * delta
                          for delta in (args.evaluation_delta,
                                        args.checkpoint_delta,
                                        args.user_input_delta) if delta > 0]
                if steps_limit is not None:
                    bounds.append(steps_limit)
                horizon = min(bounds, default=steps + per_program)
                M = max(1, min(per_program, horizon - steps))
                # Per-step learning rates over the chunk, as an f32 array
                lrs = []
                for step in range(steps, steps + M):
                    new_lr = args.compute_new_learning_rate(step)
                    if new_lr is not None:
                        current_lr = new_lr
                    lrs.append(current_lr)
                # One draw of the chunk's batches (under --device-gar in
                # the order of the JAX driver's host-staged batches)
                idx, flips = engine.sample_indices(M, batchwise=hop is not None)
                if (attrib_armed and attrib_window is None
                        and M in attrib_seen_m and profile_active is None):
                    # The window holds this chunk alone: the device is
                    # drained before it opens
                    sync()
                    adir = args.result_directory / "attribution-trace"
                    session = _start_profiler(adir, device, "--attribution")
                    if session is None:
                        attrib_armed = False
                    else:
                        attrib_window = (session, adir, M)
                        utils.info(f"--attribution: tracing one {M}-step "
                                   f"chunk into {str(adir)!r}")
                # A telemetry sample times the chunk on the device; an
                # attribution window forces one on the chunk it traces
                measure = telem is not None and (
                    steps_host >= next_sample_step
                    or attrib_window is not None)
                begin = step_timer.mark() if measure else None
                lrs = np.asarray(lrs, np.float32)
                if (telem is not None and args.telemetry_mfu
                        and mfu_flops is None):
                    # The first chunk runs under the FLOP counter (it
                    # only counts); False: tried and failed, not retried
                    (state, metrics), flops = obs.logical_flops(
                        engine.train_multi_indexed, state, idx, flips, lrs,
                        step=hop)
                    mfu_flops = flops / M if flops else False
                    if mfu_flops:
                        telem.event("flops_per_step", flops=mfu_flops)
                else:
                    state, metrics = engine.train_multi_indexed(
                        state, idx, flips, lrs, step=hop)
                timed = (begin, step_timer.mark()) if measure else None
                steps_host += M
                datapoints_host += M * increment
                steps_run += M
                attrib_seen_m.add(M)
                if attrib_window is not None or profile_active is not None:
                    # A window closes on the chunk it covers (drained),
                    # not one chunk later with its rows; its reading is
                    # kept off the throughput clock
                    t_pause = time.perf_counter()
                    sync()
                    if attrib_window is not None:
                        session, adir, a_steps = attrib_window
                        attrib_window, attrib_armed = None, False
                        if _stop_profiler(session, "--attribution"):
                            attribute_window(adir, a_steps,
                                             args.result_directory)
                    if profile_active is not None:
                        session, pdir, pstep = profile_active
                        profile_active = None
                        _stop_profiler(session, "SIGUSR1")
                        if telem is not None:
                            telem.event("profiler_window",
                                        directory=str(pdir), from_step=pstep,
                                        to_step=steps_host)
                        utils.info(f"SIGUSR1: profiler window saved to "
                                   f"{str(pdir)!r}")
                        attribute_window(pdir, steps_host - pstep, pdir)
                    if clock is not None:
                        clock[1] += time.perf_counter() - t_pause
                if telem is not None:
                    rate_window.update(steps_run)
                if measure:
                    next_sample_step = steps_host + telem.interval
                state = chaos.poison(state, steps_host)
                chunk = _Chunk(
                    metrics if cfg.study else None, steps,
                    datapoints_host - M * increment, M,
                    (state.rng if mirrored else None, state.rng_host),
                    rollbacks, timed=timed,
                    # max |theta| is non-finite iff a coordinate is: a
                    # scalar read with the chunk's rows
                    flag=(torch.isfinite(state.theta.abs().max())
                          if args.rollback_budget > 0 else None))
                # The previous chunk's verdict and rows, now that this one
                # is queued (a poisoned one: this chunk ran on its state)
                if pending is not None and pending.poisoned():
                    if not recover("non-finite", pending.end):
                        break
                    pending = None  # its rows are dropped, not flushed
                    continue
                flush(pending)
                pending = chunk
                if clock is None:
                    sync()
                    clock = [time.perf_counter(), 0.0]
                    timed_from = steps_run
        finally:
            flush(pending)
            if results is not None:
                results.close()
            # A window an exception left open, then the --trace-dir session
            for window, what in ((attrib_window, "--attribution"),
                                 (profile_active, "SIGUSR1")):
                if window is not None:
                    _stop_profiler(window[0], what)
            if trace_session is not None:
                obs.emit("profiler_trace_stop", directory=str(args.trace_dir))
                _stop_profiler(trace_session, "--trace-dir")
    sync()
    timed = 0 if timed_from is None else steps_run - timed_from
    rate = None
    if timed > 0:
        rate = timed / (time.perf_counter() - clock[0] - clock[1])
        utils.info(f"Throughput: {rate:.3f} steps/s over the last {timed} of "
                   f"{steps_run} steps run on {device}")
    status = ("diverged" if diverged
              else "interrupted" if signals.exit_requested()
              else "completed")
    if monitor is not None and monitor.steps > 0 and not diverged:
        # Every recorded run leaves a post-mortem; a diverged one keeps
        # its divergence_giveup dump
        monitor.dump_blackbox(args.result_directory, reason="run_end")
    if telem is not None:
        if tracker is not None and tracker.steps > 0:
            telem.event("forensics_summary", **tracker.summary())
        if monitor is not None and monitor.steps > 0:
            telem.event("health_summary", **monitor.summary())
        telem.event("run_end", step=steps_host, status=status,
                    rollbacks=rollbacks, restarts=restarts)
        telem.heartbeat(step=steps_host, status=status,
                        steps_per_sec=rate_window.rate(), **health_hb())
    return {"steps": steps_host, "device": str(device), "steps_per_s": rate,
            "steps_run": steps_run, "rollbacks": rollbacks,
            "diverged": diverged, "status": status,
            "cut_short": (status == "interrupted" and steps_limit is not None
                          and steps_host < steps_limit),
            "result_directory": args.result_directory,
            "resume_step": resume_step, "counts": dict(engine.counts)}


def main(argv=None):
    """Command-line entry, with the signal latches (`Signals`) installed
    for the run: 0 on success, 1 on a user error or a run that gave up on
    its divergence (its rollback budget spent), 130 for a bounded run
    that SIGINT or SIGTERM cut short (a supervisor must not take its
    directory for a finished run's)."""
    signals = Signals()
    previous = signals.install()
    try:
        summary = run(argv, signals=signals)
    except utils.UserException as err:
        utils.error(f"Error: {err}")
        return 1
    finally:
        Signals.restore(previous)
    if summary["diverged"]:
        return 1
    return 130 if summary["cut_short"] else 0


if __name__ == "__main__":
    sys.exit(main())
