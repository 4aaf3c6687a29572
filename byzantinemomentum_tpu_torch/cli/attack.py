"""The experiment driver (`byzantinemomentum_tpu/cli/attack.py`, the flags
of the training path ported so far).

Flags keep the JAX driver's names and defaults, except `--device`, which
defaults to `cuda`: `--device cpu` is the only way onto the CPU, and with
no card and no such request the driver exits with an error. Flags of the
JAX driver that the port does not have yet (meshes, health and
rollbacks, telemetry, ...) are refused by the parser rather than
ignored.

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

The `eval` and 24-column `study` CSVs have the JAX driver's headers and
row format byte for byte ('# '-prefixed tab-separated header, rows
prefixed with the line separator, values at the parameter dtype's
precision), so `study.py` reads the port's result directories unchanged.
"""

import argparse
import code
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
    DTYPES, FAULT_COLUMNS, FORENSIC_COLUMNS, RECOVERY_COLUMNS, STUDY_COLUMNS,
    Engine, EngineConfig)
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
    if args.gar_diagnostics and (args.result_directory is None
                                 or args.nb_for_study < 1):
        utils.warning("'--gar-diagnostics' needs the study pipeline "
                      "('--nb-for-study' with '--result-directory'); "
                      "diagnostics disabled")
        args.gar_diagnostics = False
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
    numbers go), so the rows on disk stay one trajectory."""

    def __init__(self, directory):
        self.directory = directory
        self._fds = {}

    def make(self, name, *fields, resume_step=None):
        header = "# " + "\t".join(str(field) for field in fields)
        path = self.directory / name
        kept = ()
        if resume_step is not None and path.is_file():
            kept = self._surviving_rows(path, header, resume_step)
        fd = path.open("w")
        fd.write(header)
        for row in kept:
            fd.write(os.linesep + row)
        fd.flush()
        self._fds[name] = fd

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


def _study_rows(metrics, steps, datapoints, increment, count, float_format,
                rng=None, recovery=(), tracker=None):
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
    and the tracker folds the steps in order."""
    columns = STUDY_COLUMNS[2:] if metrics is not None else ()
    faulted = bool(columns) and FAULT_COLUMNS[0] in metrics
    forensic = bool(columns) and tracker is not None
    ints = FAULT_COLUMNS if faulted else ()
    scalars = columns + ints + (FORENSIC_SCALARS if forensic else ())
    parts = [torch.stack([metrics[column].double() for column in scalars])
             .flatten()] if columns else []
    vectors = [name for name in FORENSIC_VECTORS
               if forensic and name in metrics]
    parts += [metrics[name].double().flatten() for name in vectors]
    if rng is not None:
        parts.append(rng.double())
    if not parts:
        return [], None
    host = torch.cat(parts).tolist()
    words = tuple(int(word) for word in host[-2:]) if rng is not None else None
    table = [host[k * count:(k + 1) * count] for k in range(len(scalars))]
    if forensic:
        n = tracker.nb_workers
        start = len(scalars) * count
        vector = {name: np.asarray(host[start + k * count * n:
                                        start + (k + 1) * count * n]
                                   ).reshape(count, n)
                  for k, name in enumerate(vectors)}
    rows = []
    for i in range(count if columns else 0):
        row = [steps + i, datapoints + i * increment]
        row += [float_format % values[i] for values in table[:len(columns) - 1]]
        row.append(float(table[len(columns) - 1][i]))
        row += [int(values[i]) for values in
                table[len(columns):len(columns) + len(ints)]]
        row += recovery
        if forensic:
            sel = vector["Sel mask"][i]
            selected = np.nonzero(sel > 0)[0]
            row.append(";".join(str(w) for w in selected) or "-")
            row += [float_format % values[i]
                    for values in table[len(columns) + len(ints):]]
            active = vector["Active mask"][i] if "Active mask" in vector else None
            tracker.update(steps + i, sel, distances=vector["Worker dist"][i],
                           active=active)
            row.append(float_format % tracker.max())
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
        gar_diagnostics=args.gar_diagnostics,
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
    trainset, testset = data_mod.make_datasets(
        args.dataset, args.batch_size, args.batch_size_test,
        no_transform=args.no_transform, seed=seed % 2**32,
        **args.dataset_args)
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
        # is on, its forensic columns under diagnostics
        columns = (STUDY_COLUMNS
                   + (FAULT_COLUMNS if faulted else ())
                   + (RECOVERY_COLUMNS if args.auto_resume else ())
                   + (FORENSIC_COLUMNS if args.gar_diagnostics else ()))
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


def run(argv=None):
    """Run one experiment. Returns a summary dict: `steps`, `device`,
    `steps_per_s` (training steps per second over the steps after the
    first chunk, whose time includes one-time set-up such as the kernel
    build; evaluations and checkpoints excluded; None when the first
    chunk is the last), `result_directory`, `resume_step` (None on a
    cold start) and `counts` (the engine's counts of indexed steps and
    evaluations, of grouped and vmapped honest phases, of multi-step
    dispatches (chunks of more than one step) and of `--device-gar` hop
    steps)."""
    with utils.Context("cmdline"):
        args = _postprocess(process_commandline(argv))
    with utils.Context("setup"):
        device, engine, state = _setup(args)
        results, resume_step, restarts = _open_results(
            args, faulted=engine.faults is not None)
    if args.load_checkpoint is not None:
        with utils.Context("load"):
            state = _load(args, engine, state)
    cfg = engine.cfg
    float_format = FLOAT_FORMATS[cfg.torch_dtype]
    fd_eval = results.get("eval") if results else None
    fd_study = results.get("study") if results else None
    recovery = (0, restarts) if args.auto_resume else ()
    # The suspicion tracker of --gar-diagnostics (not checkpointed, as in
    # the JAX driver)
    tracker = (obs.SuspicionTracker(args.nb_workers) if engine.diagnostics
               else None)
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
    chaos_kill = os.environ.get("BMT_CHAOS_KILL_AT_STEP")
    chaos_kill = int(chaos_kill) if chaos_kill else None
    per_program = max(args.steps_per_program, 1)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def flush(pending):
        """The previous chunk's study rows to the file, and under a
        per-step mixture its key against the host's mirror."""
        if pending is None:
            return
        *chunk, (rng, rng_host) = pending
        rows, words = _study_rows(*chunk, float_format, rng=rng,
                                  recovery=recovery, tracker=tracker)
        if fd_study is not None:
            for row in rows:
                results.store(fd_study, *row)
        if words is not None and words != tuple(rng_host):
            raise RuntimeError(f"the host's mirror of the key chain "
                               f"{tuple(rng_host)} differs from the "
                               f"device's key {words} after step "
                               f"{chunk[1] + chunk[-1]}")

    # The previous chunk's (metrics, step, points, increment, M, (key,
    # mirror)) while its rows or its key are still to be read
    pending = None
    mirrored = engine.mixture and not engine.per_call
    clock = None            # (start, paused seconds) once chunk 1 is done
    timed_from = None       # the step count the throughput counts from
    current_lr = args.initial_lr(steps_host)
    just_loaded = args.load_checkpoint is not None
    with utils.Context("training"):
        try:
            while True:
                steps = steps_host
                if chaos_kill is not None and steps >= chaos_kill:
                    os.kill(os.getpid(), signal.SIGKILL)
                milestone_eval = (args.evaluation_delta > 0
                                  and steps % args.evaluation_delta == 0)
                milestone_checkpoint = (args.checkpoint_delta > 0
                                        and steps % args.checkpoint_delta == 0
                                        and not just_loaded)
                milestone_user_input = (args.user_input_delta > 0
                                        and steps % args.user_input_delta == 0)
                t_pause = time.perf_counter()
                if milestone_eval or milestone_checkpoint or milestone_user_input:
                    # The rows before this step reach the disk before a
                    # checkpoint can be taken
                    flush(pending)
                    pending = None
                # The samplers' snapshot before the evaluation draws, so a
                # resumed run replays this step's evaluation
                data_snapshot = ({"train": engine.train_data.dataset.get_state(),
                                  "test": engine.test_data.dataset.get_state()}
                                 if milestone_checkpoint else None)
                if milestone_eval:
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
                if milestone_user_input:
                    sync()  # the chunk before the prompt is drained
                    code.interact(banner=f"Interactive prompt (step {steps}); "
                                  "Ctrl-D to resume",
                                  local={"state": state, "engine": engine})
                if clock is not None:
                    clock[1] += time.perf_counter() - t_pause
                if steps_limit is not None and steps >= steps_limit:
                    break
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
                state, metrics = engine.train_multi_indexed(
                    state, idx, flips, np.asarray(lrs, np.float32), step=hop)
                steps_host += M
                datapoints_host += M * increment
                # The previous chunk's rows move to the host once this
                # one is queued
                flush(pending)
                pending = ((metrics if cfg.study else None, steps,
                            datapoints_host - M * increment, increment, M,
                            (state.rng if mirrored else None, state.rng_host))
                           if cfg.study or mirrored else None)
                if clock is None:
                    sync()
                    clock = [time.perf_counter(), 0.0]
                    timed_from = steps_host
        finally:
            flush(pending)
            if results is not None:
                results.close()
    sync()
    timed = 0 if timed_from is None else steps_host - timed_from
    rate = None
    if timed > 0:
        rate = timed / (time.perf_counter() - clock[0] - clock[1])
        utils.info(f"Throughput: {rate:.3f} steps/s over the last {timed} of "
                   f"{steps_host} steps on {device}")
    return {"steps": steps_host, "device": str(device), "steps_per_s": rate,
            "result_directory": args.result_directory,
            "resume_step": resume_step, "counts": dict(engine.counts)}


def main(argv=None):
    """Command-line entry: 0 on success, 1 on a user error."""
    try:
        run(argv)
    except utils.UserException as err:
        utils.error(f"Error: {err}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
