"""The training step (`byzantinemomentum_tpu/engine/step.py`).

One call to `Engine.train_step(state, xs, ys, lr)` performs one iteration
of the reference's hot loop, in three phases as in the JAX package (after
the step's keys, `step_keys`); `Engine.train_multi(state, xs, ys, lrs)`
runs M of them on a chunk's batches and learning rates, the JAX
`lax.scan` program (see "Fused dispatch" below):

  honest  — the S per-worker losses and gradients as one batched program,
            with the Nesterov lookahead variants: the grouped program
            (`_worker_grads_grouped`, the JAX package's default) for
            models with a grouped forward unless
            `cfg.grouped_workers` is off, else
            `torch.func.vmap(grad(functional_call))` over the worker axis;
            with `cfg.nb_local_steps` k > 1 each worker takes k local SGD
            steps on k batches and submits its displacement over the
            learning rate (`_local_steps`, always vmapped, as in the JAX
            package);
            per-row L2 clipping;
            the sequential-equivalent BatchNorm running-stat fold; the
            momentum placement on the honest rows;
  defense — Byzantine row synthesis (an adaptive attack line-searches
            the GAR; a stateful one threads `TrainState.attack_state`),
            aggregation by the GAR, and the attack acceptation ratio;
  update  — SGD with weight decay and the 24-column study metrics.

Precision (`pin_precision`): TF32 is switched off for matmuls and for
cuDNN convolutions (which default to it), because the f32 GAR space is an
f32 contract (its distance orderings drive Bulyan's selection); and half
matmuls accumulate in f32 (cuBLAS's reduced-precision bf16/f16
reductions are switched off).

Dtypes, as in the JAX package (`cfg.dtype`, `cfg.compute_dtype`): the
parameters, state, gradients and so the GAR stack are in the parameter
dtype; the forward and backward run in the compute dtype (inputs and
parameters cast on entry, so a mixed-precision gradient comes back in the
parameter dtype); the BatchNorm running-stat fold runs at
`promote_types(dtype, float32)`; the learning rate is a 0-d tensor on
the engine's device rounded to the parameter dtype (`round_lr`); the
attack rows and the aggregate are cast back to the honest rows' dtype.
Python scalars (momentum, dampening, clip, weight decay) are rounded to
the parameter dtype before they meet a tensor (`weak`,
`utils.weak_scalar`), as JAX applies a weak-typed scalar.

Fused dispatch (`byzantinemomentum_tpu/engine/step.py:285-303`): a step
reads nothing on the host, so M of them queue back to back. The
acceptation ratio is an f32 0-d tensor (NaN for a GAR without
influence), `TrainState.past_count` and a stateful attack's state are
device tensors, the line search keeps its state on the device
(`ops/linesearch.py`) and the learning rate is a device tensor.
`train_multi(state, xs, ys, lrs)` and `train_multi_indexed(state, idx,
flips, lrs)` take a chunk of M steps (`[M, S, B, ...]` batches or host
indices, `lrs f32[M]` on the host), upload the chunk's indices, flips and
rates once and return the state and every study column stacked as a
device tensor `[M]` (`stack_metrics`), the JAX scan's outputs.

Device-resident batches (`attach_data`, `data/device.py`): the driver's
default path. `train_step_indexed(state, idx, flips, lr)` and
`eval_many_indexed` take a step's host indices and flips, upload them
and gather the batch on the device. `Engine.counts` counts indexed steps
and evaluations, grouped and vmapped honest phases and multi-step
dispatches (`multi_dispatches`), so a run can show which path it took.

Randomness: the JAX package's key tree. `init(key)` sets
`TrainState.rng` to `fold_in(key, 1)` (the driver's key is
`PRNGKey(seed)`); each step splits it into `S + 2` keys (`step_keys`, the
JAX step's `rng, mix_key, *wkeys = split(state.rng, S + 2)`), keeps the
first as the next state's key and draws worker s's dropout keep-masks
from `wkeys[s]` (`model.draw_masks`), so the same seed gives the JAX
run's masks bit for bit (at k local steps, local step t's from key t of
`split(wkeys[s], k)`, `draw_masks`). `mix_key` feeds the `--gars`
mixture. `train_step(..., masks=...)` takes the masks from the caller
instead (the parity tests feed the JAX masks).

The defense (`engine/program.py::defense_program`): one GAR (`--gar`), or
a `--gars` mixture of `(gar, cumulative frequency, kwargs)` members. By
default the mixture draws once a step: `uniform(mix_key)` picks the
member for the attack's inner calls, the aggregation and the influence
(the JAX package's divergence from the reference, which redraws at every
call, `byzantinemomentum_tpu/engine/step.py:490-509`). The host mirrors
the key chain (`TrainState.rng_host`, `mirror_keys`: the step's first
two keys and the uniform, in Python ints) and runs only the drawn
member, which is what `lax.switch` runs, with no read of the device; the
driver compares the mirror with the device's key at each chunk's end.
`cfg.gars_per_call` (`--gars-per-call`, the reference's semantics)
draws at every defense call from `fold_in(mix_key, h)`, h the content
hash of the call's operand (the influence from `fold_in(mix_key, 1)`'s):
the draw depends on device data, so it stays on the device
(`ops/mixture_kernels.py`: `operand_hash`, then `mixture_draw`), every
member runs and the drawn one is picked (`program.select`). Two calls
on byte-identical operands within a step draw the same member, where the
reference's `random.random()` would draw twice: the JAX package's note
holds here too (no shipped attack probes twice with the same operand).

GAR diagnostics (`cfg.gar_diagnostics` with the study on, the JAX
`_run_defense_diag`): the outer aggregation runs the "diag" program
(`defense_program(..., "diag")`: each rule's diagnose form, one call
giving the aggregate, bit for bit the plain one, and the aux), and
`engine/metrics.py::forensic_metrics` digests the aux on the device; the
attack's calls, line-search probes included, stay on the plain program.
The forensic values join the step's metrics (`phase_update`), and
`stack_metrics` stacks the vectors among them to `[M, n]`. With the flag
off the step runs no code of `ops/diag.py`.

Fault plans (`Engine(..., faults=schedule)`, `faults/`, the JAX
`engine/step.py:661-786`): every step of a run with a schedule ends its
honest phase with the injection (`phase_faults`: the step's fault rows,
picked on the host from `TrainState.steps` and uploaded in one copy, a
chunk's M rows at once; duplication, staleness, corruption and absence
on the honest rows, never on the momentum buffers; the straggler buffer
`TrainState.fault_buffer` refreshed from the clean rows), and its
defense takes the "masked" program (`program.defense_program(...,
"masked")`, the dynamic quorum of `faults/quorum.py`) on the active rows,
after quarantining the non-finite ones (`cfg.fault_quarantine`), even on
a step where no fault is live (the masked forms sum in another order
than the static ones). The line search's probes of n rows take the
masked program on the step's active mask too. The step's metrics gain
`Faults injected`, `Workers active` and `Quorum f` (0-d int32), and
under `--gar-diagnostics` the diag program re-runs on the full stack,
its forensic values joined by the post-quarantine `Active mask`. A
schedule of None (an empty plan) is the fault-free step.

The health vector (`cfg.health` with the study on, `--health`, the JAX
`engine/step.py:857-872`): `phase_update` merges `engine/health.py::
health_metrics` into the step's metrics after the update, reusing the
study's sums of squares; `stack_metrics` stacks it to `[M]` and `Norm
hist` to `[M, 16]`, and under `--device-gar` it is computed with the
update on the engine's device, after the hop back. With the flag off the
step runs no code of `engine/health.py`.
"""

import collections
import math

import numpy as np
import torch
from torch.func import functional_call, grad, vmap

from byzantinemomentum_tpu_torch import prng
from byzantinemomentum_tpu_torch.data.device import to_device
from byzantinemomentum_tpu_torch.engine import health as health_mod
from byzantinemomentum_tpu_torch.engine import metrics as metrics_mod
from byzantinemomentum_tpu_torch.engine import program
from byzantinemomentum_tpu_torch.engine.program import tree_to
from byzantinemomentum_tpu_torch.engine.state import TrainState, init_state
from byzantinemomentum_tpu_torch.faults import inject as inject_mod
from byzantinemomentum_tpu_torch.faults import sanitize
from byzantinemomentum_tpu_torch.models import FlatParams, grouped_forward
from byzantinemomentum_tpu_torch.models.core import BN_MOMENTUM
from byzantinemomentum_tpu_torch.ops import mixture_kernels, prng_kernels
from byzantinemomentum_tpu_torch.utils import weak_scalar

__all__ = ["Engine", "clip_rows", "compose_bn_updates", "pin_precision",
           "stack_metrics"]


def pin_precision():
    """Switch TF32 off for CUDA matmuls and cuDNN convolutions, and the
    reduced-precision reductions of bf16 and f16 matmuls (on by default
    in PyTorch), so that half matmuls accumulate in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False


def clip_rows(G, clip):
    """Per-row L2 clip: row *= clip/||row|| iff ||row|| > clip (the clip
    rounded to G's dtype, as JAX applies the Python scalar)."""
    if clip is None:
        return G
    clip = weak_scalar(clip, G.dtype)
    norms = torch.sqrt(torch.sum(G * G, dim=1, keepdim=True))
    return G * torch.where(norms > clip, clip / norms, 1.0)


def compose_bn_updates(net_state0, per_worker_states, count, local_steps=1):
    """Sequential-equivalent composition of per-worker BatchNorm running
    stats.

    The reference runs workers one after the other through one module, so
    the stats fold as r_k = (1-m) r_{k-1} + m s_k over the k-th worker's
    batch stats. Batched, every worker computed an r0-based chain instead;
    inverting each for its batch stats and refolding in worker-major order
    gives the sequential result
      r_T = (1-m)^T r0 + m * sum_t (1-m)^(T-1-t) s_t,  T = count*local_steps.
    `per_worker_states` maps each buffer name to its (count, ...) stack,
    or with local steps to its (count, local_steps, ...) stack of each
    worker's chain of running states (all rooted at r0). The inversion is
    precision-sensitive: it runs at `promote_types(dtype, float32)` and
    the result is cast back to the state's dtype.
    """
    m = BN_MOMENTUM
    total = count * local_steps
    out = {}
    for name, r0 in net_state0.items():
        acc = torch.promote_types(r0.dtype, torch.float32)
        stack = per_worker_states[name].to(acc)
        weights = (torch.full((), 1.0 - m, dtype=acc, device=r0.device)
                   ** torch.arange(total - 1, -1, -1, dtype=acc,
                                   device=r0.device))
        r0a = r0.to(acc)
        if local_steps == 1:
            s = (stack - (1.0 - m) * r0a) / m  # per-worker batch stats
        else:
            # Invert each worker's chain: new[j] = (1-m) new[j-1] + m s[j]
            prev = torch.cat([r0a.expand_as(stack[:, :1]), stack[:, :-1]],
                             dim=1)
            s = ((stack - (1.0 - m) * prev) / m).reshape(total, *r0.shape)
        contrib = torch.tensordot(weights, s, dims=1)
        out[name] = ((1.0 - m) ** total * r0a + m * contrib).to(r0.dtype)
    return out


def stack_metrics(steps):
    """The study columns of M steps' metric dicts as device tensors `[M]`
    (`[M, n]` for the forensic vectors, `[M, HIST_BINS]` for the health
    vector's `Norm hist`); `{}` where the steps computed
    none. A column is a tensor in every step
    or a Python NaN in every step (the attack columns without a Byzantine
    row, a deviation over one row): the latter becomes an f32 NaN
    column."""
    if not steps or not steps[0]:
        return {}
    device = next(value.device for value in steps[0].values()
                  if isinstance(value, torch.Tensor))
    out = {}
    for column, first in steps[0].items():
        out[column] = (torch.stack([metrics[column] for metrics in steps])
                       if isinstance(first, torch.Tensor)
                       else torch.full((len(steps),), math.nan, device=device))
    return out


class Engine:
    """The training and evaluation programs of one configuration."""

    def __init__(self, cfg, model, loss, criterion, defenses, attack,
                 attack_kwargs, optimizer, faults=None):
        """The engine draws no random number of its own: every draw of a
        step comes from `TrainState.rng` (`init`, `step_keys`).

        Args:
          cfg: `EngineConfig`.
          model: the model `nn.Module` (`models.build`), on the run's device.
          loss: `(output, target, theta) -> scalar`.
          criterion: `(output, target) -> f32[2]`.
          defenses: a list of `(gar, cumulative frequency, kwargs)`: the
            aggregation rules and their arguments, one for `--gar`, the
            members of a `--gars` mixture.
          attack: `attacks.Attack` (unused when no worker is Byzantine).
          attack_kwargs: the attack's arguments.
          optimizer: `optim.Optimizer` applying the final update.
          faults: a `faults.schedule.FaultSchedule`, or None (no plan, or
            an empty one): the fault-free step.
        """
        pin_precision()
        self.cfg = cfg
        self.dtype = cfg.torch_dtype
        self.compute_dtype = cfg.torch_compute_dtype
        self.model = model
        self.flat = FlatParams(model)
        self.d = self.flat.d
        self.loss = loss
        self.criterion = criterion
        self.defenses = list(defenses)
        self.mixture = len(self.defenses) > 1
        self.per_call = cfg.gars_per_call and self.mixture
        self.defense = program.defense_program(self.defenses, "plain",
                                               f=cfg.nb_decl_byz)
        # The outer aggregation's diagnose program (`--gar-diagnostics`)
        self.diagnostics = cfg.gar_diagnostics and cfg.study
        self.defense_diag = (program.defense_program(
            self.defenses, "diag", f=cfg.nb_decl_byz)
            if self.diagnostics else None)
        # The defense of a step with a fault schedule (the dynamic quorum)
        self.faults = faults
        self.defense_masked = (program.defense_program(
            self.defenses, "masked", f=cfg.nb_decl_byz,
            dynamic=cfg.fault_dynamic_quorum) if faults is not None else None)
        self._cumulative = {}  # the mixture's frequencies, by device
        self.attack = attack
        self.attack_kwargs = dict(attack_kwargs or {})
        self.optimizer = optimizer
        self.device = next(model.parameters()).device
        # The grouped honest phase where the JAX package takes it: the
        # config asks for it, the model has a grouped forward and a worker
        # takes one local step
        self.grouped = (grouped_forward(model)
                        if cfg.grouped_workers and cfg.nb_local_steps == 1
                        else None)
        self.train_data = self.test_data = None
        self.counts = collections.Counter()

    def attach_data(self, train_data, test_data):
        """Enable the device-resident input path (`data/device.py`)."""
        self.train_data, self.test_data = train_data, test_data
        return self

    def with_config(self, cfg):
        """This engine's model, loss, criterion, defenses, attack,
        optimizer and fault schedule under another configuration (the
        driver's `--rollback-tighten-quorum` rebuild), with the same data
        attached and the same `counts` carried on."""
        engine = Engine(cfg, self.model, self.loss, self.criterion,
                        self.defenses, self.attack, self.attack_kwargs,
                        self.optimizer, faults=self.faults)
        engine.attach_data(self.train_data, self.test_data)
        engine.counts = self.counts
        return engine

    def init(self, key):
        """Fresh state: the model's parameters and BatchNorm buffers as
        they stand (`model.init(key)` draws the JAX model's), in the
        parameter dtype, the step key `fold_in(key, 1)` on the model's
        device (the JAX `Engine.init(key)`) and a stateful attack's
        initial state."""
        theta = self.flat.flatten(dict(self.model.named_parameters()))
        net_state = {name: buf.detach().to(self.dtype, copy=True)
                     for name, buf in self.model.named_buffers()}
        theta = theta.detach().to(self.dtype, copy=True)
        attack_state = ()
        if self.attack is not None and self.attack.stateful:
            attack_state = tree_to(self.attack.state_init(
                f_real=self.cfg.nb_real_byz, d=self.d), self.device)
        rng = prng.fold_in(key.to(self.device), 1)
        rng_host = None
        if self.mixture and not self.per_call:
            rng_host = prng.fold_in_words(
                tuple(int(word) for word in key.tolist()), 1)
        stale = self.faults is not None and self.faults.has_stale
        return init_state(self.cfg, theta, net_state, rng,
                          opt_state=self.optimizer.init(theta),
                          attack_state=attack_state, rng_host=rng_host,
                          fault_buffer_rows=self.cfg.nb_honests if stale else 0)

    # ----------------------------------------------------------------- #
    # Phases

    def step_keys(self, rng):
        """`(next rng, mix_key, wkeys [S, 2])`: the JAX step's
        `split(state.rng, S + 2)` (one launch of `prng_kernels.split_keys`
        on the card)."""
        keys = prng_kernels.split_keys(rng, self.cfg.nb_sampled + 2)
        return keys[0], keys[1], keys[2:]

    def mirror_keys(self, state):
        """The host's side of a step's key split for a per-step `--gars`
        mixture: `(next rng_host, member)`, key 0 of `split(rng, S + 2)`
        and the member drawn by `uniform(key 1)` (`program.mixture_index`),
        from the mirror `state.rng_host`; `(None, None)` for one defense
        or a per-call draw."""
        if not self.mixture or self.per_call:
            return None, None
        words = state.rng_host
        if words is None:
            raise RuntimeError("a --gars mixture state needs rng_host; build "
                               "it with Engine.init or checkpoint.load")
        mix_u = prng.uniform_words(prng.split_words(words, 1))
        return (prng.split_words(words, 0),
                program.mixture_index(self.defenses, mix_u))

    def per_call_member(self, key, G):
        """The member a per-call draw gives the defense call on `G`:
        `mixture_draw(key, operand_hash(G), cum)`, an int32 0-d tensor on
        G's device (the JAX `_per_call_uniform` and `mixture_index`)."""
        cum = self._cumulative.get(G.device)
        if cum is None:
            cum = self._cumulative[G.device] = program.cumulative(
                self.defenses, G.device)
        return mixture_kernels.mixture_draw(
            key, mixture_kernels.operand_hash(G), cum)

    def draw_masks(self, wkeys, batch):
        """The dropout keep-masks of a step from the worker keys `wkeys
        [S, 2]`: the model's (`draw_masks`); at k > 1 local steps a list
        of k, local step t's from key t of `split(wkeys[s], k)` (one more
        launch of `prng_kernels.split_keys`), the keys the JAX
        `_local_steps` gives each local step's `apply`."""
        k = self.cfg.nb_local_steps
        if k == 1:
            return self.model.draw_masks(wkeys, batch)
        keys = prng_kernels.split_keys(wkeys, k)
        return [self.model.draw_masks(keys[:, t].contiguous(), batch)
                for t in range(k)]

    def _worker_grads(self, theta_eff, theta_axis, net_state, xs, ys, masks,
                      state_axis=None):
        """(losses [S], grads [S, d], {buffer: (S, ...)}) — every worker's
        forward/backward from the pre-step state `net_state` (shared, or
        each worker's own along axis 0 with `state_axis` 0). Inputs and
        parameters are cast to the compute dtype inside, so the gradients
        come back in theta's dtype and the losses in the compute dtype;
        the BatchNorm state stays in the parameter dtype."""
        model, flat, loss_fn = self.model, self.flat, self.loss
        cdtype = self.compute_dtype
        if xs.is_floating_point():
            xs = xs.to(cdtype)

        def worker_loss(theta, net_state, x, y, mask):
            out, new_state = functional_call(
                model, {**flat.unflatten(theta.to(cdtype)), **net_state},
                (x,), {"train": True, "masks": mask})
            loss = loss_fn(out, y, theta)
            flat_state = {f"{layer}.{stat}": value
                          for layer, stats in new_state.items()
                          for stat, value in stats.items()}
            return loss, (loss.detach(), flat_state)

        grads, (losses, states) = vmap(
            grad(worker_loss, has_aux=True),
            in_dims=(theta_axis, state_axis, 0, 0, 0), randomness="error")(
                theta_eff, net_state, xs, ys, masks)
        return losses, grads, states

    def _local_steps(self, theta_eff, theta_axis, net_state, xs, ys, masks,
                     lr):
        """The JAX `_local_steps` of every worker: k local steps of
        `th - lr * grad` (lr in theta's dtype) on the batches `xs: [S, k,
        B, ...]` with the masks of `draw_masks`, each from the previous
        step's parameters and BatchNorm state; returns (local step 0's
        losses [S], the displacements `(theta_eff - theta_k) / lr` [S, d],
        each worker's chain of running states {buffer: (S, k, ...)})."""
        theta, axis, state, state_axis = theta_eff, theta_axis, net_state, None
        chain = []
        for t, masks_t in enumerate(masks):
            losses_t, grads, state = self._worker_grads(
                theta, axis, state, xs[:, t], ys[:, t], masks_t, state_axis)
            if t == 0:
                losses = losses_t
            theta, axis, state_axis = theta - lr * grads, 0, 0
            chain.append(state)
        states = {name: torch.stack([c[name] for c in chain], dim=1)
                  for name in chain[0]}
        return losses, (theta_eff - theta) / lr, states

    def _worker_grads_grouped(self, theta_eff, net_state, xs, ys, masks):
        """`_worker_grads` as one forward and backward over all S workers
        (`forward_grouped`). `theta_eff` is `[d]` (broadcast over the
        workers, which then share the forward's convolutions and
        matmuls) or the per-worker lookahead `[S, d]`; its copy
        `th_s [S, d]` is the leaf. Worker s's loss reads only row s, so the
        gradient of the losses' sum is the stack of per-worker gradients.
        Casts as `_worker_grads`: gradients in theta's dtype, losses in the
        compute dtype."""
        S = xs.shape[0]
        cdtype = self.compute_dtype
        if xs.is_floating_point():
            xs = xs.to(cdtype)
        th_s = theta_eff.detach().expand(S, self.d).clone().requires_grad_()
        with torch.enable_grad():
            params_s = self.flat.unflatten_stacked(th_s.to(cdtype))
            out, states = self.grouped(params_s, net_state, xs, train=True,
                                       masks=masks,
                                       shared=theta_eff.dim() == 1)
            losses = vmap(self.loss)(out, ys, th_s)
            (grads,) = torch.autograd.grad(losses.sum(), th_s)
        return losses.detach(), grads, states

    def phase_honest(self, state, xs, ys, lr, masks=None):
        """Honest gradients, clipping, BN fold and momentum placement on
        the honest rows, on the dropout keep-masks `masks` (drawn from
        the step's worker keys, `step_keys(state.rng)`, when None).
        Returns (G_sampled, loss_avg, net_state, new_mw, G_honest)."""
        cfg = self.cfg
        S, h = cfg.nb_sampled, cfg.nb_honests
        lr = self.round_lr(lr)
        mu, one_damp = self.weak(cfg.momentum), self.weak(1.0 - cfg.dampening)
        mu_lr = mu * lr  # in the parameter dtype, as JAX's weak mu * lr
        if masks is None:
            masks = self.draw_masks(self.step_keys(state.rng)[2],
                                    self._batch_of(xs))
        if cfg.nesterov and cfg.momentum_at == "worker":
            # Per-worker lookahead theta - mu*lr*m_i; study extras beyond
            # the h buffers look ahead by zero
            pad = state.theta.new_zeros((S - h, self.d))
            buffers = torch.cat([state.momentum_workers, pad])
            theta_eff, theta_axis = state.theta[None, :] - mu_lr * buffers, 0
        elif cfg.nesterov:
            theta_eff, theta_axis = state.theta - mu_lr * state.momentum_server, None
        else:
            theta_eff, theta_axis = state.theta, None
        if self.grouped is not None:
            self.counts["grouped_phases"] += 1
            losses, grads, states = self._worker_grads_grouped(
                theta_eff, state.net_state, xs, ys, masks)
        elif cfg.nb_local_steps > 1:
            self.counts["vmapped_phases"] += 1
            losses, grads, states = self._local_steps(
                theta_eff, theta_axis, state.net_state, xs, ys, masks, lr)
        else:
            self.counts["vmapped_phases"] += 1
            losses, grads, states = self._worker_grads(
                theta_eff, theta_axis, state.net_state, xs, ys, masks)
        with torch.no_grad():
            G_sampled = clip_rows(grads, cfg.gradient_clip)
            net_state = compose_bn_updates(state.net_state, states, S,
                                           cfg.nb_local_steps)
            if cfg.momentum_at == "worker":
                new_mw = mu * state.momentum_workers + one_damp * G_sampled[:h]
                G_honest = new_mw
            elif cfg.momentum_at == "server":
                new_mw = state.momentum_workers
                G_honest = one_damp * G_sampled[:h] + mu * state.momentum_server
            else:
                new_mw = state.momentum_workers
                G_honest = G_sampled[:h]
        return G_sampled, losses.mean(), net_state, new_mw, G_honest

    def phase_faults(self, state, G_honest, faults=None):
        """The honest phase's last step under a fault schedule: the step's
        faults applied to the honest rows (`faults/inject.py`), from its
        rows `faults` (a `StepFaults` on the device; uploaded here from
        `state.steps` when None). Returns `(G_honest, fault_buffer,
        FaultContext)`, or the rows, the state's buffer and None without
        a schedule."""
        if self.faults is None:
            return G_honest, state.fault_buffer, None
        if faults is None:
            faults = self.faults.upload(state.steps, 1, G_honest.device).at(0)
        return inject_mod.inject(faults, self.faults.has_stale, G_honest,
                                 state.fault_buffer)

    def defense_extras(self, out):
        """`phase_defense`'s output past its first four as `phase_update`'s
        `diag_metrics` and `fault_metrics` keywords."""
        extras = list(out[4:])
        return {"diag_metrics": extras.pop(0) if self.diagnostics else None,
                "fault_metrics": extras.pop(0) if extras else None}

    @torch.no_grad()
    def phase_defense(self, G_honest, attack_state, mix_key=None,
                      member=None, fault=None):
        """Attack synthesis, aggregation and the attack acceptation ratio.
        The attack calls `defense`, the configured defense (an adaptive
        attack line-searches it); its rows are cast to the honest rows'
        dtype (a searched factor makes them f32 under a half dtype). A
        stateful attack takes `attack_state` (the `TrainState`'s) and
        returns the next one; a stateless attack passes it through. A
        mixture runs `member` (the per-step draw, `mirror_keys`), or with
        `cfg.gars_per_call` draws at every call from `mix_key`
        (`per_call_member`). Returns (G_attack, grad_defense,
        accept_ratio, attack_state), and under `self.diagnostics` the
        forensic metrics after them: the outer aggregation then runs the
        "diag" program. With a step's `fault` context (`phase_faults`)
        the aggregation, and every probe of n rows, runs the "masked"
        program on the active rows (the outer one after the quarantine,
        `cfg.fault_quarantine`), and the fault metrics come last; under
        diagnostics the "diag" program runs on the full stack beside it
        and its metrics gain the `Active mask`."""
        cfg = self.cfg
        f = cfg.nb_decl_byz
        if self.per_call:
            def draw(G, key=mix_key):
                return self.per_call_member(key, G)
        else:
            def draw(G, key=None):
                return member

        def defense(gradients, f):
            # The JAX defense program takes f from the configuration; a
            # probe of n rows shares the step's active mask
            if (fault is not None
                    and gradients.shape[0] == fault.active.shape[0]):
                return self.defense_masked(gradients, draw(gradients),
                                           fault.active)[0]
            return self.defense(gradients, draw(gradients))

        if cfg.nb_real_byz > 0:
            kwargs = dict(f_decl=f, f_real=cfg.nb_real_byz, defense=defense,
                          **self.attack_kwargs)
            if self.attack.stateful:
                G_attack, attack_state = self.attack.unchecked(
                    G_honest, state=attack_state, **kwargs)
            else:
                G_attack = self.attack.unchecked(G_honest, **kwargs)
            G_attack = G_attack.to(G_honest.dtype)
        else:
            G_attack = G_honest.new_zeros((0, self.d))
        G_all = torch.cat([G_honest, G_attack])
        outer = draw(G_all)
        if fault is not None:
            active = fault.active
            if cfg.fault_quarantine:
                active, _ = sanitize.quarantine(G_all, active)
            grad_defense, f_eff = self.defense_masked(G_all, outer, active)
            fault_metrics = {"Faults injected": fault.injected,
                             "Workers active": active.sum(dtype=torch.int32),
                             "Quorum f": f_eff}
            if self.diagnostics:
                # The aggregate stays the masked one; the diagnostics show
                # what the plain rule would choose on the full stack, and
                # who was quarantined
                _, aux = self.defense_diag(G_all, outer)
                diag_metrics = metrics_mod.forensic_metrics(aux, G_honest)
                diag_metrics["Active mask"] = active.to(torch.float32)
        elif self.diagnostics:
            # One call gives the aggregate and the aux (nothing is
            # aggregated twice)
            grad_defense, aux = self.defense_diag(G_all, outer)
            diag_metrics = metrics_mod.forensic_metrics(aux, G_honest)
        else:
            grad_defense = self.defense(G_all, outer)
        grad_defense = grad_defense.to(G_honest.dtype)
        # The influence's own draw (per call: from fold_in(mix_key, 1))
        infl_member = (draw(G_all, prng.fold_in(mix_key, 1)) if self.per_call
                       else member)
        accept_ratio = self.influence(G_honest, G_attack, infl_member)
        out = (G_attack, grad_defense, accept_ratio, attack_state,
               *((diag_metrics,) if self.diagnostics else ()),
               *((fault_metrics,) if fault is not None else ()))
        return out

    def influence(self, G_honest, G_attack, member=None):
        """The attack acceptation ratio of the defense (`member` as for
        `program.defense_program`), an f32 0-d tensor, the JAX package's
        `jnp.float32(influence)`: NaN for a GAR without one."""
        f = self.cfg.nb_decl_byz

        def one(gar, kwargs):
            if gar.influence is None:
                return G_honest.new_full((), math.nan, dtype=torch.float32)
            ratio = gar.influence(G_honest, G_attack, f=f, **kwargs)
            return (ratio.to(torch.float32) if isinstance(ratio, torch.Tensor)
                    else G_honest.new_full((), ratio, dtype=torch.float32))

        if len(self.defenses) == 1 or not isinstance(member, torch.Tensor):
            gar, _, kwargs = self.defenses[member or 0]
            return one(gar, kwargs)
        return program.select([one(gar, kwargs)
                               for gar, _, kwargs in self.defenses], member)

    @torch.no_grad()
    def phase_update(self, state, G_sampled, loss_avg, net_state, new_mw,
                     G_honest, G_attack, grad_defense, accept_ratio,
                     attack_state, lr, batch, rng=None, rng_host=None,
                     diag_metrics=None, fault_metrics=None,
                     fault_buffer=None):
        """Model update and study metrics; the attack's next state, the
        step's next key `rng` (`step_keys`; the state's own when None),
        its host mirror `rng_host` (`mirror_keys`) and the straggler
        buffer `fault_buffer` (`phase_faults`; the state's own when None)
        go into the new state, the fault metrics and the forensic values
        `diag_metrics` (`phase_defense`) into the metrics, and with
        `cfg.health` (and the study) the health vector of the submitted
        rows, the aggregate and the parameters before and after the
        update (`engine/health.py`). Returns (new state, metrics)."""
        cfg = self.cfg
        lr = self.round_lr(lr)
        mu, one_damp = self.weak(cfg.momentum), self.weak(1.0 - cfg.dampening)
        if cfg.momentum_at == "worker":
            new_ms = state.momentum_server
        elif cfg.momentum_at == "server":
            new_ms = grad_defense
        else:
            new_ms = mu * state.momentum_server + one_damp * grad_defense
        update_grad = new_ms if cfg.momentum_at == "update" else grad_defense
        theta, opt_state = self.optimizer.update(
            update_grad, state.opt_state, state.theta, lr)

        health = cfg.study and cfg.health
        sums = {} if health else None
        if cfg.study:
            l2_origin = torch.sqrt(torch.sum((state.theta - state.origin) ** 2))
            metrics, (pg, pn, pc) = metrics_mod.study_metrics(
                loss_avg=loss_avg, l2_origin=l2_origin, G_sampled=G_sampled,
                G_honest=G_honest, G_attack=G_attack,
                grad_defense=grad_defense, accept_ratio=accept_ratio,
                past_grads=state.past_grads, past_norms=state.past_norms,
                past_count=state.past_count, momentum=cfg.momentum, sums=sums)
        else:
            metrics = {}
            pg, pn, pc = state.past_grads, state.past_norms, state.past_count
        if cfg.study and fault_metrics is not None:
            metrics.update(fault_metrics)
        if cfg.study and diag_metrics is not None:
            metrics.update(diag_metrics)
        if health:
            # The health vector (`engine/health.py`), the study's sums of
            # squares reused
            metrics.update(health_mod.health_metrics(
                G_honest, G_attack, grad_defense, state.theta, theta,
                sums=sums))
        new_state = TrainState(
            theta=theta, net_state=net_state, opt_state=opt_state,
            momentum_server=new_ms, momentum_workers=new_mw,
            origin=state.origin, past_grads=pg, past_norms=pn, past_count=pc,
            steps=state.steps + 1,
            datapoints=(state.datapoints
                        + batch * cfg.nb_honests * cfg.nb_local_steps),
            rng=state.rng if rng is None else rng,
            fault_buffer=(state.fault_buffer if fault_buffer is None
                          else fault_buffer),
            attack_state=attack_state,
            rng_host=state.rng_host if rng is None else rng_host)
        return new_state, metrics

    def lr_dtype(self):
        """The dtype a Python learning rate takes in the JAX engine: f32,
        or f64 in a float64 run (x64 mode)."""
        return (torch.float64 if torch.float64 in (self.dtype, self.compute_dtype)
                else torch.float32)

    def round_lr(self, lr):
        """The learning rate rounded to the parameter dtype as a 0-d
        tensor on the engine's device (`jnp.asarray(lr).astype(theta
        .dtype)`): a tensor (a chunk's `lrs[i]`) as it is, a Python
        number first as the JAX engine holds it (`lr_dtype`). The
        momentum and update algebra then stays in that dtype, and a 0-d
        tensor on the operands' device never goes through the host."""
        if not isinstance(lr, torch.Tensor):
            lr = torch.full((), lr, dtype=self.lr_dtype(), device=self.device)
        return lr.to(self.dtype)

    def weak(self, x):
        """A Python scalar rounded to the parameter dtype, as JAX applies
        it (`utils.weak_scalar`)."""
        return weak_scalar(x, self.dtype)

    def _batch_of(self, xs):
        """The per-worker batch of `xs: [S, B, ...]` or, at k > 1 local
        steps, `[S, k, B, ...]`."""
        return xs.shape[2] if self.cfg.nb_local_steps > 1 else xs.shape[1]

    def train_step(self, state, xs, ys, lr, masks=None, faults=None):
        """xs: f32[S, B, ...], ys: [S, B] on the engine's device (at k > 1
        local steps `[S, k, B, ...]`, `[S, k, B]`). The step splits
        `state.rng` (`step_keys`) and draws the dropout keep-masks from
        the worker keys (`draw_masks`), unless `masks` gives them; under
        a fault schedule `faults` gives its fault rows (`phase_faults`)."""
        rng, mix_key, wkeys = self.step_keys(state.rng)
        rng_host, member = self.mirror_keys(state)
        batch = self._batch_of(xs)
        if masks is None:
            masks = self.draw_masks(wkeys, batch)
        G_sampled, loss_avg, net_state, new_mw, G_honest = self.phase_honest(
            state, xs, ys, lr, masks)
        G_honest, new_fb, fault = self.phase_faults(state, G_honest, faults)
        defense = self.phase_defense(G_honest, state.attack_state,
                                     mix_key=mix_key, member=member,
                                     fault=fault)
        return self.phase_update(
            state, G_sampled, loss_avg, net_state, new_mw, G_honest,
            *defense[:4], lr, batch, rng=rng, rng_host=rng_host,
            **self.defense_extras(defense), fault_buffer=new_fb)

    def sample_indices(self, chunk=None, batchwise=False):
        """The host indices and flips of a step's batches
        (`DeviceData.sample_indices` of S * k batches, in the JAX
        driver's order and layout): `[S, B]`, or `[S, k, B]` at k > 1
        local steps; with `chunk` M, one draw of the M steps' M * S * k
        batches, `[M, S, B]` or `[M, S, k, B]` (the JAX driver's chunk:
        every index row before any flip row, so a flipped split's batches
        depend on M where an epoch ends inside a chunk). `batchwise`
        draws each batch's index row, then its flip row
        (`DeviceData.sample_batches`): the order of the JAX driver's
        host-staged batches, which `--device-gar` takes."""
        S, k = self.cfg.nb_sampled, self.cfg.nb_local_steps
        M = 1 if chunk is None else chunk
        data = self.train_data
        draw = data.sample_batches if batchwise else data.sample_indices
        idx, flips = draw(M * S * k)
        shape = (S,) if k == 1 else (S, k)
        if chunk is not None:
            shape = (M, *shape)
        return idx.reshape(*shape, -1), flips.reshape(*shape, -1)

    def train_step_indexed(self, state, idx, flips, lr, masks=None):
        """`train_step` on the batches `idx: i32[S, B]`, `flips:
        bool[S, B]` (`[S, k, B]` at k > 1 local steps; host arrays,
        `sample_indices`) of the device-resident train split."""
        self.counts["indexed_steps"] += 1
        data = self.train_data
        xs, ys = data.gather(*data.upload(idx, flips))
        return self.train_step(state, xs, ys, lr, masks)

    def train_multi(self, state, xs, ys, lrs):
        """M steps of `train_step` on `xs: [M, S, B, ...]`, `ys: [M, S,
        B]` with the learning rates `lrs: f32[M]` (a host array, as the
        JAX `_train_multi` takes them); returns the state after the M
        steps and the study metrics stacked per column, device tensors
        `[M]` (`stack_metrics`)."""
        return self._chunk(state, lrs, lambda i: (xs[i], ys[i]))

    def train_multi_indexed(self, state, idx, flips, lrs, step=None):
        """`train_multi` on the host indices and flips of a chunk, `idx:
        i32[M, S, B]`, `flips: bool[M, S, B]` (`[M, S, k, B]` at k > 1
        local steps; `sample_indices(M)`): one upload of each, then each
        step gathers its batches on the device (the JAX
        `_train_multi_indexed`). `step` replaces `train_step` (a drop-in
        such as `program.device_gar_step`'s)."""
        data = self.train_data
        idx, flips = data.upload(idx, flips)

        def batches(i):
            self.counts["indexed_steps"] += 1
            return data.gather(idx[i], flips[i])

        return self._chunk(state, lrs, batches, step)

    def _chunk(self, state, lrs, batches, step=None):
        """The steps of a chunk: step i on `batches(i)` at `lrs[i]`, the
        learning rates uploaded in one copy, and under a fault schedule
        the chunk's fault rows in one more (`FaultSchedule.upload`); a
        chunk of more than one step counts one `multi_dispatches`."""
        lrs = to_device(np.asarray(lrs, np.float32), self.device)
        M = lrs.shape[0]
        if M > 1:
            self.counts["multi_dispatches"] += 1
        step = step or self.train_step
        faults = (self.faults.upload(state.steps, M, self.device)
                  if self.faults is not None else None)
        rows = []
        for i in range(M):
            extra = {} if faults is None else {"faults": faults.at(i)}
            state, metrics = step(state, *batches(i), lrs[i], **extra)
            rows.append(metrics)
        return state, stack_metrics(rows)

    # ----------------------------------------------------------------- #
    # Evaluation

    @torch.no_grad()
    def eval_many(self, theta, net_state, xs, ys):
        """Summed `[#correct, #samples]` over `reps` stacked test batches
        `xs: [reps, B, ...]`, in eval mode (running BN stats, kept in the
        parameter dtype), forward in the compute dtype."""
        cdtype = self.compute_dtype
        params = {**self.flat.unflatten(theta.to(cdtype)), **net_state}
        if xs.is_floating_point():
            xs = xs.to(cdtype)
        acc = torch.zeros(2, device=theta.device)
        for x, y in zip(xs, ys):
            out, _ = functional_call(self.model, params, (x,), {"train": False})
            acc = acc + self.criterion(out, y)
        return acc

    def eval_many_indexed(self, theta, net_state, idx, flips):
        """`eval_many` on the batches `idx: i32[reps, B]`, `flips:
        bool[reps, B]` of the device-resident test split."""
        self.counts["indexed_evals"] += 1
        data = self.test_data
        xs, ys = data.gather(*data.upload(idx, flips))
        return self.eval_many(theta, net_state, xs, ys)
