"""Static engine configuration (`byzantinemomentum_tpu/engine/config.py`,
the fields of the training path ported so far: local steps, the
`--gars` mixture's draw, the grouped honest phase, the GAR
diagnostics, the fault plans' degradation policy, the health vector)."""

import dataclasses

import torch

__all__ = ["EngineConfig", "DTYPES"]

# Accepted dtype spellings, the JAX package's, as torch dtypes (float64
# needs no switch in torch)
DTYPES = {
    "float32": torch.float32, "f32": torch.float32, "fp32": torch.float32,
    "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
    "float16": torch.float16, "f16": torch.float16, "fp16": torch.float16,
    "float64": torch.float64, "f64": torch.float64, "fp64": torch.float64,
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Mirror of the reference's derived argument set."""

    nb_workers: int = 11          # --nb-workers
    nb_decl_byz: int = 4          # --nb-decl-byz (f declared)
    nb_real_byz: int = 0          # --nb-real-byz (f actually attacking)
    nb_for_study: int = 0         # --nb-for-study (0 = study disabled)
    nb_for_study_past: int = 1    # --nb-for-study-past (past-gradient ring)
    momentum: float = 0.9         # --momentum (mu)
    dampening: float = 0.0        # --dampening
    nesterov: bool = False        # --momentum-nesterov
    momentum_at: str = "update"   # --momentum-at in {update, server, worker}
    weight_decay: float = 0.0     # --weight-decay
    gradient_clip: float = None   # --gradient-clip (per-sampled-grad L2 cap)
    dtype: str = "float32"        # --dtype: parameter/state/gradient dtype
    compute_dtype: str = None     # --compute-dtype: forward/backward dtype;
    #                               None = same as `dtype` (bf16 with f32
    #                               parameters is mixed precision: f32
    #                               master weights, momentum and GAR space)
    grouped_workers: bool = True  # merged-batch grouped honest phase for
    #                               models with a grouped forward
    #                               (--no-grouped-workers turns it off)
    nb_local_steps: int = 1       # --nb-local-steps (multi-local-step SGD)
    gars_per_call: bool = False   # --gars-per-call: a --gars mixture draws
    #                               its member at every defense call (from
    #                               a hash of the operand), not once a step
    fault_quarantine: bool = True  # with a fault schedule attached
    #                               (`faults/`): quarantine non-finite
    #                               submission rows out of the aggregation
    #                               and the quorum (no effect without one)
    fault_dynamic_quorum: bool = True  # recompute the effective (n, f)
    #                               the GAR runs with when workers are
    #                               absent (`faults/quorum.py`); False
    #                               keeps the declared f and only leaves
    #                               the absent rows out
    gar_diagnostics: bool = False  # --gar-diagnostics: with the study on,
    #                               the outer aggregation runs the GAR's
    #                               diagnose form and the step's metrics
    #                               gain the forensic values
    #                               (`engine/metrics.py::forensic_metrics`);
    #                               off, the step runs no code of
    #                               `ops/diag.py`
    health: bool = False          # --health: with the study on, the
    #                               step's metrics gain the health vector
    #                               (`engine/health.py`, HEALTH_COLUMNS);
    #                               off, the step runs no code of it

    def __post_init__(self):
        if self.momentum_at not in ("update", "server", "worker"):
            raise ValueError(f"Invalid momentum placement {self.momentum_at!r}")
        if self.dtype not in DTYPES:
            raise ValueError(
                f"Invalid dtype {self.dtype!r}; expected one of "
                f"{sorted(set(DTYPES))}")
        if self.compute_dtype is not None and self.compute_dtype not in DTYPES:
            raise ValueError(
                f"Invalid compute dtype {self.compute_dtype!r}; expected one "
                f"of {sorted(set(DTYPES))}")
        if self.nb_real_byz > self.nb_workers:
            raise ValueError(
                f"More real Byzantine workers ({self.nb_real_byz}) than total "
                f"workers ({self.nb_workers})")
        if self.nb_local_steps < 1:
            raise ValueError(
                f"Non-positive number of local steps {self.nb_local_steps}")

    @property
    def nb_honests(self):
        """Honest worker count = n - f_real."""
        return self.nb_workers - self.nb_real_byz

    @property
    def nb_sampled(self):
        """Gradients computed per step = max(honests, study extras)."""
        return max(self.nb_honests, self.nb_for_study)

    @property
    def study(self):
        return self.nb_for_study > 0

    @property
    def torch_dtype(self):
        """Parameter/state dtype as a torch dtype."""
        return DTYPES[self.dtype]

    @property
    def torch_compute_dtype(self):
        """Forward/backward compute dtype as a torch dtype."""
        return DTYPES[self.compute_dtype or self.dtype]
