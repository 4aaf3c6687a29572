"""The 24-column study pipeline (`byzantinemomentum_tpu/engine/metrics.py`).

Formula parity notes (those of the JAX package and its reference):

* "norm" columns are the norm OF the class average, and cosines are
  normalized by those average-norms.
* "deviation" is the SAMPLE standard deviation (n-1 denominator) of the
  per-gradient L2 deviations from the class average; NaN for < 2 rows.
* The composite curvature is `mu * sum_i mu^i <avg_t, past_i>` over the
  `appendleft`-ordered ring of past sampled averages.

Dtypes are the JAX package's: every column is computed in the dtype of
its operands (the parameter dtype; the average loss in the compute
dtype), and the curvature's f32 momentum weights promote it to at least
f32.

Values stay on the device, and nothing here reads one on the host:
`past_count` is an i32 0-d tensor, and the curvature is computed over
every past slot weighted by `arange(P) < past_count`, the JAX package's
own masked sum. The driver moves a chunk's rows to the host in one
transfer.

With `--gar-diagnostics`, `forensic_metrics` digests the GAR's
diagnostics aux (`ops/diag.py`) on the device into the values behind
`FORENSIC_COLUMNS`: the `Sel mask` and `Worker dist` vectors (f32[n]),
which the driver formats and folds into the suspicion tracker on the
host, and three scalars written as they are.
"""

import torch

from byzantinemomentum_tpu_torch.ops import diag

__all__ = ["STUDY_COLUMNS", "FAULT_COLUMNS", "RECOVERY_COLUMNS",
           "FORENSIC_COLUMNS", "HEALTH_COLUMNS",
           "avg_dev_max", "cosine", "push_past", "study_metrics",
           "forensic_metrics"]

# CSV header, byte-identical to the JAX package's (and the reference's)
STUDY_COLUMNS = (
    "Step number", "Training point count",
    "Average loss", "l2 from origin",
    "Sampled gradient deviation", "Honest gradient deviation", "Attack gradient deviation",
    "Sampled gradient norm", "Honest gradient norm", "Attack gradient norm", "Defense gradient norm",
    "Sampled max coordinate", "Honest max coordinate", "Attack max coordinate", "Defense max coordinate",
    "Sampled-honest cosine", "Sampled-attack cosine", "Sampled-defense cosine",
    "Honest-attack cosine", "Honest-defense cosine", "Attack-defense cosine",
    "Sampled-prev cosine", "Sampled composite curvature",
    "Attack acceptation ratio",
)

# The resilience columns the JAX driver appends under a fault plan
# (`--fault-plan`): the fault conditions live this step, the effective
# worker count after drops and quarantine, and the effective Byzantine
# tolerance the aggregation ran with (`faults/quorum.py`)
FAULT_COLUMNS = ("Faults injected", "Workers active", "Quorum f")

# The crash-recovery columns the JAX driver appends under --auto-resume
# or a --rollback-budget: the divergence rollbacks as of the step's
# dispatch and the run's restart count
RECOVERY_COLUMNS = ("Rollbacks", "Restarts")

# The aggregation-forensics columns the JAX driver appends under
# --gar-diagnostics: the selected workers (';'-joined indices), the
# honest-vs-all median distance, the paper's variance-to-norm ratio of
# the honest submissions, the mean trim fraction and the largest
# suspicion (`obs/forensics.py`)
FORENSIC_COLUMNS = ("Sel workers", "Dist honest med", "Var/norm ratio",
                    "Clip frac", "Suspicion max")

# The health columns the JAX driver appends under --health
# (`engine/health.py`): the honest rows' variance-to-norm ratio, the
# weight and update norms and their ratio, the ';'-joined log2 histogram
# of the submitted rows' norms, and the non-finite submitted rows and 0/1
# indicators of a non-finite aggregate and state
HEALTH_COLUMNS = ("Var ratio", "Weight norm", "Update norm",
                  "Update/weight", "Norm hist", "Nonfinite submitted",
                  "Nonfinite aggregate", "Nonfinite state")

_NAN = float("nan")


def avg_dev_max(G, sums=None):
    """(average, ||avg||, max |avg|, sample std-dev of the deviations)
    over the rows of `G: f32[m, d]`; (None, nan, nan, nan) for m == 0 and
    dev = nan for m == 1. For m >= 2, `sums` (a dict) receives the sums
    of squares of the deviations (`dev2`) and of the average (`navg2`)."""
    m = G.shape[0]
    if m == 0:
        return None, _NAN, _NAN, _NAN
    avg = G.mean(dim=0)
    navg2 = torch.sum(avg * avg)
    norm_avg = torch.sqrt(navg2)
    norm_max = torch.max(torch.abs(avg))
    if m >= 2:
        dev = G - avg
        dev2 = torch.sum(dev * dev)
        dev = torch.sqrt(dev2 / (m - 1))
        if sums is not None:
            sums.update(dev2=dev2, navg2=navg2)
    else:
        dev = _NAN
    return avg, norm_avg, norm_max, dev


def cosine(a, na, b, nb):
    """dot(a, b) / (na * nb), normalized by average-norms."""
    if a is None or b is None:
        return _NAN
    return torch.dot(a, b) / na / nb


def push_past(past_grads, past_norms, past_count, grad, norm):
    """`deque.appendleft` on the past-gradient ring; the count saturates
    at P on the device."""
    P = past_grads.shape[0]
    if P == 0:
        return past_grads, past_norms, past_count
    past_grads = torch.cat([grad[None, :], past_grads[:-1]])
    past_norms = torch.cat([norm[None], past_norms[:-1]])
    past_count = torch.minimum(past_count + 1, torch.full_like(past_count, P))
    return past_grads, past_norms, past_count


def forensic_metrics(aux, G_honest):
    """The forensic values of one step from the GAR's diagnostics aux and
    the honest submissions (the JAX `forensic_metrics`): `Sel mask`, the
    aux selection; `Worker dist`, each worker's mean distance to its
    finite peers (+inf for a row with none); `Dist honest med`, the
    median honest-vs-all distance; `Var/norm ratio`; `Clip frac`, the
    mean trim fraction. Device tensors, none read on the host."""
    n = aux["selection"].shape[0]
    dist = aux["dist"]
    _, dmed, _ = diag.distance_summary(dist, rows=G_honest.shape[0])
    eye = torch.eye(n, dtype=torch.bool, device=dist.device)
    finite = torch.isfinite(dist) & ~eye
    count = finite.to(torch.float32).sum(dim=1)
    mean_d = (torch.where(finite, dist, 0.0).sum(dim=1)
              / torch.clamp(count, min=1.0))
    return {
        "Sel mask": aux["selection"],
        "Worker dist": torch.where(count > 0, mean_d, torch.inf),
        "Dist honest med": dmed,
        "Var/norm ratio": diag.var_norm_ratio(G_honest),
        "Clip frac": diag.mean_f32(aux["trim_frac"]),
    }


def study_metrics(*, loss_avg, l2_origin, G_sampled, G_honest, G_attack,
                  grad_defense, accept_ratio, past_grads, past_norms,
                  past_count, momentum, sums=None):
    """The 22 metric values of one step (every column but the step and
    point counts). Returns (metrics dict, new past ring). `sums` (a dict)
    receives the sums of squares the health vector reuses
    (`engine/health.py`): the honest rows' `dev2` and `navg2` (for two
    rows or more) and the aggregate's `agg2`."""
    sampled_avg, sampled_na, sampled_mx, sampled_dev = avg_dev_max(G_sampled)
    honest_avg, honest_na, honest_mx, honest_dev = avg_dev_max(G_honest, sums)
    attack_avg, attack_na, attack_mx, attack_dev = avg_dev_max(G_attack)
    agg2 = torch.sum(grad_defense * grad_defense)
    if sums is not None:
        sums["agg2"] = agg2
    defense_na = torch.sqrt(agg2)
    defense_mx = torch.max(torch.abs(grad_defense))

    P = past_grads.shape[0]
    if P > 0:
        has_past = past_count > 0
        cosin_sampled = torch.where(
            has_past,
            torch.dot(sampled_avg, past_grads[0]) / sampled_na / past_norms[0],
            _NAN)
        # mu * sum_i mu^i <sampled_avg, past_i> over the valid entries
        device = past_grads.device
        weights = momentum ** torch.arange(P, dtype=torch.float32, device=device)
        valid = (torch.arange(P, device=device) < past_count).to(torch.float32)
        dots = past_grads @ sampled_avg
        curv_sampled = torch.where(
            has_past, momentum * torch.sum(weights * valid * dots), _NAN)
    else:
        cosin_sampled = _NAN
        curv_sampled = _NAN

    metrics = {
        "Average loss": loss_avg,
        "l2 from origin": l2_origin,
        "Sampled gradient deviation": sampled_dev,
        "Honest gradient deviation": honest_dev,
        "Attack gradient deviation": attack_dev,
        "Sampled gradient norm": sampled_na,
        "Honest gradient norm": honest_na,
        "Attack gradient norm": attack_na,
        "Defense gradient norm": defense_na,
        "Sampled max coordinate": sampled_mx,
        "Honest max coordinate": honest_mx,
        "Attack max coordinate": attack_mx,
        "Defense max coordinate": defense_mx,
        "Sampled-honest cosine": cosine(sampled_avg, sampled_na, honest_avg, honest_na),
        "Sampled-attack cosine": cosine(sampled_avg, sampled_na, attack_avg, attack_na),
        "Sampled-defense cosine": cosine(sampled_avg, sampled_na, grad_defense, defense_na),
        "Honest-attack cosine": cosine(honest_avg, honest_na, attack_avg, attack_na),
        "Honest-defense cosine": cosine(honest_avg, honest_na, grad_defense, defense_na),
        "Attack-defense cosine": cosine(attack_avg, attack_na, grad_defense, defense_na),
        "Sampled-prev cosine": cosin_sampled,
        "Sampled composite curvature": curv_sampled,
        "Attack acceptation ratio": accept_ratio,
    }
    new_past = push_past(past_grads, past_norms, past_count,
                         sampled_avg, sampled_na)
    return metrics, new_past
