"""The per-step tensor-health vector, the device half of the numerics
flight recorder (`byzantinemomentum_tpu/engine/health.py`).

`health_metrics` computes, on the step's device and with no host read:

  Norm hist         a fixed-bin log2 histogram of the submitted rows' L2
                    norms (`HIST_BINS` bins of `HIST_WIDTH` octaves from
                    `2**HIST_LO`; exact zeros in bin 0, non-finite norms
                    in the last bin);
  Var ratio         the variance-to-norm ratio of the honest rows (the
                    `ops/diag.py::var_norm_ratio` formula);
  Weight norm, Update norm, Update/weight
                    the L2 norms of the updated parameters and of the
                    applied update, and their ratio;
  Nonfinite submitted, Nonfinite aggregate, Nonfinite state
                    the submitted rows with a non-finite norm, and 0/1
                    indicators off the sums of squares of the aggregate
                    and of the new parameters (a sum of squares is
                    non-finite iff its operand holds a NaN or an inf, or
                    overflows f32).

Everything is an f32 0-d tensor but `Norm hist`, f32[HIST_BINS], keyed
by `engine/metrics.py::HEALTH_COLUMNS`; `Engine.phase_update` merges them
into the step's metrics, and the chunk's one transfer carries them to
the host.

What a step adds: the honest average, its deviations' sum of squares and
the aggregate's sum of squares are the study pipeline's own tensors
(`metrics.study_metrics` hands them over in `sums`, the port's
counterpart of the common-subexpression elimination the JAX module
leans on), so the health vector adds one pass over the submitted rows
(their norms), the two d-vector reductions of the new parameters and
the update, and the histogram. The operands are taken in f32 (`_as_f32`,
a copy only for another dtype; the study's sums are reused only for an
f32 stack, where they are the same values).

The JAX module's d-sharded form (`sharded_health_metrics`,
`HEALTH_PSUMS`) needs the multi-card mesh, which the port does not have
yet (`ROADMAP.md` section 1 item 7).
"""

import torch

__all__ = ["HIST_BINS", "HIST_LO", "HIST_WIDTH", "norm_histogram",
           "health_metrics"]

# Log2-scale histogram geometry: HIST_BINS bins of HIST_WIDTH octaves
# each, from 2**HIST_LO. Bin 0 doubles as the underflow bin (exact zeros
# and norms below 2**HIST_LO), the last bin as the overflow and
# non-finite bin
HIST_BINS = 16
HIST_LO = -12
HIST_WIDTH = 2

# Update-to-weight guard against a zero weight vector
_TINY = 1e-30


def norm_histogram(norms):
    """`f32[m] -> f32[HIST_BINS]`: the log2 histogram of the L2 norms.
    Exact zeros land in bin 0, non-finite norms in the last bin, finite
    positive norms in `floor((log2(n) - HIST_LO) / HIST_WIDTH)` clipped
    into range."""
    finite = torch.isfinite(norms)
    safe = torch.where(finite & (norms > 0), norms, torch.ones_like(norms))
    idx = torch.floor((torch.log2(safe) - HIST_LO) / HIST_WIDTH).to(torch.int32)
    idx = torch.clamp(idx, 0, HIST_BINS - 1)
    idx = torch.where(norms == 0, 0, idx)
    idx = torch.where(finite, idx, HIST_BINS - 1)
    bins = torch.arange(HIST_BINS, dtype=torch.int32, device=norms.device)
    return (idx[:, None] == bins[None, :]).to(torch.float32).sum(dim=0)


def _partials(G_honest, G_attack, grad_defense, theta_old, theta_new,
              sums=None):
    """The submitted rows' L2 norms and the five sums of squares: the
    honest rows' deviations from their average, that average, the new
    parameters, the update and the aggregate. `sums` (`study_metrics`'s,
    for the same f32 operands) gives the first two and the last."""
    norms = torch.cat([torch.linalg.vector_norm(G, dim=1)
                       for G in (G_honest, G_attack)])
    if sums is not None:
        dev2, navg2, agg2 = sums["dev2"], sums["navg2"], sums["agg2"]
    else:
        dev2 = navg2 = None  # the variance ratio is NaN below two rows
        if G_honest.shape[0] >= 2:
            avg = G_honest.mean(dim=0)
            dev = G_honest - avg
            dev2 = torch.sum(dev * dev)
            navg2 = torch.sum(avg * avg)
        agg2 = torch.sum(grad_defense * grad_defense)
    update = theta_old - theta_new
    return norms, (dev2, navg2, torch.sum(theta_new * theta_new),
                   torch.sum(update * update), agg2)


def _finalize(norms, scalars, m_honest):
    """The health dict, keyed by `HEALTH_COLUMNS`, from the norms and the
    five sums of squares."""
    dev2, navg2, w2, u2, agg2 = scalars
    if m_honest >= 2:
        var_ratio = ((dev2 / (m_honest - 1)) / navg2).to(torch.float32)
    else:
        var_ratio = torch.full((), torch.nan, device=w2.device)
    weight_norm = torch.sqrt(w2)
    update_norm = torch.sqrt(u2)
    return {
        "Var ratio": var_ratio,
        "Weight norm": weight_norm,
        "Update norm": update_norm,
        "Update/weight": update_norm / torch.clamp(weight_norm, min=_TINY),
        "Norm hist": norm_histogram(norms),
        "Nonfinite submitted": (~torch.isfinite(norms)).to(torch.float32).sum(),
        "Nonfinite aggregate": (~torch.isfinite(agg2)).to(torch.float32),
        "Nonfinite state": (~torch.isfinite(w2)).to(torch.float32),
    }


def _as_f32(*tensors):
    """The tensors in f32 (as they are where they already are)."""
    return tuple(t if t.dtype == torch.float32 else t.to(torch.float32)
                 for t in tensors)


def health_metrics(G_honest, G_attack, grad_defense, theta_old, theta_new,
                   sums=None):
    """The step's health vector.

    Args:
      G_honest: [h, d], the honest submissions after the fault injection.
      G_attack: [f, d], the Byzantine rows (f may be 0); the histogram
        and the non-finite count cover the honest and attack rows.
      grad_defense: [d], the aggregate.
      theta_old, theta_new: [d], the parameters before and after the
        update.
      sums: `study_metrics`'s sums of squares of the same step (`dev2`,
        `navg2`, `agg2`), used where the operands are f32 (and h >= 2,
        where the study has the deviations).
    """
    f32 = (G_honest.dtype == torch.float32 and grad_defense.dtype == torch.float32
           and G_honest.shape[0] >= 2)
    G_honest, G_attack, grad_defense, theta_old, theta_new = _as_f32(
        G_honest, G_attack, grad_defense, theta_old, theta_new)
    norms, scalars = _partials(G_honest, G_attack, grad_defense, theta_old,
                               theta_new, sums=sums if f32 else None)
    return _finalize(norms, scalars, G_honest.shape[0])
