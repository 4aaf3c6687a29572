"""Host-side Byzantine forensics: per-worker EWMA suspicion scores
(`byzantinemomentum_tpu/obs/forensics.py`, pure numpy in float64).

The GAR diagnostics (`ops/diag.py`, threaded out of the step as the
`Sel mask` and `Worker dist` metric vectors) say what the GAR saw at
each step; `SuspicionTracker` folds them into a per-worker running
suspicion, the sum of EWMA components each normalized to [0, 1] and
weighted (the weights sum to 1):

  selection deficit   how much less often the worker is selected than
                      the mean selection rate, clipped to [0, 1];
  distance z-score    the worker's mean pairwise distance as a z-score
                      over the cohort, clipped to [0, Z_CLIP] and
                      normalized by Z_CLIP (a non-finite distance counts
                      as Z_CLIP);
  quarantine history  the worker's inactive indicator, where a fault
                      plan gives one;
  collusion           optional (a 4-tuple of weights): whether the
                      worker's row sits closer than `collusion_frac` of
                      the cohort's median distance to another row.

Crossing `threshold` upwards makes a worker a suspect, falling back to
`clear` clears it, both once `min_steps` observations are in; each edge
emits a `suspect_worker`/`suspect_cleared` event through the active
recorder (`obs/recorder.py`), as the JAX tracker does.
`ClientSuspicionStore` serves the aggregation service, which the port
does not have yet.
"""

import numpy as np

from byzantinemomentum_tpu_torch.obs import recorder

__all__ = ["SuspicionTracker", "Z_CLIP", "COLLUSION_FRAC",
           "collusion_partners"]

# Distance z-scores are clipped here before normalization: beyond ~4
# sigma, "farther" carries no additional information, and a single inf
# row must not destroy the EWMA.
Z_CLIP = 4.0

# Near-duplicate threshold, as a fraction of the cohort's median finite
# pairwise distance: honest i.i.d. rows sit ~sigma*sqrt(2d) apart (the
# median), while colluding copies differ only by whatever jitter the
# attacker dares to add — 0.2 leaves the adversary a factor-5 gap to
# cross before its rows blend into the honest cloud.
COLLUSION_FRAC = 0.2


def collusion_partners(dist, frac=COLLUSION_FRAC):
    """`bool[n, n]` near-duplicate adjacency from a pairwise-distance
    matrix (`ops/diag.py` aux convention: +inf diagonal, non-finite
    -> +inf): an edge where the finite off-diagonal distance is at most
    `frac` times the median finite off-diagonal distance. A fully
    degenerate cohort (median 0 — every row identical) keeps exact-zero
    edges, which is the honest reading of that cohort."""
    d = np.asarray(dist, dtype=np.float64)
    n = d.shape[0]
    offdiag = ~np.eye(n, dtype=bool)
    finite = np.isfinite(d) & offdiag
    if not finite.any():
        return np.zeros((n, n), dtype=bool)
    return finite & (d <= frac * float(np.median(d[finite])))


class SuspicionTracker:
    """Per-worker EWMA suspicion over a run's diagnostic step stream.

    Args:
      nb_workers: worker rows in the submission stack (honest + Byzantine).
      alpha: EWMA smoothing factor (weight of the newest observation).
      threshold: suspicion level whose rising edge makes a suspect.
      clear: level whose falling edge clears a suspect (hysteresis:
        must be < threshold).
      weights: (selection, distance, quarantine) component weights —
        or a 4-tuple (selection, distance, quarantine, collusion) to
        enable the near-duplicate channel (fed by `update`'s
        `dist_matrix`); normalized to sum 1.
      min_steps: observations before any edge counts (the first few steps'
        selection rates are pure noise).
      collusion_frac: near-duplicate threshold as a fraction of the
        cohort's median pairwise distance (`collusion_partners`).
    """

    def __init__(self, nb_workers, *, alpha=0.05, threshold=0.5, clear=0.25,
                 weights=(0.5, 0.3, 0.2), min_steps=10,
                 collusion_frac=COLLUSION_FRAC):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"EWMA alpha must be in (0, 1], got {alpha}")
        if not 0.0 <= clear < threshold:
            raise ValueError(
                f"Need 0 <= clear < threshold, got clear={clear} "
                f"threshold={threshold}")
        if len(weights) not in (3, 4):
            raise ValueError(
                f"Expected 3 (sel, dist, quarantine) or 4 (+ collusion) "
                f"component weights, got {len(weights)}")
        self.nb_workers = int(nb_workers)
        self.alpha = float(alpha)
        self.threshold = float(threshold)
        self.clear = float(clear)
        total = float(sum(weights))
        self.weights = tuple(float(w) / total for w in weights)
        self.min_steps = int(min_steps)
        self.collusion_frac = float(collusion_frac)
        self.steps = 0
        n = self.nb_workers
        self._sel_rate = np.zeros(n)      # EWMA of the selected indicator
        self._dist_z = np.zeros(n)        # EWMA of the clipped z-score
        self._quarantine = np.zeros(n)    # EWMA of the quarantined indicator
        self.collusion = np.zeros(n)      # EWMA of the near-duplicate flag
        self.partners = np.zeros((n, n), dtype=bool)  # last step's adjacency
        self.suspicion = np.zeros(n)
        self._suspect = np.zeros(n, dtype=bool)

    # -------------------------------------------------------------- #

    def _ewma(self, state, observation):
        return (1.0 - self.alpha) * state + self.alpha * observation

    def update(self, step, selection, distances=None, active=None,
               dist_matrix=None):
        """Fold one step's diagnostics into the scores.

        Args:
          step: the step number (the JAX tracker stamps its events with
            it).
          selection: (n,) selection mask/mass from the GAR aux (> 0 means
            the worker contributed to the aggregate).
          distances: optional (n,) per-worker mean pairwise distance
            (`Worker dist` metric); non-finite entries count as maximally
            far.
          active: optional (n,) post-quarantine active mask (1 = healthy);
            absent means nobody was quarantined this step.
          dist_matrix: optional (n, n) pairwise-distance matrix (the diag
            aux `dist`) feeding the collusion channel — only consumed
            when the tracker was built with a 4-tuple of weights.
        Returns:
          The (n,) suspicion array after the update.
        """
        n = self.nb_workers
        selection = np.asarray(selection, dtype=np.float64).reshape(n)
        selected = (selection > 0.0).astype(np.float64)
        self._sel_rate = self._ewma(self._sel_rate, selected)

        if distances is not None:
            d = np.asarray(distances, dtype=np.float64).reshape(n)
            finite = np.isfinite(d)
            if finite.any():
                mean = float(d[finite].mean())
                std = float(d[finite].std())
                z = np.full(n, Z_CLIP)
                if std > 0.0:
                    z[finite] = np.clip((d[finite] - mean) / std, 0.0, Z_CLIP)
                else:
                    z[finite] = 0.0
            else:
                z = np.full(n, Z_CLIP)
            self._dist_z = self._ewma(self._dist_z, z)

        quarantined = (np.zeros(n) if active is None
                       else 1.0 - (np.asarray(active, dtype=np.float64)
                                   .reshape(n) > 0.0))
        self._quarantine = self._ewma(self._quarantine, quarantined)

        if len(self.weights) == 4 and dist_matrix is not None:
            self.partners = collusion_partners(dist_matrix,
                                               self.collusion_frac)
            self.collusion = self._ewma(
                self.collusion, self.partners.any(axis=1).astype(np.float64))

        self.steps += 1
        mean_rate = float(self._sel_rate.mean())
        if mean_rate > 0.0:
            deficit = np.clip((mean_rate - self._sel_rate) / mean_rate,
                              0.0, 1.0)
        else:
            deficit = np.zeros(n)
        w_sel, w_dist, w_quar = self.weights[:3]
        self.suspicion = (w_sel * deficit
                          + w_dist * self._dist_z / Z_CLIP
                          + w_quar * self._quarantine)
        if len(self.weights) == 4:
            self.suspicion = self.suspicion + self.weights[3] * self.collusion
        self._emit_edges(step)
        return self.suspicion

    def _emit_edges(self, step):
        """Move the suspect set across its rising (`threshold`) and falling
        (`clear`) edges, once `min_steps` observations are in, emitting
        `suspect_worker`/`suspect_cleared` stamped with `step`."""
        if self.steps < self.min_steps:
            return
        rising = (self.suspicion >= self.threshold) & ~self._suspect
        falling = (self.suspicion <= self.clear) & self._suspect
        for worker in np.nonzero(rising)[0]:
            self._suspect[worker] = True
            recorder.emit("suspect_worker", worker=int(worker), step=step,
                          suspicion=round(float(self.suspicion[worker]), 4),
                          sel_rate=round(float(self._sel_rate[worker]), 4))
        for worker in np.nonzero(falling)[0]:
            self._suspect[worker] = False
            recorder.emit("suspect_cleared", worker=int(worker), step=step,
                          suspicion=round(float(self.suspicion[worker]), 4))

    # -------------------------------------------------------------- #

    @property
    def suspects(self):
        """Currently-suspect worker indices (sorted list of ints)."""
        return [int(w) for w in np.nonzero(self._suspect)[0]]

    def max(self):
        """The current maximum suspicion score (the `Suspicion max` study
        column)."""
        return float(self.suspicion.max()) if self.nb_workers else 0.0

    def summary(self):
        """JSON-safe snapshot (heartbeat / report consumption)."""
        out = {
            "steps": self.steps,
            "suspects": self.suspects,
            "suspicion": [round(float(s), 4) for s in self.suspicion],
            "sel_rate": [round(float(r), 4) for r in self._sel_rate],
        }
        if len(self.weights) == 4:
            out["collusion"] = [round(float(c), 4) for c in self.collusion]
        return out
