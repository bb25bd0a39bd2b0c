"""Training schedule arithmetic: phases, fades, and chunk planning.

A copy of neuron_gan_tpu/schedule.py (pure Python; the port imports nothing
of the JAX package).  Training runs as epoch chunks; this module owns the
pure arithmetic that decides, for any epoch,

* which resolution phase is active (a transition at epoch t applies *at* t —
  reference train.py:328-333),
* whether a fade-in is in progress and its alpha
  (alpha(e) = (e - t0) * alpha_step while < 1; train.py:319-321),
* where the current chunk must end (never crossing a transition start, a
  fade-in completion, a checkpoint boundary, or the end of the run), and
* the lr-phase parameters for the chunk (reference train.py:233-265).
"""

import dataclasses
import math
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class TrainSchedule:
    transit_sch: Tuple[int, ...]
    alpha_step: float
    n_epochs: int
    checkpointing_period: int
    lr0: float
    lr_total_decay: float = 1 / 100

    def __post_init__(self):
        # The CLI parses --transit_sch as float (reference train.py:63
        # parity); chunk lengths must be ints, so coerce exact values here
        ts = []
        for t in self.transit_sch:
            if int(t) != t:
                raise ValueError(f'transition epoch {t} is not an integer')
            ts.append(int(t))
        object.__setattr__(self, 'transit_sch', tuple(ts))
        # Overlapping fades would silently mis-pair phase_at (newest
        # transition) with fading_at (oldest active fade) — the new block
        # would start fading mid-alpha.  The reference fails fast on such
        # configs (configs/config.py:196-200 requires transition spacing
        # > 1/alpha_step; train.py:322-325 guards alpha desync) — mirror
        # that here so schedules built outside import_configs are covered.
        ts = self.transit_sch
        for a, b in zip(ts, ts[1:]):
            if b - a < self.fade_len:
                raise ValueError(
                    f'transitions at {a} and {b} are {b - a} epochs apart '
                    f'but a fade-in lasts {self.fade_len} epochs '
                    f'(alpha_step={self.alpha_step}); space transitions at '
                    f'least one fade apart (reference configs/config.py:196-200)')

    @property
    def fade_len(self) -> int:
        return math.ceil(1 / self.alpha_step)

    @property
    def boundaries(self) -> List[int]:
        return [0] + list(self.transit_sch) + [self.n_epochs]

    @property
    def phase_lens(self) -> List[int]:
        b = self.boundaries
        return [b[i + 1] - b[i] for i in range(len(b) - 1)]

    @property
    def gammas(self) -> List[float]:
        return [math.exp(math.log(self.lr_total_decay) / (pl / 2))
                for pl in self.phase_lens]

    # ---------------------------------------------------------------- phase
    def phase_at(self, epoch: int) -> int:
        """Number of transitions applied when training ``epoch`` (a
        transition scheduled at t takes effect at t)."""
        return sum(epoch >= t for t in self.transit_sch)

    def fading_at(self, epoch: int) -> Tuple[bool, int]:
        """(is_fading, fade_start) while training ``epoch``."""
        for t in self.transit_sch:
            if t <= epoch < t + self.fade_len:
                return True, t
        return False, 0

    def alpha_at(self, epoch: int) -> float:
        fading, t0 = self.fading_at(epoch)
        if not fading:
            return 1.0
        return min((epoch - t0) * self.alpha_step, 1.0)

    # ------------------------------------------------------------------- lr
    def lr_phase_of_chunk(self, chunk_start: int) -> int:
        """lr-phase index for a chunk starting at ``chunk_start``; a chunk
        starting exactly at a transition belongs to the new phase (its first
        epoch still runs at the old phase's final lr via lr_prev_final)."""
        return sum(chunk_start >= t for t in self.transit_sch)

    def lr_at(self, epoch: int) -> float:
        """lr in effect while training ``epoch`` (= the value set by the
        reference's update_lr(epoch-1))."""
        e = epoch - 1
        if e <= 0 or e in self.boundaries:
            return self.lr0
        phase = sum(e > t for t in self.transit_sch)
        e_since = e - self.boundaries[phase]
        cap = math.floor(self.phase_lens[phase] / 2)
        return self.lr0 * (self.gammas[phase] ** min(e_since, cap))

    # ---------------------------------------------------------------- chunks
    def chunk_end(self, epoch: int, epoch_final: int,
                  adapt_period: int = None) -> int:
        """Last epoch of the chunk starting at ``epoch``.

        Stops at (whichever comes first): the epoch before the next
        transition, the last fading epoch of an active fade, the next
        checkpoint boundary, or the final epoch of the run.
        ``adapt_period`` (adapt_critic) additionally aligns chunks to
        multiples of the critic-adaptation window so N_D is recomputed with
        at most a window of staleness — the reference recomputes per epoch
        from the same 100-epoch lookback (train.py:336-340), so a
        window-aligned recompute sees the identical information horizon.
        """
        stops = [epoch_final - 1]
        stops.append(((epoch - 1) // self.checkpointing_period + 1)
                     * self.checkpointing_period)
        if adapt_period:
            stops.append(((epoch - 1) // adapt_period + 1) * adapt_period)
        for t in self.transit_sch:
            if t > epoch:
                stops.append(t - 1)
            if t <= epoch < t + self.fade_len:
                stops.append(t + self.fade_len - 1)
        return min(s for s in stops if s >= epoch)

    def plan_chunks(self, epoch_init: int, epoch_final: int,
                    adapt_period: int = None):
        """Yield (start, end) chunks covering [epoch_init, epoch_final)."""
        e = epoch_init
        while e < epoch_final:
            end = self.chunk_end(e, epoch_final, adapt_period)
            yield e, end
            e = end + 1


def sim_lambda_at(epoch: int, lam0: float, decay_rate: float) -> float:
    """Similarity-loss weight in effect at ``epoch`` (reference
    train.py:343-348): exponential decay, clamped to 0 below 1e-5 (the
    float64 mirror of train_step.epoch_scalars)."""
    if lam0 <= 0:
        return 0.0
    if decay_rate <= 0:
        return lam0
    lam = lam0 * (1 - decay_rate) ** (epoch - 1)
    return lam if lam > 1e-5 else 0.0
