"""Straggler detection (port of ``StragglerDetector`` from
``repro/distributed/fault_tolerance.py``; pure Python, a copy).

``TrainConfig.straggler_z`` flags router-training iterations whose wall
time is a z-score outlier.  The rest of the reference module (elastic
resharding, the mesh after a failure) belongs to distributed training and
is not ported.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class StragglerDetector:
    """z-score straggler flagging on step wall times: Welford during
    warmup, then EMA mean/variance (outliers excluded from the stats)."""

    alpha: float = 0.05
    z_threshold: float = 4.0
    warmup: int = 10
    rel_floor: float = 0.05   # ignore deviations below 5% of the mean
    mean: float = 0.0
    var: float = 0.0
    _m2: float = 0.0
    count: int = 0

    def update(self, dt: float) -> bool:
        """Returns True if this step is flagged as a straggler."""
        self.count += 1
        if self.count <= self.warmup:
            delta = dt - self.mean
            self.mean += delta / self.count
            self._m2 += delta * (dt - self.mean)
            if self.count == self.warmup:
                self.var = max(self._m2 / max(self.warmup - 1, 1), 1e-12)
            return False
        std = math.sqrt(max(self.var, 1e-12))
        std = max(std, self.rel_floor * abs(self.mean), 1e-9)
        z = (dt - self.mean) / std
        flagged = z > self.z_threshold
        if not flagged:  # don't poison stats with outliers
            self.mean = (1 - self.alpha) * self.mean + self.alpha * dt
            self.var = (1 - self.alpha) * self.var + \
                self.alpha * (dt - self.mean) ** 2
        return flagged
