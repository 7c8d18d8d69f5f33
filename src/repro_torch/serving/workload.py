"""Synthetic workload scaffolding shared by benchmarks and tests (a copy of
``repro/serving/workload.py``): a structured quality table (no model
execution) and a deterministic cycling policy for engine-vs-engine
comparisons with identical arm decisions."""
from __future__ import annotations

import numpy as np

from repro_torch.core.policies import Policy
from repro_torch.serving.arms import ARMS


def synthetic_quality_table(reqs, arms=None) -> np.ndarray:
    """(N, n_arms) object array of quality dicts with the ordering structure
    the scheduler learns from: later relay steps slightly better (a cascade
    arm's quality tracks its total large+mid step budget), F3 arms strong
    at text (cf. tests/test_serving.py)."""
    arms = arms if arms is not None else ARMS
    qt = np.empty((len(reqs), len(arms)), dtype=object)
    for i, r in enumerate(reqs):
        for a in arms:
            # steps run above the smallest model scale (edge + mid
            # segments); model-keyed rather than positional so DAG programs
            # count their large/mid work wherever it sits in the canonical
            # order — identical to segments[:-1] for every linear arm
            big_steps = sum(
                s.steps for s in a.program.segments if s.model != "small"
            )
            base = 0.55 + 0.1 * min(big_steps, 25) / 25.0
            ocr = (0.75 if a.family == "F3" else 0.08) if r.wants_text else 0.0
            qt[i, a.idx] = {"clip": base, "ir": base, "pick": 0.2 + 0.03 * base,
                            "aes": 5.0 + base, "ocr": ocr}
    return qt


class CyclePolicy(Policy):
    """Deterministic arm cycle, blind to context and availability — two
    engines replaying the same request stream see identical per-request
    decisions, isolating runtime effects from policy effects."""

    name = "Cycle"

    def __init__(self):
        self.i = 0

    def select(self, ctx, avail):
        """Next arm in the fixed cycle (ignores ctx and availability)."""
        arm = self.i % len(avail)
        self.i += 1
        return arm
