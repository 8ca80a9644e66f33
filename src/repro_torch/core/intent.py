"""Resource intent: what the user *means*, not which hardware to use.

The paper's CLI shows the idea: ``adviser run "python train.py" --gpu 1
--ram 32`` — capabilities and constraints, never instance types.  Our
equivalent captures the knobs a scientist actually has: the workload
(arch × shape), a goal, and optional constraints (budget, deadline,
chip-count bounds).  Explicit overrides (``slice_name``, ``mesh_shape``)
remain available for experts — the paper's third CLI example.

A copy of the reference package's ``core/intent.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ResourceIntent:
    arch: str
    shape: str
    goal: str = "production"  # production | quick_test | exploration
    # constraints (all optional — the planner fills the gaps)
    budget_usd_per_hour: Optional[float] = None
    max_step_seconds: Optional[float] = None
    min_chips: Optional[int] = None
    max_chips: Optional[int] = None
    chip_generation: Optional[str] = None  # v4 | v5e | v5p | h100 (the card)
    allow_multi_pod: bool = True
    # expert overrides (bypass parts of the search)
    slice_name: Optional[str] = None
    mesh_shape: Optional[Tuple[int, ...]] = None

    def validate(self) -> None:
        if self.goal not in ("production", "quick_test", "exploration"):
            raise ValueError(
                f"unknown goal {self.goal!r}; expected production, "
                f"quick_test or exploration"
            )
        if self.min_chips and self.max_chips and self.min_chips > self.max_chips:
            raise ValueError(
                f"min_chips ({self.min_chips}) exceeds max_chips "
                f"({self.max_chips})"
            )

    def with_goal(self, goal: str) -> "ResourceIntent":
        """A copy re-aimed at another goal — how a workflow gives its
        cheap stages (data prep) a different target than its train stage."""
        out = dataclasses.replace(self, goal=goal)
        out.validate()
        return out
