"""Budgets & workspaces: the institutional-barrier machinery (paper §4.1).

Instructors allocate a shared budget to a classroom workspace; members'
runs draw from it; the planner refuses plans whose projected burn exceeds
the remainder.  Ledgers are json files so they survive restarts and can be
audited.

A copy of the reference package's ``core/budget.py``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional


class BudgetExceeded(RuntimeError):
    pass


class PermissionDenied(RuntimeError):
    pass


@dataclasses.dataclass
class Workspace:
    name: str
    members: List[str]
    admins: List[str]
    budget_usd: float
    spent_usd: float = 0.0
    allowed_templates: Optional[List[str]] = None  # None = all

    def check_member(self, user: str) -> None:
        if user not in self.members and user not in self.admins:
            raise PermissionDenied(f"{user!r} is not a member of {self.name!r}")

    def check_template(self, template: str) -> None:
        if self.allowed_templates is not None and template not in self.allowed_templates:
            raise PermissionDenied(
                f"template {template!r} is not approved in workspace {self.name!r}"
            )

    @property
    def remaining_usd(self) -> float:
        return self.budget_usd - self.spent_usd


class BudgetLedger:
    def __init__(self, path: str):
        self.path = path
        self._ws: Dict[str, Workspace] = {}
        self._log: List[Dict] = []
        if os.path.exists(path):
            self._load()

    def _load(self) -> None:
        with open(self.path) as f:
            data = json.load(f)
        self._ws = {k: Workspace(**v) for k, v in data["workspaces"].items()}
        self._log = data.get("log", [])

    def _save(self) -> None:
        data = {
            "workspaces": {k: dataclasses.asdict(w) for k, w in self._ws.items()},
            "log": self._log,
        }
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(data, f, indent=1)
        os.replace(tmp, self.path)

    # ------------------------------------------------------------------
    def create_workspace(self, name: str, *, admins: List[str],
                         members: Optional[List[str]] = None,
                         budget_usd: float = 0.0,
                         allowed_templates: Optional[List[str]] = None) -> Workspace:
        ws = Workspace(name, members or [], admins, budget_usd,
                       allowed_templates=allowed_templates)
        self._ws[name] = ws
        self._save()
        return ws

    def get(self, name: str) -> Workspace:
        if name not in self._ws:
            raise KeyError(f"no workspace {name!r}")
        return self._ws[name]

    def add_member(self, name: str, user: str, by: str) -> None:
        ws = self.get(name)
        if by not in ws.admins:
            raise PermissionDenied(f"{by!r} is not an admin of {name!r}")
        if user not in ws.members:
            ws.members.append(user)
        self._save()

    # ------------------------------------------------------------------
    def authorize(self, workspace: str, user: str, template: str,
                  projected_usd: float) -> None:
        """Gate a run before provisioning (planner projection in hand)."""
        ws = self.get(workspace)
        ws.check_member(user)
        ws.check_template(template)
        if ws.spent_usd + projected_usd > ws.budget_usd:
            raise BudgetExceeded(
                f"workspace {workspace!r}: projected ${projected_usd:.2f} exceeds "
                f"remaining ${ws.remaining_usd:.2f}"
            )

    def charge(self, workspace: str, user: str, usd: float, note: str = "") -> None:
        ws = self.get(workspace)
        ws.check_member(user)
        if ws.spent_usd + usd > ws.budget_usd + 1e-9:
            raise BudgetExceeded(
                f"workspace {workspace!r}: ${usd:.2f} exceeds remaining "
                f"${ws.remaining_usd:.2f}"
            )
        ws.spent_usd += usd
        self._log.append({"workspace": workspace, "user": user, "usd": usd,
                          "note": note, "t": time.time()})
        self._save()
