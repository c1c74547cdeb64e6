"""Swap attributes of the program's modules and objects for a stretch of
a run, and put them back."""
from __future__ import annotations

from typing import Any, List, Tuple


class Patches:
    def __init__(self):
        self._saved: List[Tuple[Any, str, Any]] = []

    def set(self, target, name: str, value) -> Any:
        """Set ``target.name`` to ``value``; returns what it was."""
        old = getattr(target, name)
        self._saved.append((target, name, old))
        setattr(target, name, value)
        return old

    def restore(self) -> None:
        for target, name, old in reversed(self._saved):
            setattr(target, name, old)
        self._saved = []
