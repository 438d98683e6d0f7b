"""Name -> class registries for backbones and probability paths.

The port's own copy of ``fdbm_tpu/utils/registry.py``: re-registration under
the same name raises instead of warning, so config typos fail fast.
"""

from __future__ import annotations

from typing import Callable, Dict, Generic, List, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._members: Dict[str, T] = {}

    def register(self, name: str) -> Callable[[T], T]:
        def wrap(obj: T) -> T:
            if name in self._members and self._members[name] is not obj:
                raise ValueError(f"{self.kind} registry already has '{name}'")
            self._members[name] = obj
            return obj

        return wrap

    def get_by_name(self, name: str) -> T:
        try:
            return self._members[name]
        except KeyError:
            raise ValueError(
                f"Unknown {self.kind} '{name}'. Available: {sorted(self._members)}"
            ) from None

    def get_all_names(self) -> List[str]:
        return sorted(self._members)

    def __contains__(self, name: str) -> bool:
        return name in self._members
