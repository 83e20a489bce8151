"""A minimal name→object registry with decorator registration."""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple


class Registry:
    """Name → object registry.

    >>> PREDICTORS = Registry("predictors")
    >>> @PREDICTORS.register("lasso")
    ... class Lasso: ...
    >>> PREDICTORS.get("lasso")
    <class 'Lasso'>
    """

    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, Any] = {}

    def register(self, name: str) -> Callable[[Any], Any]:
        def deco(obj: Any) -> Any:
            if name in self._items:
                raise KeyError(f"{self.kind} registry already has {name!r}")
            self._items[name] = obj
            return obj

        return deco

    def register_value(self, name: str, obj: Any) -> None:
        if name in self._items:
            raise KeyError(f"{self.kind} registry already has {name!r}")
        self._items[name] = obj

    def get(self, name: str) -> Any:
        if name not in self._items:
            raise KeyError(
                f"unknown {self.kind} {name!r}; known: {sorted(self._items)}"
            )
        return self._items[name]

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def names(self) -> Tuple[str, ...]:
        return tuple(sorted(self._items))

    def items(self) -> Iterator[Tuple[str, Any]]:
        return iter(sorted(self._items.items()))
