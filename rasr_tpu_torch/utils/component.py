"""Configurable component base with typed declared parameters.

Mirrors the reference's ``Core::Component`` / ``Core::Parameter*``
(ref: src/Core/Component.{hh,cc}, src/Core/Parameter.{hh,cc}): a component
has a full dotted name, declares typed parameters with defaults / ranges /
choices, resolves them through the shared :class:`Configuration`, and owns
named log channels.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence

from .config import Configuration
from .logging import Channel, LogManager


class ParameterError(ValueError):
    pass


class Parameter:
    """Typed parameter descriptor declared at class level."""

    def __init__(self, name: str, default: Any = None, doc: str = ""):
        self.name = name
        self.default = default
        self.doc = doc

    def parse(self, raw: str) -> Any:  # pragma: no cover - abstract
        raise NotImplementedError

    def get(self, component: "Component") -> Any:
        component.config.note_param(self.name)
        raw = component.config.resolve(component.full_name, self.name)
        if raw is None:
            return self.default
        try:
            return self.parse(raw)
        except ParameterError:
            raise
        except Exception as exc:
            raise ParameterError(
                f"{component.full_name}.{self.name}: cannot parse {raw!r}: {exc}"
            ) from exc


class ParameterString(Parameter):
    def parse(self, raw: str) -> str:
        return raw


class ParameterInt(Parameter):
    def __init__(self, name, default=0, lo=-math.inf, hi=math.inf, doc=""):
        super().__init__(name, default, doc)
        self.lo, self.hi = lo, hi

    def parse(self, raw: str) -> int:
        v = int(raw, 0)
        if not (self.lo <= v <= self.hi):
            raise ParameterError(f"{self.name}={v} outside [{self.lo},{self.hi}]")
        return v


class ParameterFloat(Parameter):
    def __init__(self, name, default=0.0, lo=-math.inf, hi=math.inf, doc=""):
        super().__init__(name, default, doc)
        self.lo, self.hi = lo, hi

    def parse(self, raw: str) -> float:
        raw = raw.strip()
        if raw in ("inf", "infinity", "+inf"):
            return math.inf
        if raw in ("-inf", "-infinity"):
            return -math.inf
        v = float(raw)
        if not (self.lo <= v <= self.hi):
            raise ParameterError(f"{self.name}={v} outside [{self.lo},{self.hi}]")
        return v


_TRUE = {"true", "yes", "on", "1"}
_FALSE = {"false", "no", "off", "0"}


class ParameterBool(Parameter):
    def parse(self, raw: str) -> bool:
        r = raw.strip().lower()
        if r in _TRUE:
            return True
        if r in _FALSE:
            return False
        raise ParameterError(f"{self.name}: not a boolean: {raw!r}")


class ParameterChoice(Parameter):
    def __init__(self, name, choices: Sequence[str], default=None, doc=""):
        super().__init__(name, default, doc)
        self.choices = list(choices)

    def parse(self, raw: str) -> str:
        if raw not in self.choices:
            raise ParameterError(
                f"{self.name}: invalid choice {raw!r} (choices: {self.choices})"
            )
        return raw


class ParameterIntList(Parameter):
    def parse(self, raw: str) -> List[int]:
        return [int(x) for x in raw.replace(",", " ").split()]


class ParameterFloatList(Parameter):
    def parse(self, raw: str) -> List[float]:
        return [float(x) for x in raw.replace(",", " ").split()]


class Component:
    """Base for all configurable objects.

    Subclasses declare parameters as class attributes::

        class Recognizer(Component):
            beam = ParameterFloat("beam", default=16.0)

    and read them via ``self.beam`` (descriptor-free: resolved in
    ``__init__`` into instance attributes) or ``self.param(name)``.
    """

    def __init__(self, config: Configuration, name: str, parent: Optional["Component"] = None):
        self.config = config
        self.parent = parent
        self.name = name
        self.full_name = name if parent is None else f"{parent.full_name}.{name}"
        self.log = LogManager.get().channel(self.full_name, "log")
        self.warning = LogManager.get().channel(self.full_name, "warning")
        self.error = LogManager.get().channel(self.full_name, "error")
        # resolve declared parameters into instance attributes
        for klass in type(self).__mro__:
            for attr, decl in vars(klass).items():
                if isinstance(decl, Parameter) and not hasattr(self, f"_p_{attr}"):
                    setattr(self, attr, decl.get(self))
                    setattr(self, f"_p_{attr}", decl)

    def param(self, name: str, default: Any = None) -> Any:
        self.config.note_param(name)
        raw = self.config.resolve(self.full_name, name)
        return default if raw is None else raw

    def select(self, child: str) -> "SubConfig":
        """Child configuration context (ref: Core::Component::select)."""
        return SubConfig(self, child)

    def describe_parameters(self) -> Dict[str, str]:
        out = {}
        for klass in type(self).__mro__:
            for attr, decl in vars(klass).items():
                if isinstance(decl, Parameter):
                    out[decl.name] = decl.doc
        return out


class SubConfig(Component):
    """Anonymous child component used purely as a config scope."""

    def __init__(self, parent: Component, name: str):
        super().__init__(parent.config, name, parent)
