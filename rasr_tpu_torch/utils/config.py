"""Hierarchical configuration with RASR selector semantics.

Re-implements the behavior of the reference's configuration system
(ref: src/Core/Configuration.{hh,cc}, src/Core/Parameter.{hh,cc}):

* rules are ``selector.path.param = value`` lines; selector components may
  be the wildcard ``*`` which matches any (possibly empty) run of path
  components;
* config files may use INI-style group headers ``[a.b]`` that prefix the
  following ``param = value`` lines;
* ``include <file>`` pulls in another config file;
* ``$(name)`` references are substituted from (a) other resolvable
  parameters at the same selection, (b) ``var`` definitions, (c) the
  process environment — with ``$(name:default)`` fallback syntax;
* command-line overrides ``--a.b.c=value`` append highest-priority rules;
* resolution for a component path ``a.b.c`` and parameter ``p`` picks the
  matching rule with the highest specificity (number of literally matched
  components); ties are broken by declaration order (later wins).

Typed parameter declaration lives in :mod:`rasr_tpu_torch.utils.component`.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Rule:
    """One configuration assignment ``pattern -> value``."""

    pattern: Tuple[str, ...]  # components; '*' is a wildcard
    value: str
    order: int  # declaration order; larger = later = higher priority on ties
    source: str = ""  # file:line for diagnostics

    @property
    def specificity(self) -> int:
        return sum(1 for c in self.pattern if c != "*")


def _match(pattern: Sequence[str], path: Sequence[str]) -> bool:
    """Glob-style match where '*' spans zero or more path components."""
    # Iterative DP over (pattern index, path index).
    pi, si = 0, 0
    star_pi, star_si = -1, -1
    while si < len(path):
        if pi < len(pattern) and (pattern[pi] == path[si]):
            pi += 1
            si += 1
        elif pi < len(pattern) and pattern[pi] == "*":
            star_pi, star_si = pi, si
            pi += 1
        elif star_pi >= 0:
            pi = star_pi + 1
            star_si += 1
            si = star_si
        else:
            return False
    while pi < len(pattern) and pattern[pi] == "*":
        pi += 1
    return pi == len(pattern)


_REF_RE = re.compile(r"\$\(([^()]*)\)")
_COMMENT_RE = re.compile(r"(?<!\\)#.*$")


class Configuration:
    """A priority-ordered rule set with RASR-style resolution."""

    def __init__(self) -> None:
        self._rules: List[Rule] = []
        self._variables: Dict[str, str] = {}
        self._order = 0
        self._used: set = set()  # orders of rules matched by a lookup
        self._known_params: set = set()  # param names any component declared/queried

    # ------------------------------------------------------------------ build
    def set(self, selector: str, value: Any, source: str = "<api>") -> None:
        pattern = tuple(c for c in selector.split(".") if c)
        self._order += 1
        self._rules.append(Rule(pattern, str(value), self._order, source))

    def set_variable(self, name: str, value: str) -> None:
        self._variables[name] = str(value)

    def load_file(self, path: str, group: str = "") -> None:
        base_dir = os.path.dirname(os.path.abspath(path))
        with open(path, "r", encoding="utf-8") as fh:
            for lineno, raw in enumerate(fh, 1):
                line = _COMMENT_RE.sub("", raw).strip().replace("\\#", "#")
                if not line:
                    continue
                if line.startswith("[") and line.endswith("]"):
                    group = line[1:-1].strip()
                    continue
                if line.startswith("include"):
                    inc = line[len("include"):].strip()
                    inc = self._substitute(inc, ())
                    if not os.path.isabs(inc):
                        inc = os.path.join(base_dir, inc)
                    self.load_file(inc, group)
                    continue
                if "=" not in line:
                    raise ValueError(f"{path}:{lineno}: expected 'key = value': {raw!r}")
                key, _, value = line.partition("=")
                key, value = key.strip(), value.strip()
                if key.startswith("var "):
                    self.set_variable(key[4:].strip(), value)
                    continue
                selector = f"{group}.{key}" if group else key
                self.set(selector, value, source=f"{path}:{lineno}")

    def parse_args(self, argv: Iterable[str]) -> List[str]:
        """Consume ``--a.b=c`` and ``--config=<file>`` args; return the rest."""
        rest: List[str] = []
        for arg in argv:
            if arg.startswith("--") and "=" in arg:
                key, _, value = arg[2:].partition("=")
                if key == "config":
                    self.load_file(value)
                else:
                    self.set(key, value, source="<cmdline>")
            else:
                rest.append(arg)
        return rest

    # ---------------------------------------------------------------- resolve
    def _lookup(self, path: Tuple[str, ...]) -> Optional[Rule]:
        best: Optional[Rule] = None
        for rule in self._rules:
            if _match(rule.pattern, path):
                # every MATCHING rule counts as known, not just the
                # winner: a rule shadowed by a more specific override is
                # not a typo
                self._used.add(rule.order)
                if (
                    best is None
                    or rule.specificity > best.specificity
                    or (rule.specificity == best.specificity and rule.order > best.order)
                ):
                    best = rule
        return best

    def _substitute(self, value: str, context: Tuple[str, ...], depth: int = 0) -> str:
        if depth > 16:
            raise ValueError(f"circular $() reference while expanding {value!r}")

        def repl(m: "re.Match[str]") -> str:
            name, sep, default = m.group(1).partition(":")
            name = name.strip()
            if name in self._variables:
                return self._substitute(self._variables[name], context, depth + 1)
            # other parameter at the same selection, then progressively outer
            for cut in range(len(context), -1, -1):
                rule = self._lookup(context[:cut] + tuple(name.split(".")))
                if rule is not None:
                    return self._substitute(rule.value, context, depth + 1)
            if name in os.environ:
                return os.environ[name]
            if sep != "":
                return default
            raise KeyError(f"unresolved reference $({name})")

        return _REF_RE.sub(repl, value)

    def resolve(self, selection: str, name: str) -> Optional[str]:
        """Resolve parameter ``name`` for component path ``selection``."""
        context = tuple(c for c in selection.split(".") if c)
        rule = self._lookup(context + (name,))
        if rule is None:
            return None
        return self._substitute(rule.value, context)

    # ------------------------------------------------------------------ debug
    def dump(self) -> str:
        return "\n".join(
            f"{'.'.join(r.pattern)} = {r.value}   # {r.source}" for r in self._rules
        )

    def note_param(self, name: str) -> None:
        """Record a parameter name some component declares/queries (for
        unknown-parameter detection)."""
        self._known_params.add(name)

    def unused_rules(self) -> List[Rule]:
        """Rules that look like TYPOS: never matched by any lookup AND
        naming a parameter no component ever declared or queried (ref:
        the reference's unknown-parameter detection — a typo'd selector
        is silently inert otherwise; Application warns about these at
        shutdown). Rules with a known param name that merely lost every
        resolution (shadowed overrides, params unread on the taken code
        path) are NOT flagged — those are legitimate configs."""
        return [
            r for r in self._rules
            if r.order not in self._used
            and (not r.pattern or r.pattern[-1] not in self._known_params)
        ]

    def rules_under(self, selection: str) -> Dict[str, str]:
        """All literal (non-wildcard) rules whose pattern starts with selection."""
        prefix = tuple(c for c in selection.split(".") if c)
        out: Dict[str, str] = {}
        for rule in self._rules:
            if "*" in rule.pattern:
                continue
            if rule.pattern[: len(prefix)] == prefix:
                out[".".join(rule.pattern[len(prefix):])] = rule.value
        return out
