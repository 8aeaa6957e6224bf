"""HMM topology and transition (TDP) model.

Re-implements the reference's state model / transition model
(ref: src/Am/ClassicStateModel.*, src/Am/ClassicTransitionModel.*):
phones expand to left-to-right HMMs (default 3 emitting states, silence 1),
and transitions carry time-distortion penalties (TDPs) — additive -log
scores for loop / forward / skip / exit, configured per state class
(speech vs silence), exactly the reference's ``tdp.*`` / ``tdp.silence``
parameter groups.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

INF = math.inf


@dataclasses.dataclass(frozen=True)
class Tdp:
    """-log penalties for one state class (ref: tdp.{loop,forward,skip,exit})."""

    loop: float = 3.0
    forward: float = 0.0
    skip: float = INF
    exit: float = 0.0

    def as_tuple(self) -> Tuple[float, float, float, float]:
        return (self.loop, self.forward, self.skip, self.exit)


@dataclasses.dataclass(frozen=True)
class TransitionModel:
    """TDP sets per state class.

    The reference distinguishes entry states (*0), middle states, and
    silence; we keep the commonly used speech/silence split plus an
    optional per-position override.
    """

    speech: Tdp = Tdp(loop=3.0, forward=0.0, skip=30.0, exit=0.0)
    silence: Tdp = Tdp(loop=0.0, forward=3.0, skip=INF, exit=20.0)

    def for_class(self, is_silence: bool) -> Tdp:
        return self.silence if is_silence else self.speech

    @classmethod
    def from_config(cls, component) -> "TransitionModel":
        """Build from a Component scope with tdp.speech.* / tdp.silence.*."""
        def read(scope, name, default):
            raw = component.config.resolve(f"{component.full_name}.tdp.{scope}", name)
            if raw is None:
                return default
            return INF if raw in ("inf", "infinity") else float(raw)

        return cls(
            speech=Tdp(
                loop=read("speech", "loop", 3.0),
                forward=read("speech", "forward", 0.0),
                skip=read("speech", "skip", 30.0),
                exit=read("speech", "exit", 0.0),
            ),
            silence=Tdp(
                loop=read("silence", "loop", 0.0),
                forward=read("silence", "forward", 3.0),
                skip=read("silence", "skip", INF),
                exit=read("silence", "exit", 20.0),
            ),
        )


@dataclasses.dataclass(frozen=True)
class HmmTopology:
    """States-per-phone layout (ref: Am::ClassicHmmTopology).

    ``states_per_phone`` emitting states per regular phone,
    ``silence_states`` for context-independent silence-like phones,
    ``state_repetitions`` repeats each state (the reference's default
    6-subState/2-repetition trick is expressed as repetitions=2).
    """

    states_per_phone: int = 3
    silence_states: int = 1
    state_repetitions: int = 1

    def num_states(self, context_independent: bool) -> int:
        n = self.silence_states if context_independent else self.states_per_phone
        return n * self.state_repetitions

    def emitting_state_index(self, pos: int) -> int:
        """HMM position -> emission sub-state index (repetitions collapse)."""
        return pos // self.state_repetitions
