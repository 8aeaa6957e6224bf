"""CLI application skeleton.

Re-implements the reference's application framework
(ref: src/Core/Application.* — config load, channel setup, usage/help,
run() dispatch). Every tool subclasses :class:`Application`; invocation
is ``python -m rasr_tpu_torch.tools.<tool> --config=file --a.b.c=value ...``
with full RASR selector-override semantics.

The port's copy of ``rasr_tpu/tools/application.py`` adds the ``device``
parameter: a tool computes on the card unless its configuration names
another device (``--*.device=cpu`` on the command line, ``device = cpu``
in a config file). Left empty it means ``device.resolve(None)``, the card,
which raises when none is visible. At the end of a run the tool logs the
launches of each hand-written kernel (``kernel launches``).
"""

from __future__ import annotations

import functools
import sys
import traceback
from typing import List, Optional, Sequence

import torch

from ..device import card_tag, resolve
from ..ops.kernels.gmm import gmm_scores
from ..ops.kernels.mfcc import mfcc_frames
from ..ops.kernels.row_gather import row_gather
from ..ops.kernels.wordend import wordend_block
from ..utils.component import Component, Parameter, ParameterString
from ..utils.config import Configuration
from ..utils.logging import LogManager


#: the kernel wrappers whose launches a run reports
KERNELS = (gmm_scores, mfcc_frames, wordend_block, row_gather)


class Application(Component):
    name: str = "application"
    description: str = ""

    log_file = ParameterString("log-file", default="", doc="JSONL log target")
    device = ParameterString(
        "device", default="",
        doc="torch device to compute on (e.g. cpu, cuda:1); empty = the card, "
            "an error when none is visible")

    def __init__(self, config: Configuration):
        super().__init__(config, self.name)
        if self.log_file:
            LogManager.get().open_jsonl(self.log_file)
            self.log("system-information", **self._system_information())

    @functools.cached_property
    def torch_device(self) -> torch.device:
        """The device the tool computes on (resolved at first use)."""
        return resolve(self.device or None)

    def _system_information(self):
        """Host/runtime facts logged at startup (ref: the reference's
        <system-information> element in every XML log): the torch and
        CUDA versions, and the card's name and power limit when the tool
        computes on a visible card."""
        import os
        import platform

        info = {
            "hostname": platform.node(),
            "python": platform.python_version(),
            "pid": os.getpid(),
            "machine": platform.machine(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device": self.device or "cuda",
        }
        if torch.device(info["device"]).type == "cuda" and torch.cuda.is_available():
            info["card"] = card_tag()
        return info

    def run(self, args: List[str]) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    @classmethod
    def declared_parameters(cls):
        """(name, default-with-choices, doc) for every declared typed
        parameter, in declaration order (ref: the reference prints its
        Core::Parameter registry in usage/help output)."""
        out, seen = [], set()
        for klass in reversed(cls.__mro__):
            for attr, val in vars(klass).items():
                if isinstance(val, Parameter) and val.name not in seen:
                    seen.add(val.name)
                    default = val.default
                    choices = getattr(val, "choices", None)
                    if choices:
                        default = f"{default} ∈ {{{', '.join(map(str, choices))}}}"
                    out.append((val.name, default, val.doc))
        return out

    @classmethod
    def main(cls, argv: Optional[Sequence[str]] = None) -> int:
        argv = list(sys.argv[1:] if argv is None else argv)
        if "--help" in argv or "-h" in argv:
            print(f"{cls.name}: {cls.description}")
            print(f"usage: python -m rasr_tpu_torch.tools.{cls.name.replace('-', '_')} "
                  f"[--config=FILE] [--selector.param=value ...]")
            for pname, default, doc in cls.declared_parameters():
                d = f" (default: {default!r})" if default not in (None, "") else ""
                print(f"  --{cls.name}.{pname}{d}{'  ' + doc if doc else ''}")
            return 0
        config = Configuration()
        rest = config.parse_args(argv)
        if "--dump-config" in rest:
            # resolved-configuration dump channel (ref: the reference's
            # config dump: every rule with its source, for debugging
            # selector precedence)
            rest.remove("--dump-config")
            print(config.dump())
        app = cls(config)
        try:
            rc = app.run(rest)
        except Exception as exc:
            app.error(f"{type(exc).__name__}: {exc}")
            traceback.print_exc()
            return 1
        app.log("kernel launches", **{fn.__name__: fn.launches for fn in KERNELS})
        # unknown-parameter detection (ref: Core::Configuration usage
        # checking): a mistyped selector/param never gets looked up, so
        # it would otherwise be silently inert
        for rule in config.unused_rules():
            app.warning(
                f"unknown/unused parameter: {'.'.join(rule.pattern)} = "
                f"{rule.value} ({rule.source})"
            )
        return rc
