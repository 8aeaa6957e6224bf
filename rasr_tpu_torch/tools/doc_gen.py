"""Generate the tool-parameter reference of the port's tools (Markdown).

Usage: python -m rasr_tpu_torch.tools.doc_gen > tools.md

The reference documents its tools through each component's declared
Core::Parameter registry; this emits the same thing for every CLI tool
from the typed Parameter declarations (tools/application.py).
"""

from __future__ import annotations

import importlib

TOOLS = [
    "feature_extraction",
    "acoustic_model_trainer",
    "speech_recognizer",
    "nn_trainer",
    "flf_tool",
    "lattice_processor",
    "archiver",
    "corpus_statistics",
    "lm_util",
    "fsa_tool",
    "log_analysis",
]


def tool_classes():
    from .application import Application

    for mod_name in TOOLS:
        mod = importlib.import_module(f"rasr_tpu_torch.tools.{mod_name}")
        for val in vars(mod).values():
            if (isinstance(val, type) and issubclass(val, Application)
                    and val is not Application
                    and val.__module__ == mod.__name__):
                yield mod_name, val


def main() -> int:
    print("# Tool reference\n")
    print("Generated from the declared parameter registries "
          "(`python -m rasr_tpu_torch.tools.doc_gen > tools.md`). "
          "All tools take `--config=FILE` plus RASR-style selector "
          "overrides `--<tool>.<param>=value`; scoped sub-configs "
          "(e.g. `--<tool>.frontend.num-cepstra=16`, "
          "`--speech-recognizer.search.beam=...`) follow the same "
          "selector semantics.\n")
    for mod_name, cls in tool_classes():
        print(f"## {cls.name}\n")
        print(f"`python -m rasr_tpu_torch.tools.{mod_name}` — {cls.description}\n")
        doc = (importlib.import_module(cls.__module__).__doc__ or "").strip()
        if doc:
            print("```text")
            print(doc)
            print("```\n")
        print("| parameter | default | notes |")
        print("|---|---|---|")
        for name, default, pdoc in cls.declared_parameters():
            dv = "" if default in (None, "") else f"`{default}`"
            print(f"| `--{cls.name}.{name}` | {dv} | {pdoc} |")
        print()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
