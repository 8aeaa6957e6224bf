"""What a run is: its cell, configuration and traffic, found by name.

Everything that belongs to one configuration, acoustic model, traffic mix
or per-layer metric sits in a file of its own, found from the names in
``BENCHMARK.json``: the configuration's ``file``, the module of
``benchmark/models`` that the configuration's ``"scorer"`` names
(:func:`model`), ``benchmark/traffic/<traffic>.json`` (whose ``job``
names the module of ``benchmark/jobs`` that drives it) and
``benchmark/metrics/<metric>.py``.

A model module provides ``draw``, ``weights`` and ``tiny`` for every job;
``scorer``, ``forward_work`` and ``reference_scores`` to decode;
``net``, ``train_step_work`` and ``reference_logits`` to train; and
``mixtures`` for the align job's EM statistics
(``benchmark/models/__init__.py`` says what each is). A new acoustic
model is new files: its configuration, ``models/<name>.py``, its plain
reference under ``reference/``, its counts under ``counts/``, its metric
readers and its entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


@dataclasses.dataclass
class Run:
    """One run of one cell."""

    cell: dict  # the BENCHMARK.json workload
    cfg: dict  # the configuration file's content
    traffic: dict  # the traffic file's content
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    started: float  # the process's start, on time.time()'s clock
    control: Optional[str] = None  # a lower-precision control in the program's place


def resolve(bench: dict, workload: str, **kw) -> Run:
    """The :class:`Run` of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    return Run(cell=cell, cfg=load_json(ROOT / cfg_entry["file"]),
               traffic=load_json(HERE / "traffic" / f"{cell['traffic']}.json"), **kw)


def job(run: Run):
    """The module that drives the run's traffic."""
    return importlib.import_module(f"benchmark.jobs.{run.traffic['job']}")


def model(cfg: dict):
    """The module of ``benchmark/models`` that ``cfg["scorer"]`` names."""
    name = cfg["scorer"]
    try:
        return importlib.import_module(f"benchmark.models.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"benchmark.models.{name}":
            raise
    known = sorted(p.stem for p in (HERE / "models").glob("*.py") if not p.stem.startswith("_"))
    raise KeyError(f"no acoustic model {name!r}: no benchmark/models/{name}.py; have {known}")


def metrics_of(bench: dict, workload: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
    return [m for m in bench[kind] if workload in m.get("workloads", [workload])]


def reader(name: str):
    """The ``read(inputs) -> float | None`` of the per-layer metric ``name``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_layer_metrics(bench: dict, workload: str, inputs: Dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell that its reader finds something
    to read in."""
    out = {}
    for m in metrics_of(bench, workload, "per_layer"):
        value = reader(m["name"])(inputs)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
