"""PyTorch port vs JAX: the configuration layer and the other JAX-free
copies (``utils/config.py``, ``utils/component.py``, ``models/cart.py``,
``pipeline/model_combination.py``), and the profiling helper
(``utils/profiling.py``, the port's own over ``torch.profiler``).

The port keeps its own copies of these host modules. ``component.py``,
``cart.py`` and ``model_combination.py`` are byte-identical to the
reference's; ``config.py`` differs only in the docstring line that names
the package of ``component.py``. Every case of ``tests/test_config.py``
runs once more with the port's modules in the place of the reference's
(exact: the same host code).
"""

import os
import sys

import pytest

import tests.test_config as config_cases
from rasr_tpu.utils import component as jcomp
from rasr_tpu.utils import config as jconf
from rasr_tpu_torch.utils import component as tcomp
from rasr_tpu_torch.utils import config as tconf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = ("utils/component.py", "models/cart.py", "pipeline/model_combination.py")


def _read(pkg, path):
    with open(os.path.join(ROOT, pkg, path), "rb") as f:
        return f.read()


@pytest.mark.parametrize("path", COPIES)
def test_host_copies_are_byte_identical(path):
    assert _read("rasr_tpu_torch", path) == _read("rasr_tpu", path)


def test_config_copy_differs_only_in_its_docstring_reference():
    want = _read("rasr_tpu", "utils/config.py").replace(
        b":mod:`rasr_tpu.utils.component`", b":mod:`rasr_tpu_torch.utils.component`")
    assert _read("rasr_tpu_torch", "utils/config.py") == want


@pytest.mark.parametrize("name", sorted(n for n in dir(config_cases) if n.startswith("test_")))
def test_config_case_on_the_port(name, monkeypatch, tmp_path):
    """``tests/test_config.py::<name>`` with every name it takes from the
    reference's ``config`` and ``component`` modules bound to the port's
    (and ``Demo`` rebuilt on the port's ``Component``)."""
    monkeypatch.setitem(sys.modules, "rasr_tpu.utils.config", tconf)
    monkeypatch.setitem(sys.modules, "rasr_tpu.utils.component", tcomp)
    swapped = 0
    for key, value in list(vars(config_cases).items()):
        for jmod, tmod in ((jconf, tconf), (jcomp, tcomp)):
            if getattr(jmod, key, None) is value and value is not None:
                monkeypatch.setattr(config_cases, key, getattr(tmod, key))
                swapped += 1
    demo = type("Demo", (tcomp.Component,), {
        k: v for k, v in vars(config_cases.Demo).items()
        if isinstance(v, jcomp.Parameter)})
    for attr, decl in vars(demo).items():  # the same declarations, the port's types
        if isinstance(decl, jcomp.Parameter):
            port = getattr(tcomp, type(decl).__name__).__new__(getattr(tcomp, type(decl).__name__))
            port.__dict__.update(decl.__dict__)
            setattr(demo, attr, port)
    monkeypatch.setattr(config_cases, "Demo", demo)
    assert swapped >= 9 and config_cases.Configuration is tconf.Configuration
    fn = getattr(config_cases, name)
    args = {"tmp_path": tmp_path} if "tmp_path" in fn.__code__.co_varnames[
        :fn.__code__.co_argcount] else {}
    fn(**args)


def test_unknown_parameters_reported_alike():
    """Both packages flag the same rules as unknown after the same lookups."""
    out = []
    for conf in (jconf, tconf):
        cfg = conf.Configuration()
        cfg.parse_args(["--*.device=cpu", "--tool.beam=3", "--tool.bemm=4", "--tool.x.y=1"])
        cfg.resolve("tool", "beam")
        cfg.note_param("device")
        out.append([r.pattern for r in cfg.unused_rules()])
    assert out[0] == out[1] == [("tool", "bemm"), ("tool", "x", "y")]


def test_profiling_helper(tmp_path):
    """``profile_call`` runs the function under a trace (after its
    warm-up calls) and returns per-op rows with the reference's keys,
    sorted by self time; on the CPU they are the host ops (the reference's
    documented CPU result is an empty or host-only table)."""
    import torch

    from rasr_tpu_torch.utils.profiling import profile_call, top_table

    calls = []

    def f(x):
        calls.append(1)
        return (x * x).sum()

    out, rows = profile_call(f, torch.ones(64, 64), log_dir=str(tmp_path / "prof"))
    assert float(out) == 64.0 * 64.0 and len(calls) == 2
    assert isinstance(rows, list) and rows
    assert all(set(r) == {"program", "name", "category", "occurrences", "self_time_us"}
               for r in rows)
    assert {r["category"] for r in rows} == {"cpu"}
    times = [r["self_time_us"] for r in rows]
    assert times == sorted(times, reverse=True)
    assert (tmp_path / "prof" / "trace.json").exists()
    table = top_table(rows, n=3)
    assert isinstance(table, str) and len(table.splitlines()) == 4
