"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic (``benchmark/spec.py``),
builds the system from the seed, warms up, measures for ``--seconds``,
checks a sample of what the timed path produced against the plain
reference, and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``check``: each number compared, with its limit
(also the last lines on standard error). It runs only on a CUDA card and
exits non-zero without a result where there is none, where the cell asks
for more cards than there are, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "rasr_tpu")


def process_start() -> float:
    """This process's start on ``time.time()``'s clock (Linux ``/proc``)."""
    with open("/proc/self/stat") as fh:
        ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as fh:
        uptime = float(fh.read().split()[0])
    return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")


def cpu_mhz() -> float:
    """The host's mean CPU clock now, from ``/proc/cpuinfo`` (0 where it
    says none)."""
    with open("/proc/cpuinfo") as fh:
        mhz = [float(line.split(":")[1]) for line in fh if line.startswith("cpu MHz")]
    return sum(mhz) / len(mhz) if mhz else 0.0


def forbidden_modules(names=None) -> list:
    """Loaded modules (or ``names``) whose top-level name, the part before
    the first dot, is one of :data:`FORBIDDEN` as a whole word."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)}
                  & set(FORBIDDEN))


def cache_dirs(root) -> None:
    """Keep every build and kernel cache inside the checkout, at fixed paths."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / ".bench_cache" / sub)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("tf32", "fp8"), default=None,
                   help="put the reference, computed in this lower precision, in the "
                        "program's place (the control of the check; not a benchmark run)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    started = process_start()
    args = parse(argv)
    cache_dirs(spec.ROOT)
    bench = spec.benchmark()
    import torch

    import rasr_tpu_torch  # noqa: F401  (the program under test; fails where it is absent)

    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    run = spec.resolve(bench, args.workload, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace), device=torch.device("cuda", 0), started=started,
                       control=args.control)
    if torch.cuda.device_count() < run.cell["chips"]:
        print(f"{run.cell['name']} needs {run.cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    mhz = cpu_mhz()
    out = spec.job(run).run(run)
    print(f"host: {os.cpu_count()} CPUs, on {sorted(os.sched_getaffinity(0))}, mean clock "
          f"{mhz:.0f} MHz at set-up, {cpu_mhz():.0f} MHz after the check", file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in the benchmark's process: {bad}", file=sys.stderr)
        return 3
    line = result_line(bench, run, out, torch.cuda.get_device_name(0))
    for name, (value, limit) in out["check"].items():
        print(f"check {name}: {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def result_line(bench: dict, run, out: dict, kind: str) -> dict:
    """The contract's result line from a job's output."""
    name = run.cell["name"]
    device = {"platform": "gpu", "kind": kind, "count": run.cell["chips"],
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    check = {k: {"value": v, "limit": lim} for k, (v, lim) in out["check"].items()}
    correct = out["failed"] == 0 and all(
        lim is not None and v <= lim for v, lim in out["check"].values())
    line = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    if run.trace:
        summary = out["layer"]["summary"]
        device.update(busy_s=summary.busy_s, window_s=summary.window_s)
        line["metrics"] = spec.read_layer_metrics(bench, name, out["layer"])
        line["breakdown"] = {"device_ops": [list(x) for x in summary.device_ops],
                             "idle_gaps": [list(x) for x in summary.idle_gaps]}
    else:
        units = {m["name"]: m["unit"] for m in spec.metrics_of(bench, name, "end_to_end")}
        line["metrics"] = {m: {"value": v, "unit": units[m]}
                           for m, v in out["end_to_end"].items() if m in units}
    line["device"] = device
    line["check"] = check
    return line


if __name__ == "__main__":
    sys.exit(main())
