"""Run one cell of the port's benchmark once and print its result line.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is ``h100_bench/workloads/<cell>.json``; it names its model
configuration (``configs/<config>.json``) and its traffic
(``traffic/<traffic>.json``), whose ``driver`` is the loop in
``drivers/<driver>.py``. With ``--trace 0`` the line carries the cell's
end-to-end metrics; with ``--trace 1`` the per-layer metrics, each read
by ``layer_metrics/<metric>.py``. Every run checks the outputs it timed
against the plain reference (``reference/``) and prints each compared
number beside its limit, last, on standard error and under ``check``.

Needs a CUDA device (exits 2 without one, printing no result) and the
port, ``modelcompression_tpu_torch``, beside this folder.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """``time.monotonic()`` at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return time.monotonic()


T0 = _process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":
    # run as a script: import the folder as a package, never its modules
    # by their bare names (``trace`` would shadow the standard library's)
    sys.path[0] = ROOT

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402

BENCH = os.path.join(ROOT, "h100_bench")
FORBIDDEN = ("jax", "jaxlib", "flax", "modelcompression_tpu")


def load_json(*parts):
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def load_module(folder: str, name: str):
    """``h100_bench/<folder>/<name>.py``, found by name (names may hold
    dots)."""
    path = os.path.join(BENCH, folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"h100_bench.{folder}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str):
    cell = load_json("workloads", name + ".json")
    cell["name"] = name
    return (cell, load_json("configs", cell["config"] + ".json"),
            load_json("traffic", cell["traffic"] + ".json"))


def benchmark_metrics():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    return b["end_to_end"], b["per_layer"]


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules():
    return sorted(m for m in sys.modules
                  if m.split(".", 1)[0] in FORBIDDEN)


def per_layer_values(run: dict, per_layer, cell: str) -> dict:
    out = {}
    for m in per_layer:
        if not applies(m, cell):
            continue
        value = load_module("layer_metrics", m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def host_notes() -> dict:
    """What the host ran at: the CPUs this process may use, the mean
    clock ``/proc/cpuinfo`` reports, the load average."""
    notes = {"cpus": len(os.sched_getaffinity(0))}
    try:
        with open("/proc/cpuinfo") as f:
            mhz = [float(l.split(":")[1]) for l in f
                   if l.startswith("cpu MHz")]
        if mhz:
            notes["cpu_mhz_mean"] = round(sum(mhz) / len(mhz), 1)
        with open("/proc/loadavg") as f:
            notes["loadavg"] = f.read().split()[0]
    except (OSError, ValueError, IndexError):
        pass
    return notes


def check_lines(run: dict):
    """(correct, {number: {value, limit}})."""
    check = {k: {"value": run["check"].get(k, float("inf")), "limit": lim}
             for k, lim in run["limits"].items()}
    ok = bool(check) and all(c["value"] <= c["limit"]
                             for c in check.values())
    return ok and not run["failed"], check


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell, config, traffic = load_cell(args.workload)
    end_to_end, per_layer = benchmark_metrics()

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"run: needs {cell['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    driver = load_module("drivers", traffic["driver"])
    before = host_notes()
    run = driver.run(cell=cell, config=config, traffic=traffic,
                     seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), t0=T0, device="cuda")
    bad = forbidden_modules()
    if bad:
        print(f"run: loaded {', '.join(bad)} (the port may not load JAX "
              "or the JAX package)", file=sys.stderr)
        return 3
    correct, check = check_lines(run)
    if args.trace:
        metrics = per_layer_values(run, per_layer, cell["name"])
    else:
        metrics = {m["name"]: {"value": run["metrics"][m["name"]],
                               "unit": m["unit"]}
                   for m in end_to_end if applies(m, cell["name"])}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": run["memory_peak_bytes"]}
    line = {"correct": correct, "attempted": run["attempted"],
            "failed": run["failed"], "metrics": metrics, "device": device}
    if args.trace:
        from h100_bench.trace import breakdown
        device["busy_s"] = run["trace"]["busy_s"]
        device["window_s"] = run["trace"]["window_s"]
        line["breakdown"] = breakdown(run["trace"])
    notes = dict(run.get("notes", {}))
    notes.update({f"host_{k}_before": v for k, v in before.items()})
    notes.update({f"host_{k}_after": v for k, v in host_notes().items()})
    for k, v in notes.items():
        print(f"note {k}: {v}", file=sys.stderr)
    for k, c in check.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"check correct: {correct}", file=sys.stderr, flush=True)
    line["check"] = check
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
