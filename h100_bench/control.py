"""Read a cell's control: the plain reference computed a precision step
below the configuration's, put in the program's place and judged by the
cell's own numbers, at the cell's own size.

    python3 h100_bench/control.py --workload <cell> --seeds 1,2,3

Prints one JSON line a seed: the numbers, the cell's limits, and whether
the control came out correct (it must not). Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))

from h100_bench import run as harness  # noqa: E402


def readings(workload: str, seed: int, device: str = "cuda") -> dict:
    cell, config, traffic = harness.load_cell(workload)
    driver = harness.load_module("drivers", traffic["driver"])
    numbers = driver.control(cell, config, traffic, seed, device)
    limits = cell["check"]
    correct = all(numbers.get(k, float("inf")) <= lim
                  for k, lim in limits.items())
    return {"workload": workload, "seed": seed, "numbers": numbers,
            "limits": limits, "correct": correct}


def main() -> int:
    import argparse
    import torch
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
