"""Each cell's control comes out not correct on the chip, at the cell's
own size, on three seeds: the plain reference a precision step below the
configuration's (float8 conv operands for the bf16 FAST path), put in
the program's place and judged by the cell's own numbers and limits.

    python -m pytest -p no:cacheprovider -q h100_bench/test_bench_control.py

needs a CUDA device; the benchmark's own runs never run it.
"""

import json
import os

import pytest

from h100_bench import control

HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(os.path.dirname(HERE), "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct(cell, seed):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's "
                    "own size")
    got = control.readings(cell, seed)
    print(json.dumps(got))
    assert got["correct"] is False
