"""The bf16 input-stage kernel's (``ops/input_stage``,
``csrc/input_stage_mma.cu``) share of its roofline bound, in %: the bound
from the batch's shapes (``reference.arith.input_stage_bound_s``) over
the kernel's mean device time a launch in the traced window. Nothing to
read where the kernel never launches (a conv1 that feeds no 2x2 pool)."""

from h100_bench.reference.arith import input_stage_bound_s
from h100_bench.trace import op_time

KERNEL = "conv1_pool_mma"


def read(run):
    if run["driver"] != "stream" or not run.get("trace"):
        return None
    seconds, launches = op_time(run["trace"], KERNEL)
    if not launches:
        return None
    s = run["shapes"]
    bound = input_stage_bound_s(s["batch"], s["net_h"], s["net_w"],
                                s["conv1_filters"])
    return 100.0 * bound / (seconds / launches)
