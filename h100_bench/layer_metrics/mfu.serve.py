"""The whole serving step's share of the H100's bf16 peak, in %: conv
FLOPs per image at the recipe's widths (``reference.arith``, from the
reference's own keep-sets) times the window's images per second, over
989 TFLOP/s."""

from h100_bench.reference.arith import PEAK_BF16_FLOPS


def read(run):
    if run["driver"] != "stream":
        return None
    return 100.0 * run["flops_per_img"] * run["rate"] / PEAK_BF16_FLOPS
