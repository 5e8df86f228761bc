"""Summary CLI, port of ``modelcompression_tpu/cli/summary.py``: print
the Darknet-style layer table for a .cfg, with per-conv params/FLOPs and,
when ``--weights`` is given, the per-layer nonzero fraction (the sparsity
audit view for masked, pre-repack checkpoints).

Runs entirely on host metadata: no device.

Example:
  python -m modelcompression_tpu_torch.cli.summary --cfg yolov2-voc.cfg
  python -m modelcompression_tpu_torch.cli.summary --cfg pruned.cfg \\
      --weights pruned.weights   # adds nonzero %
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="summary", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg", required=True, help="Darknet .cfg file")
    p.add_argument("--weights", default=None,
                   help="Darknet .weights file — adds per-conv nonzero "
                        "fraction (sparsity audit)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    # import inside main so --help stays instant (no torch import)
    from modelcompression_tpu_torch.models import load_cfg, load_weights
    from modelcompression_tpu_torch.models.summary import network_table
    spec = load_cfg(args.cfg)
    params = None
    if args.weights:
        params, seen = load_weights(args.weights, spec)
        print(f"weights: {args.weights} (seen={seen})")
    print(network_table(spec, params))
    return 0


if __name__ == "__main__":
    sys.exit(main())
