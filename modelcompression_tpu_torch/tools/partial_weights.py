"""Darknet's ``partial`` command: extract the first N conv layers of a
``.weights`` file as a backbone-prefix file (the ``darknet19.conv.23``
convention) for transfer-learning initialization. The load side is the
``--partial`` flag every command line already has (models/weights_io.py).

Usage:
  python -m modelcompression_tpu_torch.tools.partial_weights \\
      --cfg yolov2-voc.cfg --weights yolov2-voc.weights --n-convs 23 \\
      [--out darknet19.conv.23]

The file is read and written through the port's codec on the host; the
output is byte-equal to the JAX package's tool on the same file.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cfg", required=True)
    p.add_argument("--weights", required=True)
    p.add_argument("--n-convs", type=int, required=True,
                   help="number of leading conv layers to keep")
    p.add_argument("--out", default=None,
                   help="default: <weights stem>.conv.<N>")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; the codec runs on the host "
                        "either way, a missing card is an error as in "
                        "every command line")
    args = p.parse_args(argv)

    from modelcompression_tpu_torch.core.device import resolve_device
    from modelcompression_tpu_torch.models import (
        load_cfg, load_weights, save_weights,
    )
    resolve_device(args.device)
    spec = load_cfg(args.cfg)
    n_total = len(spec.conv_indices())
    if not 0 < args.n_convs <= n_total:
        print(f"error: --n-convs must be in [1, {n_total}] for this cfg",
              file=sys.stderr)
        return 2
    params, _ = load_weights(args.weights, spec)
    out = args.out or (os.path.splitext(args.weights)[0]
                       + f".conv.{args.n_convs}")
    # seen resets to 0, matching darknet partial's output header
    save_weights(out, spec, params, seen=0, n_convs=args.n_convs)
    print(f"wrote {out}: first {args.n_convs}/{n_total} convs "
          f"({os.path.getsize(out) / 1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
