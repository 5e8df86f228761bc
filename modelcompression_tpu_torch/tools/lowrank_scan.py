"""Per-layer spectral scan for low-rank factorization (`prune --mode
lowrank`, compress/lowrank.py): for each conv, print the singular-value
energy profile: the rank needed to keep each --energies point, the
break-even rank (above which factoring is SLOWER), and the resulting
FLOPs/params ratios. Host-side numpy (one SVD per conv, no device work):
run it BEFORE choosing --energy / --rank the same way the sensitivity
scan is run before choosing --fractions.

Random/fresh-init weights have near-flat spectra (nothing factors:
that's the FLOPs guard working); run this on TRAINED weights.

Usage:
  python -m modelcompression_tpu_torch.tools.lowrank_scan --cfg net.cfg \\
      --weights w.weights [--energies 0.8,0.9,0.95,0.99]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cfg", required=True)
    p.add_argument("--weights", required=True)
    p.add_argument("--energies", default="0.8,0.9,0.95,0.99")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; the SVDs run on the host "
                        "either way, a missing card is an error as in "
                        "every command line")
    args = p.parse_args(argv)

    from modelcompression_tpu_torch.compress.lowrank import (
        breakeven_rank, rank_for_energy,
    )
    from modelcompression_tpu_torch.core.device import resolve_device
    from modelcompression_tpu_torch.models import (
        ConvLayer, conv_key, load_cfg, load_weights,
    )
    from modelcompression_tpu_torch.models.summary import layer_shapes

    resolve_device(args.device)
    energies = [float(x) for x in args.energies.split(",") if x]
    for e in energies:
        if not 0.0 < e <= 1.0:
            print(f"error: energy {e} out of (0, 1]", file=sys.stderr)
            return 2
    spec = load_cfg(args.cfg)
    params, _ = load_weights(args.weights, spec)

    hdr = " ".join(f"r@{e:g}" for e in energies)
    print(f"{'conv':>5} {'shape':>18} {'full':>5} {'brkev':>6} {hdr}  "
          f"cost@ each energy")
    shapes = layer_shapes(spec)  # the forward's exact spatial walk
    tot = {e: 0.0 for e in energies}
    tot_orig = 0.0
    for idx, layer in enumerate(spec.layers):
        if not isinstance(layer, ConvLayer):
            continue
        # the HWIO view (kh*kw*ci, co), the JAX package's row order
        w = params[conv_key(idx)]["w"].permute(2, 3, 1, 0).numpy()
        s = np.linalg.svd(
            w.astype(np.float64).reshape(-1, w.shape[-1]),
            compute_uv=False)
        be = breakeven_rank(layer)
        kkci = layer.size * layer.size * layer.in_channels
        # FLOPs-weight each layer by its OUTPUT AREA: early convs run at
        # 208²+ while late ones run at 13², so a params-weighted total
        # would misstate the network cost ratio by orders of magnitude
        out_h, out_w, _ = shapes[idx]
        orig_cost = kkci * layer.filters * out_h * out_w
        tot_orig += orig_cost
        rs, costs = [], []
        for e in energies:
            r = rank_for_energy(s, e)
            rs.append(r)
            ratio = min(1.0, r / be)  # guard keeps the layer unfactored
            costs.append(ratio)
            tot[e] += orig_cost * ratio
        shape = f"{layer.size}x{layer.size}x{layer.in_channels}" \
                f"->{layer.filters}"
        print(f"{idx:>5} {shape:>18} {s.size:>5} {be:>6.0f} "
              + " ".join(f"{r:>5}" for r in rs) + "  "
              + " ".join(f"{c:.2f}" for c in costs))
    print("\nnetwork conv-cost ratio if factored at each energy "
          "(1.00 = unfactored; guard applied per layer):")
    print("  " + "  ".join(f"E={e:g}: {tot[e] / tot_orig:.3f}"
                           for e in energies))
    return 0


if __name__ == "__main__":
    sys.exit(main())
