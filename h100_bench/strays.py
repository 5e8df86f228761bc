"""Read a cell's strays on the card: how far rounding moves the port's
candidates and head maps from the plain reference's, the readings its
``match_band`` and limits are set from, beside the control's.

    python3 h100_bench/strays.py --workload <cell> --seeds 1,2,3 \
        [--batches 4] [--bands 0.07:0.1:0.05,0.01:0.01:0.05]

For each seed: the cell's weights, pool and draws as
``drivers/stream_heads`` makes them (the draws of ``seed + 2``);
``--batches`` batches through the port's serving step (built with
``raw_maps``) and through the reference in fp32, in plain bf16 and in
float8 (the control). Prints one JSON line a seed, each
number the worst over the seed's images:

* ``strays``: the port's candidates (its decode of its own maps) against
  the reference's: ``score_log``, |ln port - ln reference| of a score
  where the reference's is above ``conf``; ``pair_log``, over a class's
  64 best candidates by the reference, the most two of them move apart
  in log score; ``corner``, a box corner's move over the candidate's
  longer side (network pixels), on those 64; ``iou``, an IoU's move
  between two of those 64. ``control_strays``: the same for the control;
* ``post_strays``: the same four for the port's decode against the
  reference's decode of the port's own maps (the post-process alone);
* ``head_gap``: ``drivers/stream_heads.head_gap`` of the port's maps and
  of the control's, and (``*_of_spread``) their rms distance from the
  fp32 maps over the fp32 maps' deviation;
* ``post``: under each band (``score:iou:match``; the cell's own first)
  the parts of ``detect.compare`` of the served detections against the
  reference's decode and NMS of the step's own maps, and the most
  candidates of an image and class the band lets reach the top
  ``max_detections`` (the comparison's memory grows with its square).

Needs a CUDA device.
"""

from __future__ import annotations

import json
import os
import sys

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))

import torch  # noqa: E402

from h100_bench import inputs, run as harness  # noqa: E402
from h100_bench.drivers import stream_heads  # noqa: E402
from h100_bench.reference import (  # noqa: E402
    cfg as refcfg, detect, model, prune,
)

TOP = 64


def _port_candidates(spec, maps_nhwc):
    """The port's decode of its maps: corner boxes, class scores."""
    from modelcompression_tpu_torch.evaluation import (
        center_to_corners, decode_heads,
    )
    boxes, obj, cls = decode_heads(tuple(maps_nhwc), spec)
    return center_to_corners(boxes).float(), (obj[..., None] * cls).float()


def strays(norm_p, scores_p, ref, conf, net_hw):
    """The four strays (module docstring) of one batch's candidates
    against ``ref``'s (``detect.serve``'s output)."""
    tiny = 1e-30
    rs = ref["scores"]
    d = scores_p.clamp_min(tiny).log() - rs.clamp_min(tiny).log()
    out = {"score_log": float(d.abs().masked_fill(rs <= conf, 0).amax())}
    top = torch.topk(rs.transpose(1, 2), TOP, dim=-1).indices  # (B, C, T)
    dt = torch.gather(d.transpose(1, 2), 2, top)
    out["pair_log"] = float((dt.amax(-1) - dt.amin(-1)).amax())
    c = top.shape[1]

    def pick(t):
        return torch.gather(t[:, None].expand(-1, c, -1, -1), 2,
                            top[..., None].expand(-1, -1, -1, 4))
    rb, pb = pick(ref["norm"]), pick(norm_p)
    scale = torch.tensor([net_hw[1], net_hw[0]] * 2, device=rb.device)
    rpx, ppx = rb * scale, pb * scale
    side = torch.maximum(rpx[..., 2] - rpx[..., 0],
                         rpx[..., 3] - rpx[..., 1]).clamp_min(1e-6)
    out["corner"] = float(((ppx - rpx).abs().amax(-1) / side).amax())
    out["iou"] = float((detect._iou(pb, pb) - detect._iou(rb, rb))
                       .abs().amax())
    return out


def _of_spread(maps, ref_maps):
    """Worst over heads of rms(maps - reference) / std(reference)."""
    return max(float((m - r).square().mean().sqrt() / r.std())
               for m, r in zip(maps, ref_maps))


def _fold_max(into, new):
    for k, v in new.items():
        into[k] = max(into.get(k, 0.0), v)


def readings(workload: str, seed: int, batches: int, bands,
             device: str = "cuda") -> dict:
    cell, config, traffic = harness.load_cell(workload)
    path = inputs.cfg_path(config)
    net, layers = refcfg.read(path)
    batch, src_hw = traffic["batch"], (traffic["src_h"], traffic["src_w"])
    net_hw = (int(net["height"]), int(net["width"]))
    pool = inputs.frame_pool(traffic["pool"], *src_hw, seed, device)
    raw = stream_heads.seeded_params(net, layers, seed, device, pool)
    spec, params, step = stream_heads.serving_step(cell, path, raw, src_hw,
                                                   device)
    # the reference in strict fp32 throughout; the port's FAST convs take
    # bf16 operands, which TF32 does not touch
    model.strict_fp32()
    ref_layers, ref_p = prune.apply_recipe(raw, net, layers,
                                           cell.get("recipe"))
    folded = model.fold(ref_p, ref_layers)
    serving = cell["serving"]
    draws = inputs.batch_draws(seed + 2, traffic["pool"], batch)
    img_w = torch.full((batch,), float(src_hw[1]))
    img_h = torch.full((batch,), float(src_hw[0]))
    out = {"strays": {}, "control_strays": {}, "post_strays": {},
           "head_gap": {}, "post": {b: {} for b in bands}}
    for _ in range(batches):
        frames = torch.as_tensor(pool[next(draws)], device=device)
        with torch.inference_mode():
            outs = step(params, frames, img_w, img_h)
            norm_p, scores_p = _port_candidates(spec, outs[5:])
        served = [t.float() for t in outs[:3]]
        maps = [m.float().permute(0, 3, 1, 2) for m in outs[5:]]
        ref_maps, bf16_maps, low_maps = (
            stream_heads.reference_maps(folded, net, ref_layers, frames, lp)
            for lp in (None, "bf16", "fp8"))
        ref, low, post_ref = (
            stream_heads.maps_served(m, ref_layers, net, src_hw, serving)
            for m in (ref_maps, low_maps, maps))
        _fold_max(out["strays"], strays(norm_p, scores_p, ref,
                                        serving["conf"], net_hw))
        _fold_max(out["control_strays"], strays(
            low["norm"], low["scores"], ref, serving["conf"], net_hw))
        _fold_max(out["post_strays"], strays(norm_p, scores_p, post_ref,
                                             serving["conf"], net_hw))
        _fold_max(out["head_gap"], {
            "port": stream_heads.head_gap(maps, ref_maps, bf16_maps),
            "control": stream_heads.head_gap(low_maps, ref_maps, bf16_maps),
            "port_of_spread": _of_spread(maps, ref_maps),
            "control_of_spread": _of_spread(low_maps, ref_maps)})
        for b in bands:
            band = dict(zip(("score", "iou", "match"), b))
            q = int(detect.bands(post_ref["norm"], post_ref["scores"],
                                 serving, band)[0].shape[-1])
            _fold_max(out["post"][b], {"candidates": q, **detect.compare(
                served, post_ref, serving, band)})
    key = lambda b: ":".join(f"{v:g}" for v in b)  # noqa: E731
    out["post"] = {key(b): v for b, v in out["post"].items()}
    return {"workload": workload, "seed": seed, "images": batches * batch,
            **out}


def main() -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--batches", type=int, default=4)
    p.add_argument("--bands", default="")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("strays: needs a CUDA device", file=sys.stderr)
        return 2
    own = harness.load_cell(args.workload)[0]["match_band"]
    bands = [(own["score"], own["iou"], own["match"])]
    for b in filter(None, args.bands.split(",")):
        bands.append(tuple(float(v) for v in b.split(":")))
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), args.batches,
                                  bands)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
