"""A plain Darknet cfg reader for the reference side of the benchmark.

Reads the sections and keys that YOLOv2 and YOLOv4 use, resolves relative
layer indices, and walks channels and spatial sizes. Layers are plain
dicts with a ``type`` key; the network's ``[net]`` keys are a dict of
strings. Written from Darknet's cfg semantics (``parser.c``):

* ``[convolutional]`` pads ``size // 2`` when ``pad=1``;
* ``[maxpool]`` pads ``padding`` (default ``size - 1``) in total, its
  window origin ``padding // 2`` before the first row and column;
* ``[route]`` concatenates earlier outputs (``groups`` / ``group_id``
  slice each source);
* ``[shortcut]`` adds an earlier output; ``[upsample]`` repeats pixels;
  ``[reorg]`` is a space-to-depth.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def _sections(text: str) -> List[Tuple[str, Dict[str, str]]]:
    out: List[Tuple[str, Dict[str, str]]] = []
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if line.startswith("["):
            out.append((line.strip("[]").strip(), {}))
            continue
        key, value = line.split("=", 1)
        out[-1][1][key.strip()] = value.strip()
    return out


def _ints(s: str) -> List[int]:
    return [int(v) for v in s.split(",") if v.strip()]


def _floats(s: str) -> List[float]:
    return [float(v) for v in s.split(",") if v.strip()]


def parse(text: str) -> Tuple[Dict[str, str], List[dict]]:
    """(net keys, layers). Every layer dict carries ``in_c``, ``out_c``,
    ``out_h`` and ``out_w`` after the shape walk."""
    sections = _sections(text)
    net = sections[0][1]
    layers: List[dict] = []
    for name, o in sections[1:]:
        idx = len(layers)
        if name == "convolutional":
            size = int(o.get("size", 1))
            layers.append(dict(
                type="conv", filters=int(o["filters"]), size=size,
                stride=int(o.get("stride", 1)),
                pad=size // 2 if int(o.get("pad", 0)) else 0,
                bn=bool(int(o.get("batch_normalize", 0))),
                act=o.get("activation", "logistic")))
        elif name == "maxpool":
            size = int(o.get("size", 2))
            layers.append(dict(type="maxpool", size=size,
                               stride=int(o.get("stride", 2)),
                               pad_total=int(o.get("padding", size - 1))))
        elif name == "route":
            srcs = [a if a >= 0 else idx + a for a in _ints(o["layers"])]
            layers.append(dict(type="route", layers=srcs,
                               groups=int(o.get("groups", 1)),
                               group_id=int(o.get("group_id", 0))))
        elif name == "reorg":
            layers.append(dict(type="reorg", stride=int(o.get("stride", 2))))
        elif name == "shortcut":
            a = int(o["from"])
            layers.append(dict(type="shortcut",
                               src=a if a >= 0 else idx + a,
                               act=o.get("activation", "linear")))
        elif name == "upsample":
            layers.append(dict(type="upsample",
                               stride=int(o.get("stride", 2))))
        elif name == "yolo":
            mask = _ints(o["mask"])
            anchors = _floats(o["anchors"])
            pairs = [(anchors[2 * m], anchors[2 * m + 1]) for m in mask]
            layers.append(dict(type="yolo", anchors=pairs,
                               classes=int(o.get("classes", 80)),
                               scale_x_y=float(o.get("scale_x_y", 1.0))))
        elif name == "region":
            anchors = _floats(o["anchors"])
            pairs = [(anchors[2 * k], anchors[2 * k + 1])
                     for k in range(len(anchors) // 2)]
            layers.append(dict(
                type="region", anchors=pairs,
                classes=int(o.get("classes", 20)),
                thresh=float(o.get("thresh", 0.6)),
                object_scale=float(o.get("object_scale", 5)),
                noobject_scale=float(o.get("noobject_scale", 1)),
                class_scale=float(o.get("class_scale", 1)),
                coord_scale=float(o.get("coord_scale", 1)),
                rescore=bool(int(o.get("rescore", 0))),
                bias_match=bool(int(o.get("bias_match", 0))),
                softmax=bool(int(o.get("softmax", 1))),
                jitter=float(o.get("jitter", 0.3))))
        else:
            raise ValueError(f"reference cfg reader: no [{name}] support")
    _walk(net, layers)
    return net, layers


def _walk(net: Dict[str, str], layers: List[dict]) -> None:
    h, w = int(net["height"]), int(net["width"])
    c = int(net.get("channels", 3))
    for l in layers:
        t = l["type"]
        l["in_c"] = c
        if t == "conv":
            h = (h + 2 * l["pad"] - l["size"]) // l["stride"] + 1
            w = (w + 2 * l["pad"] - l["size"]) // l["stride"] + 1
            c = l["filters"]
        elif t == "maxpool":
            h = (h + l["pad_total"] - l["size"]) // l["stride"] + 1
            w = (w + l["pad_total"] - l["size"]) // l["stride"] + 1
        elif t == "route":
            h, w = layers[l["layers"][0]]["out_h"], \
                layers[l["layers"][0]]["out_w"]
            c = sum(layers[a]["out_c"] // l["groups"] for a in l["layers"])
        elif t == "reorg":
            h, w, c = h // l["stride"], w // l["stride"], \
                c * l["stride"] ** 2
        elif t == "upsample":
            h, w = h * l["stride"], w * l["stride"]
        l["out_h"], l["out_w"], l["out_c"] = h, w, c


def read(path: str) -> Tuple[Dict[str, str], List[dict]]:
    with open(path) as f:
        return parse(f.read())


def with_filters(net: Dict[str, str], layers: List[dict],
                 filters: Dict[int, int]) -> List[dict]:
    """A copy of ``layers`` with conv ``i`` narrowed to ``filters[i]``,
    shapes walked again."""
    out = [dict(l) for l in layers]
    for i, f in filters.items():
        out[i]["filters"] = int(f)
    _walk(net, out)
    return out


def conv_indices(layers: List[dict]) -> List[int]:
    return [i for i, l in enumerate(layers) if l["type"] == "conv"]


def head_indices(layers: List[dict]) -> List[int]:
    return [i for i, l in enumerate(layers)
            if l["type"] in ("yolo", "region")]
