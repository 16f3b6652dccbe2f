"""The Whitted tree loop's K3 expansion as it ran before K3 wrote its
children into the next level's ray streams, kept as the reference the
tests hold the new expansion to, bit for bit.  Each level flattened its
node-major (R, n, ...) node arrays (``flat``), packed them into K3's (11,
n*R) streams (``ray_streams``, inside ``CW.fused_level``), unpacked the
29-row output into the level's dict and interleaved the children per node
(``torch.stack``).  No JAX import: the card tests use it too."""

import torch

from distributionraytracer_tpu_torch.integrator.whitted import (
    _miss_color, _tree_shape,
)
from distributionraytracer_tpu_torch.ops import cuda_intersect as CI
from distributionraytracer_tpu_torch.ops import cuda_whitted as CW
from distributionraytracer_tpu_torch.ops.common import clamp_color


def _flat(a, R):
    n = a.shape[1]
    return a.transpose(0, 1).reshape((R * n,) + a.shape[2:])


def _unflat(a, R):
    n = a.shape[0] // R
    return a.reshape((n, R) + a.shape[1:]).transpose(0, 1)


def _children(cur, kinds, R):
    """The next level's node arrays (o, d, t, ior, ls, valid), (R, b*n,
    ...), from a level's node-major dict."""
    b = len(kinds)

    def interleave(arrs):
        if len(arrs) == 1:
            return arrs[0]
        stacked = torch.stack(arrs, dim=2)  # (R, n, b, ...)
        return stacked.reshape((R, b * arrs[0].shape[1]) + arrs[0].shape[2:])

    o = interleave([cur[k + "_o"] for k in kinds])
    return (o, interleave([cur[k + "_d"] for k in kinds]),
            torch.zeros(o.shape[:2], dtype=torch.float32, device=o.device),
            interleave([cur[k + "_ior"] for k in kinds]),
            interleave([cur["child_ls"]] * b),
            interleave([cur[k + "_valid"] for k in kinds]))


def old_next_streams(res, kinds, R):
    """The (11, b*n*R) streams the old chain fed the next level's K3, from
    one level's ``fused_level`` dict (n*R node-major lanes)."""
    cur = {k: _unflat(v, R) for k, v in res.items()}
    o, d, t, ior, ls, valid = (_flat(a, R) for a in _children(cur, kinds, R))
    return CI.ray_streams(o.shape[0], o[:, 0], o[:, 1], o[:, 2], d[:, 0],
                          d[:, 1], d[:, 2], t, ior, ls[:, 0], ls[:, 1],
                          valid.to(torch.float32))


def old_trace_k3(scene, cfg, o, d, time, light_sample, tables,
                 fused_grid=None):
    """``trace_whitted``'s K3 route with the old expansion: the (R, 3)
    colours (no ray counts)."""
    fused = CW.fused_level
    if fused_grid is not None and cfg.kernels == "off":
        fused = CW.fused_level_plain
    kinds, levels = _tree_shape(scene, cfg)
    R, dev = o.shape[0], o.device
    node = (o[:, None, :], d[:, None, :], time[:, None],
            torch.ones((R, 1), dtype=torch.float32, device=dev),
            light_sample[:, None, :],
            torch.ones((R, 1), dtype=torch.bool, device=dev))
    lvl = []
    for level in range(levels):
        spawn = level < levels - 1
        args = [_flat(a, R) for a in node]
        res = fused(scene, cfg, *args, spawn=spawn, tables=tables,
                    grid_bbox=fused_grid)
        res.pop("_hit")
        res["miss_color"] = _miss_color(scene, args[1])
        cur = {k: _unflat(v, R) for k, v in res.items()}
        if spawn:
            node = _children(cur, kinds, R)
        lvl.append(cur)
    b, child = len(kinds), None
    for cur in reversed(lvl):
        if child is None:
            color = cur["direct"]
        else:
            acc = cur["direct"]
            for ci, k in enumerate(kinds):
                acc = acc + clamp_color(child[:, ci::b]) * cur[k + "_weight"]
            color = clamp_color(acc)
        color = torch.where(cur["miss"][..., None], cur["miss_color"], color)
        child = torch.where(cur["valid"][..., None], color,
                            torch.zeros((), dtype=color.dtype, device=dev))
    return child[:, 0]
