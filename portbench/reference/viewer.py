"""The reference of a progressive viewer's accumulator."""

from __future__ import annotations

import torch

from portbench import samples
from portbench.reference import whitted as ref


def accumulator(rs, cam, vseed, first, k, H, W, max_depth):
    """(H, W, 3) float32 running mean of the reference's frames ``first``
    to ``k`` of the window at camera ``cam``: frame ``j`` draws its pixel
    jitter first from the viewer's generator ``(vseed << 32) + j + 1``."""
    dev = rs.device
    s = rs.with_eye(samples.viewer_eye(*cam))
    mean = None
    for j in range(first, k + 1):
        gen = torch.Generator(device=dev).manual_seed((vseed << 32) + j + 1)
        pixel = torch.rand((H, W, 1, 2), generator=gen, device=dev)
        with torch.no_grad():
            img = ref.render(s, pixel, max_depth).float()
        mean = img if mean is None else mean + (img - mean) / (j - first + 1)
    return mean.cpu().numpy()
