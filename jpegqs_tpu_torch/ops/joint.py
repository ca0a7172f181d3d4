"""The JOINT_YUV regression slope on padded planes, eager torch:
counterpart of ``jpegqs_tpu.ops.joint`` for the plane path (sampling
factors above 2).

Per pixel, a 3x3 (1, 2, 1)^2 weighted local linear regression of one
plane on the other (reference: quantsmooth.h:893-912).  The statistics
are exact int32; the slope is an IEEE fp32 divide, clamped to +-16.
"""

from __future__ import annotations

import torch

I32 = torch.int32

# 3x3 weights (reference: quantsmooth.h:896-905): corners 1, edges 2,
# centre 4; total weight 16
_W3 = ((1, 2, 1), (2, 4, 2), (1, 2, 1))


def conv3x3(padded):
    """Weighted 3x3 sums over the interior of a padded plane, int32."""
    H, W = padded.shape[0] - 2, padded.shape[1] - 2
    out = torch.zeros((H, W), dtype=I32, device=padded.device)
    for dy in range(3):
        for dx in range(3):
            out = out + _W3[dy][dx] * padded[dy:dy + H, dx:dx + W].to(I32)
    return out


def regression_scale(padded_a, padded_b):
    """Per-pixel regression slope of b on a, clamped to +-16, f32[H, W]
    (reference: quantsmooth.h:906-912)."""
    sum_a = conv3x3(padded_a)
    sum_b = conv3x3(padded_b)
    a, b = padded_a.to(I32), padded_b.to(I32)
    s_aa = conv3x3(a * a) * 16 - sum_a * sum_a
    s_ab = conv3x3(a * b) * 16 - sum_a * sum_b
    scale = torch.where(s_aa != 0,
                        s_ab.to(torch.float32) / s_aa.to(torch.float32), 0.0)
    return torch.clamp(scale, -16.0, 16.0)
