"""The luma downsample on padded pixel planes, eager torch: the colour
path for sampling factors above 2 (4:1:1, 4x2), counterpart of
``jpegqs_tpu.ops.plane.downsample_plane``.

The padded plane (+1 px replicated border) is the reference's scratch
image (quantsmooth.h:2544-2567, border fill 2612-2620).  Integer math
throughout: order-free and exact.
"""

from __future__ import annotations

import torch

I32 = torch.int32


def downsample_plane(padded_luma, hb_l, wb_l, hb_c, wb_c, ws, hs):
    """Box-downsample the padded luma plane to chroma size for JOINT_YUV
    (reference: quantsmooth.h:2753-2813).  Returns the padded (+1 px)
    chroma-size plane int32[hb_c*8+2, wb_c*8+2]."""
    H, W = hb_l * 8, wb_l * 8
    interior = padded_luma[1:H + 1, 1:W + 1].to(I32)
    w1 = (W + ws - 1) // ws
    h1 = (H + hs - 1) // hs
    wc, hc = wb_c * 8, hb_c * 8
    dev = interior.device
    if ws == 2 and hs == 2:
        # fast path (quantsmooth.h:2778-2785): (a + 2) >> 2
        ds = (interior[0:h1 * 2:2, 0:w1 * 2:2]
              + interior[0:h1 * 2:2, 1:w1 * 2:2]
              + interior[1:h1 * 2:2, 0:w1 * 2:2]
              + interior[1:h1 * 2:2, 1:w1 * 2:2] + 2) >> 2
    else:
        # zero-pad to a multiple of the factor, box-sum, divide by the
        # cell's true pixel count (quantsmooth.h:2790-2800:
        # (sum + div/2) / div)
        z = torch.zeros((h1 * hs, w1 * ws), dtype=I32, device=dev)
        z[:H, :W] = interior
        s = z.reshape(h1, hs, w1, ws).sum(dim=(1, 3)).to(I32)
        cnt_y = torch.clamp_max(H - torch.arange(h1, device=dev) * hs, hs)
        cnt_x = torch.clamp_max(W - torch.arange(w1, device=dev) * ws, ws)
        div = (cnt_y[:, None] * cnt_x[None, :]).to(I32)
        ds = torch.div(s + div // 2, div, rounding_mode="floor")
    out = torch.zeros((hc + 2, wc + 2), dtype=I32, device=dev)
    out[1:h1 + 1, 1:w1 + 1] = ds
    # replicate (quantsmooth.h:2805-2813): left col, right cols from
    # col w1, then top row, bottom rows from row h1
    out[1:h1 + 1, 0] = out[1:h1 + 1, 1].clone()
    out[1:h1 + 1, w1 + 1:] = out[1:h1 + 1, w1:w1 + 1].clone()
    out[0, :] = out[1, :].clone()
    out[h1 + 1:, :] = out[h1, :][None, :].clone()
    return out
