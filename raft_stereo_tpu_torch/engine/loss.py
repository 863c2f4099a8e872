"""Sequence loss over the refinement iterations' predictions.

The JAX package's ``engine/loss.py`` (reference ``train_stereo.py:35-69``):
an exponentially weighted L1 over the iterations with the weight exponent
adjusted for the iteration count, ``gamma ** (15 / (N - 1))``, a validity
mask that also drops ground truth at or beyond ``max_flow`` (700 px), and
the metrics (EPE, 1/3/5 px) of the last prediction. ``finite`` is 0 when the
loss or any prediction is NaN or infinite (the reference asserts; the train
loop reads it instead).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(x * mask) / torch.clamp(torch.sum(mask), min=1.0)


def sequence_loss(flow_preds: torch.Tensor, flow_gt: torch.Tensor, valid: torch.Tensor,
                  loss_gamma: float = 0.9, max_flow: float = 700.0, grid=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """flow_preds: (N, B, H, W, 1); flow_gt: (B, H, W, 1) (negative
    disparity); valid: (B, H, W) or (B, H, W, 1). Returns ``(loss,
    metrics)``, all 0-d fp32 tensors on the predictions' device.

    With ``grid`` (a ``parallel.ProcessGrid``) the three are this rank's
    part of the global batch (its rows of the batch and, under a space
    axis, of the height). The loss and the metrics are then the global
    batch's: the ranks' partial sums and counts are summed over the grid in
    one all-reduce (a mean of the ranks' means would be wrong wherever the
    ranks hold different numbers of valid pixels). ``loss`` is this rank's
    share, its partial sum over the global count, so that the shares' sum
    is the global loss and the sum of their gradients its gradient;
    ``metrics["loss"]`` is the global loss."""
    n = flow_preds.shape[0]
    if valid.ndim == 4:
        valid = valid[..., 0]
    flow_preds = flow_preds.float()
    flow_gt = flow_gt.float()
    mag = torch.abs(flow_gt[..., 0])
    mask = ((valid >= 0.5) & (mag < max_flow)).float()[..., None]
    gamma = loss_gamma ** (15.0 / max(n - 1, 1))
    weights = gamma ** torch.arange(n - 1, -1, -1, dtype=torch.float32,
                                    device=flow_preds.device)
    abs_err = torch.abs(flow_preds - flow_gt[None])
    per_iter = torch.sum(abs_err * mask[None], dim=(1, 2, 3, 4))
    epe = torch.abs(flow_preds[-1][..., 0] - flow_gt[..., 0])
    m = mask[..., 0]
    if grid is None:
        loss = torch.sum(weights * per_iter / torch.clamp(torch.sum(mask), min=1.0))
        metrics = {
            "epe": _masked_mean(epe, m),
            "1px": _masked_mean((epe < 1.0).float(), m),
            "3px": _masked_mean((epe < 3.0).float(), m),
            "5px": _masked_mean((epe < 5.0).float(), m),
            "finite": (torch.isfinite(loss) & torch.all(torch.isfinite(flow_preds))).float(),
        }
        return loss, {k: v.detach() for k, v in metrics.items()}
    weighted = torch.sum(weights * per_iter)
    finite = (torch.isfinite(weighted) & torch.all(torch.isfinite(flow_preds))).float()
    sums = torch.stack([torch.sum(m), weighted.detach(), torch.sum(epe * m),
                        torch.sum((epe < 1.0).float() * m), torch.sum((epe < 3.0).float() * m),
                        torch.sum((epe < 5.0).float() * m), 1.0 - finite]).detach()
    grid.all_reduce_sum_(sums)
    count = torch.clamp(sums[0], min=1.0)
    loss = weighted / count
    total = sums[1] / count
    metrics = {"epe": sums[2] / count, "1px": sums[3] / count, "3px": sums[4] / count,
               "5px": sums[5] / count,
               "finite": ((sums[6] == 0) & torch.isfinite(total)).float(), "loss": total}
    return loss, metrics
