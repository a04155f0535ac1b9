"""Training-side parameter handling (only ``activate`` is ported so far)."""

from __future__ import annotations

import torch


def activate(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Raw (trainable) params -> render params (sigmoid on opacities)."""
    out = dict(params)
    out["opacities"] = torch.sigmoid(out.pop("opacities_raw"))
    return out
