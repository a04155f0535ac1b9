"""Trainable parameters and what the renderer takes.

Raw (pre-activation) parameters are trained: opacities as logits
(``opacities_raw``), scales in log space, quaternions normalised inside the
projection. ``activate`` maps the raw leaves to the renderer's parameters;
``train`` and ``parallel`` both call it.
"""

from __future__ import annotations

from typing import Mapping

import torch


def activate(params: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """Raw (trainable) params -> render params (sigmoid on opacities)."""
    out = dict(params)
    out["opacities"] = torch.sigmoid(out.pop("opacities_raw"))
    return out
