"""Density control at fixed capacity: ADC (clone / split / prune) and MCMC.

Counterpart of ``mojosplat_tpu.densify``. The parameter tensors keep a
fixed capacity N; a slot is dead when its opacity logit is ``DEAD_LOGIT``
(sigmoid ~3e-7, culled by the alpha threshold in projection), so no shape
ever changes. Each function returns new tensors and leaves its inputs as
they were.

  - ADC (3DGS): ``accumulate_stats`` sums the norm of the view-space
    positional gradient per gaussian between events; ``densify_and_prune``
    prunes transparent gaussians and writes clones (small gaussians) or
    splits (large ones, the children sampled along the principal axis)
    of the hottest candidates into free slots.
  - MCMC (3DGS-MCMC): ``mcmc_relocate`` moves dead slots onto alive
    gaussians sampled by opacity, with ``relocation_update``'s
    appearance-preserving opacity and scale; ``mcmc_position_noise`` adds
    opacity-gated noise shaped by each gaussian's covariance;
    ``mcmc_regularization`` is the L1 opacity and scale term of the loss.

Random numbers come from an explicit ``torch.Generator`` through
``_normal`` and ``_categorical``, one helper per kind of draw. They differ
from the reference's ``jax.random`` draws; tests replace the helpers with
the reference's numbers to compare every output.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

DEAD_LOGIT = -15.0  # sigmoid(-15) ~ 3e-7, far below the 1/255 alpha cull


def _normal(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normal draws of ``shape`` (f32)."""
    return torch.randn(shape, generator=generator, device=device)


def _categorical(generator: torch.Generator, weights: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` indices drawn with replacement, in proportion to ``weights``
    (non-negative, at most 2^22 of them, not all zero).

    The weights are scaled to integers below 2^40, so their prefix sum is
    exact and each draw depends only on the generator: a float prefix sum
    on the card (``torch.cumsum``, and ``torch.multinomial`` through it)
    adds in no fixed order, and one ulp at a bin's edge moves a draw."""
    scaled = weights.double() / weights.max().double() * float(1 << 40)
    cdf = torch.cumsum(torch.round(scaled).to(torch.int64), 0)
    total = int(cdf[-1])
    if total <= 0:
        raise ValueError("_categorical: every weight is zero")
    u = torch.randint(0, total, (n,), generator=generator, device=weights.device)
    return torch.searchsorted(cdf, u, right=True)


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    grad_threshold: float = 2e-4  # mean view-space grad norm to densify
    percent_dense: float = 0.01  # small/large split point vs scene extent
    min_opacity: float = 0.005  # prune below this post-sigmoid opacity
    split_scale_factor: float = 1.6  # children scales = parent / this
    max_new_fraction: float = 0.25  # cap new gaussians per event


class DensifyState(NamedTuple):
    """Accumulated view-space gradient statistics between densify events."""

    grad_accum: torch.Tensor  # (N,) sum of ||d L / d means2d||
    count: torch.Tensor  # (N,) int32 accumulation steps seen

    @staticmethod
    def zero(n: int, device: torch.device | str = "cuda") -> "DensifyState":
        """Zero statistics for ``n`` slots, on the card unless ``device``
        says otherwise."""
        return DensifyState(
            grad_accum=torch.zeros((n,), dtype=torch.float32, device=device),
            count=torch.zeros((n,), dtype=torch.int32, device=device),
        )


def alive_mask(params) -> torch.Tensor:
    """(N,) bool: slots holding live gaussians."""
    return params["opacities_raw"] > DEAD_LOGIT + 1.0


def accumulate_stats(state: DensifyState, means2d_grad: torch.Tensor,
                     visible: torch.Tensor) -> DensifyState:
    """Add one step's view-space positional gradients (N, 2) for the
    gaussians ``visible`` (N,) bool this step (radii > 0)."""
    norms = torch.linalg.vector_norm(means2d_grad, dim=-1)
    return DensifyState(
        grad_accum=state.grad_accum + torch.where(visible, norms, torch.zeros_like(norms)),
        count=state.count + visible.to(torch.int32),
    )


def _quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(N, 4) unit wxyz quaternions -> (N, 3, 3) rotation matrices."""
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=1)


def _unit_quats(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-12)


@torch.no_grad()
def densify_and_prune(params, state: DensifyState, generator: torch.Generator,
                      scene_extent: float, config: DensifyConfig = DensifyConfig()):
    """One densification event at fixed capacity.

    Returns (new params of identical shapes, zeroed stats, metrics: 0-d
    tensors ``pruned``, ``cloned``, ``split``, ``alive``). Candidates are
    ranked by mean gradient (best first) and paired with the free slots in
    index order; at most ``max_new_fraction`` of N are written. A split
    parent becomes the first child in place.
    """
    raw = params["opacities_raw"]
    n = raw.shape[0]
    dev = raw.device
    alive = alive_mask(params)
    opac = torch.sigmoid(raw)

    # Prune: transparent gaussians release their slots.
    prune = alive & (opac < config.min_opacity)
    alive_after_prune = alive & ~prune

    # Candidates: high mean view-space gradient.
    mean_grad = state.grad_accum / torch.clamp(state.count, min=1)
    hot = alive_after_prune & (mean_grad > config.grad_threshold)
    max_scale = torch.exp(torch.amax(params["scales"], dim=-1))
    small = max_scale <= config.percent_dense * scene_extent
    clone_c = hot & small
    split_c = hot & ~small

    # Slot budget: the i-th best candidate goes to the i-th free slot.
    free = ~alive_after_prune
    n_free = free.sum(dtype=torch.int32)
    max_new = torch.clamp(n_free, max=int(config.max_new_fraction * n))
    cand = clone_c | split_c
    order = torch.argsort(torch.where(cand, -mean_grad, torch.full_like(mean_grad, math.inf)),
                          stable=True)
    rank_of = torch.empty((n,), dtype=torch.int32, device=dev)
    rank_of[order] = torch.arange(n, dtype=torch.int32, device=dev)
    n_cand = cand.sum(dtype=torch.int32)
    selected = cand & (rank_of < max_new)
    free_order = torch.argsort((~free).to(torch.int8), stable=True)  # free slots first
    n_new = torch.minimum(torch.minimum(n_cand, max_new), n_free)
    dest = free_order[rank_of.clamp(0, n - 1).to(torch.int64)]
    write = selected & (rank_of < n_new)

    # Child parameters: splits sample along the principal axis.
    R = _quat_to_rotmat(_unit_quats(params["quats"]))
    scales_lin = torch.exp(params["scales"])
    axis = torch.argmax(params["scales"], dim=-1)
    main_axis = R[torch.arange(n, device=dev), :, axis]  # column of R
    sigma = torch.amax(scales_lin, dim=-1, keepdim=True)
    offset = _normal(generator, (n, 1), dev) * sigma * main_axis

    split_rows = split_c[:, None]
    child_means = torch.where(split_rows, params["means3d"] + offset, params["means3d"])
    child_scales = torch.where(split_rows, params["scales"] - math.log(config.split_scale_factor),
                               params["scales"])
    dst = dest[write]

    def place(old, src):
        out = old.clone()
        out[dst] = src[write]
        return out

    new = dict(params)
    new["means3d"] = place(params["means3d"], child_means)
    new["scales"] = place(params["scales"], child_scales)
    new["quats"] = place(params["quats"], params["quats"])
    new["opacities_raw"] = place(raw, raw)
    new["features"] = place(params["features"], params["features"])

    # Split parents shrink in place (at fixed capacity the parent IS child one).
    shrink = (split_c & write)[:, None]
    new["means3d"] = torch.where(shrink, params["means3d"] - offset, new["means3d"])
    new["scales"] = torch.where(shrink, child_scales, new["scales"])
    # Pruned slots die.
    new["opacities_raw"] = torch.where(prune, torch.full_like(raw, DEAD_LOGIT),
                                       new["opacities_raw"])

    metrics = dict(
        pruned=prune.sum(),
        cloned=(write & clone_c).sum(),
        split=(write & split_c).sum(),
        alive=alive_mask(new).sum(),
    )
    return new, DensifyState.zero(n, dev), metrics


def pad_to_capacity(params, capacity: int):
    """Grow every parameter to ``capacity`` rows; the new slots are dead,
    with identity quaternions (a zero quaternion's normalisation has a NaN
    gradient, which would poison every later optimizer step)."""
    n = params["opacities_raw"].shape[0]
    if capacity < n:
        raise ValueError(f"capacity {capacity} < current N {n}")
    out = {}
    for k, v in params.items():
        padded = torch.zeros((capacity,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
        padded[:n] = v.detach()
        out[k] = padded
    out["opacities_raw"][n:] = DEAD_LOGIT
    out["quats"][n:, 0] = 1.0
    return out


@torch.no_grad()
def reset_opacities(params, max_opacity: float = 0.01):
    """Clamp every live opacity to at most ``max_opacity`` (INRIA training's
    periodic reset); dead slots stay dead."""
    logit = float(torch.log(torch.tensor(max_opacity / (1.0 - max_opacity))))
    raw = params["opacities_raw"]
    out = dict(params)
    out["opacities_raw"] = torch.where(raw > DEAD_LOGIT + 1.0, torch.clamp(raw, max=logit), raw)
    return out


# --- MCMC density control (3DGS-MCMC, Kheradmand et al. 2024) -------------

_MCMC_N_MAX = 51  # max copies per relocation target (binomial table bound)


def _binomial_table(n_max: int, device=None) -> torch.Tensor:
    """(n_max + 1, n_max + 1) f32 table of C(n, k), 0 where k > n."""
    tbl = [[math.comb(n, k) if k <= n else 0 for k in range(n_max + 1)]
           for n in range(n_max + 1)]
    return torch.tensor(tbl, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class MCMCConfig:
    min_opacity: float = 0.005  # below this a slot is dead / relocatable
    noise_lr: float = 5e5  # position-noise scale multiplier
    noise_opacity_k: float = 100.0  # steepness of the noise opacity gate
    opacity_reg: float = 0.01  # L1 opacity regularizer weight
    scale_reg: float = 0.01  # L1 (linear-)scale regularizer weight


def relocation_update(opacities: torch.Tensor, ratio: torch.Tensor):
    """New (opacity, linear-scale coefficient) when one splat becomes
    ``ratio`` coincident copies: o' = 1 - (1 - o)^(1/k) keeps the centre
    alpha exact, and coeff = o / sum_{i=1..k} C(k, i) (-1)^(i+1) o'^i /
    sqrt(i) keeps the blended profile's 1D mass."""
    ratio = torch.clamp(ratio.to(torch.int32), 1, _MCMC_N_MAX)
    o = opacities
    new_o = 1.0 - torch.pow(torch.clamp(1.0 - o, min=1e-12), 1.0 / ratio.to(o.dtype))
    i = torch.arange(1, _MCMC_N_MAX + 1, dtype=torch.float32, device=o.device)
    binom = _binomial_table(_MCMC_N_MAX, o.device)[ratio.to(torch.int64)]  # (N, I + 1)
    sign = torch.where(i.remainder(2) == 1, 1.0, -1.0)  # (-1)^(i + 1)
    terms = binom[:, 1:] * torch.pow(new_o[:, None], i[None, :]) * sign / torch.sqrt(i)
    mask = i[None, :] <= ratio[:, None].to(torch.float32)
    denom = torch.sum(torch.where(mask, terms, torch.zeros_like(terms)), dim=-1)
    coeff = o / torch.clamp(denom, min=1e-12)
    return new_o, coeff


@torch.no_grad()
def mcmc_relocate(params, generator: torch.Generator, config: MCMCConfig = MCMCConfig()):
    """Relocate dead slots onto alive gaussians sampled in proportion to
    opacity. The target and every copy that lands on it take the
    ``relocation_update``'d opacity and scales. Returns (new params,
    metrics: 0-d tensors ``relocated``, ``alive``); a strict no-op when no
    gaussian is alive."""
    raw = params["opacities_raw"]
    n = raw.shape[0]
    dev = raw.device
    opac = torch.sigmoid(raw)
    alive = opac >= config.min_opacity
    dead = ~alive
    if not bool(alive.any()):
        return dict(params), dict(relocated=dead.sum() * 0, alive=alive.sum())

    weights = torch.where(alive, torch.clamp(opac, min=1e-12), torch.zeros_like(opac))
    ids = torch.arange(n, device=dev)
    targets = torch.where(dead, _categorical(generator, weights, n), ids)

    # Copies per target: itself plus the dead slots pointing at it.
    counts = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
    counts.index_add_(0, torch.where(dead, targets, n), torch.ones_like(targets, dtype=torch.int32))
    counts = counts[:n] + 1
    new_o_t, coeff_t = relocation_update(opac[targets], counts[targets])

    touched = dead | (counts > 1)

    def sel(new, old):
        return torch.where(touched.reshape(touched.shape + (1,) * (new.ndim - 1)), new, old)

    out = dict(params)
    out["means3d"] = sel(params["means3d"][targets], params["means3d"])
    out["quats"] = sel(params["quats"][targets], params["quats"])
    out["features"] = sel(params["features"][targets], params["features"])
    out["scales"] = sel(params["scales"][targets]
                        + torch.log(torch.clamp(coeff_t, min=1e-12))[:, None], params["scales"])
    out["opacities_raw"] = sel(torch.logit(torch.clamp(new_o_t, 1e-9, 1.0 - 1e-9)), raw)
    return out, dict(relocated=dead.sum(), alive=alive.sum())


@torch.no_grad()
def mcmc_position_noise(params, generator: torch.Generator, lr: float,
                        config: MCMCConfig = MCMCConfig()):
    """means += lr * noise_lr * gate(o) * N(0, R S^2 R^T), with gate(o) =
    sigmoid(k (min_opacity - o)) suppressing noise on opaque gaussians.
    Surfels (two scales) get a ~zero third axis, so their noise stays in
    the disk plane."""
    raw = params["opacities_raw"]
    n = raw.shape[0]
    opac = torch.sigmoid(raw)
    gate = torch.sigmoid(config.noise_opacity_k * (config.min_opacity - opac))
    R = _quat_to_rotmat(_unit_quats(params["quats"]))
    z = _normal(generator, (n, 3), raw.device)
    s = torch.exp(params["scales"])
    if s.shape[-1] < 3:
        s = torch.nn.functional.pad(s, (0, 3 - s.shape[-1]), value=1e-6)
    sample = torch.einsum("nij,nj->ni", R, s * z)  # ~ N(0, R S^2 R^T)
    step = lr * config.noise_lr * gate
    out = dict(params)
    out["means3d"] = params["means3d"] + step[:, None] * sample
    return out


def mcmc_regularization(params, config: MCMCConfig = MCMCConfig()) -> torch.Tensor:
    """L1 opacity + linear-scale regularizers (keep capacity churning)."""
    return (config.opacity_reg * torch.mean(torch.sigmoid(params["opacities_raw"]))
            + config.scale_reg * torch.mean(torch.abs(torch.exp(params["scales"]))))
