"""The blend-variant probe (kernel B9): B1 with one op chain stripped.

Port of ``run_variant`` in the reference's ``scripts/dev_kernel_probe.py``,
the tool that attributes the blend's time: it replays the tile blend B1
(``raster_cuda.raster_tiles``) with one chain of its operations stripped at
a time, or with the blend product at the precisions of a bf16 matrix unit.
Every variant but ``"full"`` gives a wrong image on purpose:

  - ``full``: B1 exactly (the probe's kernel IS B1's production code).
  - ``noexp``: e = 1 - min(sigma, 1) * 0.6 in place of exp(-sigma).
  - ``exp2``: e = exp2(-sigma * log2(e)).
  - ``nomask``: alpha = opacity * exp(-sigma) * 0.001, with no sigma,
    threshold or count test, over every slot of each chunk that starts
    below the tile's count; then ``full``'s transmittance chain and stop.
  - ``noscan``: w = alpha * T at the chunk's entry for every kept slot; T
    is multiplied by 0.999 once per chunk and never stops.
  - ``blend``: acc += opacity * channels over every slot of each such
    chunk; T stays 1.
  - ``memonly``: acc[c] += the sum over the field rows of the chunk's slot
    c, for c < cp (the reference's ``jnp.sum(g, axis=0)[:, :cp]``); T
    stays 1.
  - ``blend1``: ``full``'s chain, the product's weight and channels rounded
    to bf16 (round to nearest even) and summed in f32: one bf16 matrix-unit
    pass.
  - ``blend3``: ``full``'s chain, the product wh*chh + wh*bf16(cl) +
    bf16(wl)*chh, with h the bf16 rounding and l what it leaves: the
    three-pass split.

A chunk is ``chunk`` slots (the reference's ``pallas_chunk``); the kernel
stages one chunk per step. ``raster_variant`` launches the kernel
(``csrc/raster_fwd.cu``, ``raster_probe_launch``) on a CUDA tensor and runs
``raster_variant_plain`` on a CPU tensor.
"""

from __future__ import annotations

import torch

from .. import _kernels
from ..config import RenderConfig
from .raster_cuda import _check_blend_args, raster_tiles_plain
from .rasterization import _chunk_transmittance, tile_pixel_centers

VARIANTS = ("full", "noexp", "exp2", "nomask", "noscan", "blend", "memonly",
            "blend1", "blend3")
PROBE_CHUNK = 256  # the reference probe's pallas_chunk, and B1's staging batch
_MAX_CHUNK = 256  # kBatch in csrc/raster_fwd.cu


def _check_variant(variant: str, chunk: int, cap: int, cp: int) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; expected one of {VARIANTS}")
    if not cp <= chunk <= _MAX_CHUNK or cap % chunk:
        raise ValueError(
            f"chunk must divide the tile capacity {cap} and lie in [{cp}, {_MAX_CHUNK}], "
            f"got {chunk}")


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _variant_alpha(variant, px, py, chunk, valid, config):
    """(G, P, K) alphas of one chunk under ``variant``, zeroed where the
    variant skips a slot (``nomask`` skips none)."""
    dx = chunk[0][:, None, :] - px[:, :, None]
    dy = chunk[1][:, None, :] - py[:, :, None]
    a, b, c = (chunk[r][:, None, :] for r in (2, 3, 4))
    sigma = 0.5 * (a * dx * dx + c * dy * dy) + b * dx * dy
    if variant == "noexp":
        e = 1.0 - torch.clamp(sigma, max=1.0) * 0.6
    elif variant == "exp2":
        e = torch.exp2(sigma * -1.4426950408889634)
    else:
        e = torch.exp(-sigma)
    raw = chunk[5][:, None, :] * e
    if variant == "nomask":
        return raw * 0.001
    alpha = torch.clamp(raw, max=config.max_alpha)
    keep = valid[:, None, :] & (sigma >= 0.0) & (alpha >= config.alpha_threshold)
    return torch.where(keep, alpha, torch.zeros_like(alpha))


def _bf16_term(variant, w, ch):
    """One slot's bf16 blend product, (G, P, 1) weights x (G, 1, cp)
    channels, each operand rounded as the kernel rounds it. Every product
    of two bf16 values is exact in f32, so only the sums round."""
    wh, chh = _bf16(w), _bf16(ch)
    if variant == "blend1":
        return wh * chh
    return (wh * chh + wh * _bf16(ch - chh)) + _bf16(w - wh) * chh


def _serial_bf16(variant, g, cnt, px, py, config):
    """blend1 / blend3 over one group of tiles, walking the slots one at a
    time with the kernel's f32 transmittance chain. ``g`` (rows, G, cap);
    returns acc (G, P, cp) and T (G, P)."""
    G, P = px.shape
    T = torch.ones((G, P), dtype=torch.float32, device=g.device)
    done = torch.zeros((G, P), dtype=torch.bool, device=g.device)
    acc = torch.zeros((G, P, g.shape[0] - 6), dtype=torch.float32, device=g.device)
    for j in range(min(int(cnt.max()), g.shape[2]) if G else 0):
        s = g[:, :, j : j + 1]  # (rows, G, 1)
        alpha = _variant_alpha("full", px, py, s, (j < cnt)[:, None], config)[..., 0]
        live = ~done & (alpha > 0.0)  # kept (alpha >= threshold) and not stopped
        next_T = T * (1.0 - alpha)
        stop = live & (next_T <= config.transmittance_eps)
        apply = live & ~stop
        w = torch.where(apply, alpha * T, torch.zeros_like(T))
        acc = acc + _bf16_term(variant, w[..., None], s[6:, :, 0].T[:, None, :])
        T = torch.where(apply, next_T, T)
        done = done | stop
    return acc, T


def raster_variant_plain(variant: str, pdata, counts, ts: int, tw: int,
                         config: RenderConfig, chunk: int = PROBE_CHUNK) -> torch.Tensor:
    """Plain PyTorch version of the probe: (n_tiles, cp + 1, ts * ts), as
    ``raster_tiles``. ``"full"`` is ``raster_tiles_plain``; ``blend1`` and
    ``blend3`` walk the slots one at a time with the kernel's f32
    transmittance chain: a bf16 rounding turns a one-ulp difference in a
    weight into 2^-8 of its product, so a chain that multiplies T in
    another order would differ from the kernel as much as the bf16 product
    differs from ``full``. The others walk ``chunk``-slot chunks with a
    cumulative product along the chunk, as the reference's kernel body
    does."""
    rows = pdata.shape[0]
    n_tiles = counts.shape[0]
    cap = pdata.shape[1] // max(n_tiles, 1)
    cp = rows - 6
    _check_variant(variant, chunk, cap, cp)
    if variant == "full":
        return raster_tiles_plain(pdata, counts, ts, tw, config)
    P = ts * ts
    dev = pdata.device
    pd = pdata.reshape(rows, n_tiles, cap)
    out = torch.empty((n_tiles, cp + 1, P), dtype=torch.float32, device=dev)
    group = config.tile_batch or max(n_tiles, 1)
    for g0 in range(0, n_tiles, group):
        tiles = torch.arange(g0, min(g0 + group, n_tiles), device=dev)
        G = tiles.shape[0]
        px, py = tile_pixel_centers(tiles, ts, tw, torch.float32)
        if variant in ("blend1", "blend3"):
            acc, T = _serial_bf16(variant, pd[:, tiles], counts[tiles], px, py, config)
            out[g0 : g0 + G] = torch.cat([acc, T[..., None]], dim=-1).transpose(1, 2)
            continue
        T = torch.ones((G, P), dtype=torch.float32, device=dev)
        done = torch.zeros((G, P), dtype=torch.bool, device=dev)
        acc = torch.zeros((G, P, cp), dtype=torch.float32, device=dev)
        for k0 in range(0, cap, chunk):
            run = k0 < counts[tiles]  # (G,): the chunk starts below the count
            if not bool(run.any()):
                break
            g = pd[:, tiles, k0 : k0 + chunk]  # (rows, G, K)
            cols = g[6:].permute(1, 2, 0)  # (G, K, cp)
            if variant == "memonly":
                new_acc = acc + g.sum(dim=0)[:, None, :cp]
                new_T, new_done = T, done
            elif variant == "blend":
                new_acc = acc + torch.matmul(g[5][:, None, :], cols)
                new_T, new_done = T, done
            else:
                lane = torch.arange(chunk, device=dev)
                valid = (k0 + lane)[None, :] < counts[tiles, None]  # (G, K)
                alpha = _variant_alpha(variant, px, py, g, valid, config)
                if variant == "noscan":
                    new_acc = acc + torch.matmul(alpha * T[..., None], cols)
                    new_T, new_done = T * 0.999, done
                else:
                    _, eff, excl, trans, new_done = _chunk_transmittance(
                        T, done, alpha, config.transmittance_eps)
                    w = eff * (T[..., None] * excl)
                    new_acc = acc + torch.matmul(w, cols)
                    new_T = T * trans
            r = run[:, None]
            acc = torch.where(r[..., None], new_acc, acc)
            T = torch.where(r, new_T, T)
            done = torch.where(r, new_done, done)
        out[g0 : g0 + G] = torch.cat([acc, T[..., None]], dim=-1).transpose(1, 2)
    return out


def raster_variant(variant: str, pdata, counts, ts: int, tw: int, config: RenderConfig,
                   chunk: int = PROBE_CHUNK) -> torch.Tensor:
    """The probe's ``variant`` of the tile blend on B1's inputs: the kernel
    on a CUDA tensor, ``raster_variant_plain`` on a CPU tensor. Counts a
    launch in ``raster_variant.launches``."""
    if pdata.device.type == "cpu":
        return raster_variant_plain(variant, pdata, counts, ts, tw, config, chunk)
    cap = _check_blend_args(pdata, counts, ts)
    rows, n_tiles, P = pdata.shape[0], counts.shape[0], ts * ts
    _check_variant(variant, chunk, cap, rows - 6)
    out = torch.empty((n_tiles, rows - 5, P), dtype=torch.float32, device=pdata.device)
    _kernels.launch(
        "raster_probe_launch", pdata.device, VARIANTS.index(variant), chunk,
        pdata.data_ptr(), rows, n_tiles, cap, counts.data_ptr(), ts, tw,
        config.alpha_threshold, config.max_alpha, config.transmittance_eps, out.data_ptr(),
    )
    raster_variant.launches += 1
    return out


raster_variant.launches = 0
