"""PyTorch port: density control against the JAX package.

(The render's densification sinks are held against JAX's in
tests/test_torch_render.py.)

(a) Every ADC and MCMC function against JAX's with the random draws
    injected: the port's draw helpers (``_normal``, ``_categorical``) are
    replaced by the numbers ``jax.random`` drew from the same key, so every
    output compares (rtol 1e-5: pow, exp and log in another library). The
    port's own draws are checked for their distribution.
(b) ``train_step_with_densify_stats`` against JAX's with SGD, absgrad off
    and on, on both port routes: loss, parameters and statistics; then a
    few steps and one ``densify_and_prune`` give the same cloned, split,
    pruned and alive counts.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mojosplat_tpu import Camera as JCamera
from mojosplat_tpu import RenderConfig as JConfig
from mojosplat_tpu import densify as jdensify
from mojosplat_tpu import train as jtrain
from mojosplat_tpu_torch import Camera, config_from_jax
from mojosplat_tpu_torch import densify as tdensify
from mojosplat_tpu_torch import train as ttrain
from mojosplat_tpu_torch.convert import params_from_numpy

RTOL, ATOL = 5e-5, 5e-6
H, W = 32, 48
JCFG = JConfig(tile_capacity=128, chunk_size=64, max_tile_span=4)


def jcam(batch=None):
    kw = dict(R=np.eye(3), T=np.zeros(3), H=H, W=W, fx=40.0, fy=40.0, cx=24.0, cy=16.0)
    if batch is None:
        return JCamera.create(**kw)
    f = lambda v: np.full((batch,), v, np.float32)  # noqa: E731
    return JCamera.create(R=np.stack([np.eye(3)] * batch), T=np.zeros((batch, 3)), H=H, W=W,
                          fx=f(40.0), fy=f(40.0), cx=f(24.0), cy=f(16.0), near=f(0.1),
                          far=f(100.0))


def tcam():
    return Camera.create(R=np.eye(3), T=np.zeros(3), H=H, W=W, fx=40.0, fy=40.0, cx=24.0,
                         cy=16.0, device="cpu")


def raw_scene(n, seed):
    """Raw (trainable) RGB gaussians in front of the camera."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(0, 0.6, (n, 2)), rng.uniform(1.5, 4.0, (n, 1))], 1)
    f32 = np.float32
    return dict(means3d=means.astype(f32), scales=rng.normal(-2.3, 0.5, (n, 3)).astype(f32),
                quats=rng.normal(size=(n, 4)).astype(f32),
                opacities_raw=rng.normal(0.5, 1.5, n).astype(f32),
                features=rng.uniform(0, 1, (n, 3)).astype(f32))


def port_cfg(route):
    return dataclasses.replace(config_from_jax(dataclasses.asdict(JCFG)), raster_impl=route)


def assert_close(got, want, err_msg="", rtol=RTOL, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * (float(np.abs(want).max()) + 1e-12),
                               err_msg=err_msg)


def from_np(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def assert_params_close(got, want, err=""):
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=f"{err} {k}")


def densify_scene(seed=0):
    """Padded RGB params with hot, small, large, transparent and dead
    gaussians, and accumulated statistics."""
    rng = np.random.default_rng(seed)
    raw = {k: np.array(v) for k, v in jdensify.pad_to_capacity(
        {k: jnp.asarray(v) for k, v in raw_scene(40, seed).items()}, 64).items()}
    raw["scales"][:40] = rng.normal(-4.0, 1.2, (40, 3)).astype(np.float32)
    raw["opacities_raw"][30:34] = -6.0  # transparent: pruned
    grads = rng.normal(0, 4e-4, (64, 2)).astype(np.float32)
    visible = rng.random(64) < 0.8
    return raw, grads, visible


def test_adc_functions_match_jax(monkeypatch):
    raw, grads, visible = densify_scene()
    jp = {k: jnp.asarray(v) for k, v in raw.items()}
    tp = from_np(raw)
    # pad_to_capacity, alive_mask
    small = {k: v[:40] for k, v in raw.items()}
    assert_params_close(tdensify.pad_to_capacity(from_np(small), 64),
                        jdensify.pad_to_capacity({k: jnp.asarray(v) for k, v in small.items()},
                                                 64), "pad")
    with pytest.raises(ValueError):
        tdensify.pad_to_capacity(tp, 10)
    assert torch.equal(tdensify.alive_mask(tp), torch.from_numpy(np.array(
        jdensify.alive_mask(jp))))
    # accumulate_stats, twice
    js, ts = jdensify.DensifyState.zero(64), tdensify.DensifyState.zero(64, device="cpu")
    for _ in range(2):
        js = jdensify.accumulate_stats(js, jnp.asarray(grads), jnp.asarray(visible))
        ts = tdensify.accumulate_stats(ts, torch.from_numpy(grads), torch.from_numpy(visible))
    np.testing.assert_allclose(ts.grad_accum.numpy(), np.asarray(js.grad_accum), rtol=1e-6)
    np.testing.assert_array_equal(ts.count.numpy(), np.asarray(js.count))
    # densify_and_prune with the normal draws injected
    key = jax.random.PRNGKey(3)
    draws = np.array(jax.random.normal(key, (64, 1)))
    monkeypatch.setattr(tdensify, "_normal", lambda gen, shape, device: torch.from_numpy(draws))
    for cfg in (jdensify.DensifyConfig(), jdensify.DensifyConfig(max_new_fraction=0.05)):
        jnew, jstate, jm = jdensify.densify_and_prune(jp, js, key, 2.0, cfg)
        tnew, tstate, tm = tdensify.densify_and_prune(
            tp, ts, torch.Generator(), 2.0, tdensify.DensifyConfig(**dataclasses.asdict(cfg)))
        assert {k: int(v) for k, v in tm.items()} == {k: int(v) for k, v in jm.items()}
        assert_params_close(tnew, jnew, "densify")
        if cfg.max_new_fraction == 0.25:
            assert int(tm["cloned"]) > 0 and int(tm["split"]) > 0 and int(tm["pruned"]) > 0
        assert int(tstate.count.sum()) == 0
    # reset_opacities
    assert_params_close(tdensify.reset_opacities(tp), jdensify.reset_opacities(jp), "reset")


def test_mcmc_functions_match_jax(monkeypatch):
    raw, _, _ = densify_scene(1)
    raw["opacities_raw"][:8] = -8.0  # below min_opacity: relocatable
    jp = {k: jnp.asarray(v) for k, v in raw.items()}
    tp = from_np(raw)
    # relocation_update over every ratio
    o = np.linspace(0.01, 0.99, 60).astype(np.float32)
    ratio = np.arange(60, dtype=np.int32) % 55
    for a, b in zip(tdensify.relocation_update(torch.from_numpy(o), torch.from_numpy(ratio)),
                    jdensify.relocation_update(jnp.asarray(o), jnp.asarray(ratio))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)
    # mcmc_relocate with the categorical draws injected
    key = jax.random.PRNGKey(4)
    opac = jax.nn.sigmoid(jp["opacities_raw"])
    logits = jnp.where(opac >= 0.005, jnp.log(jnp.maximum(opac, 1e-12)), -jnp.inf)
    draws = np.array(jax.random.categorical(key, logits, shape=(64,)))
    monkeypatch.setattr(tdensify, "_categorical",
                        lambda gen, weights, n: torch.from_numpy(draws.astype(np.int64)))
    jnew, jm = jdensify.mcmc_relocate(jp, key)
    tnew, tm = tdensify.mcmc_relocate(tp, torch.Generator())
    assert {k: int(v) for k, v in tm.items()} == {k: int(v) for k, v in jm.items()}
    assert int(tm["relocated"]) > 0
    assert_params_close(tnew, jnew, "relocate")
    # mcmc_position_noise, 3DGS and surfels, with the normal draws injected
    for scales in (raw["scales"], raw["scales"][:, :2]):
        q = dict(raw, scales=np.ascontiguousarray(scales))
        z = np.array(jax.random.normal(key, (64, 3)))
        monkeypatch.setattr(tdensify, "_normal", lambda gen, shape, device: torch.from_numpy(z))
        assert_params_close(
            tdensify.mcmc_position_noise(from_np(q), torch.Generator(), 1e-3),
            jdensify.mcmc_position_noise({k: jnp.asarray(v) for k, v in q.items()}, key, 1e-3),
            f"noise {scales.shape}")
    np.testing.assert_allclose(float(tdensify.mcmc_regularization(tp)),
                               float(jdensify.mcmc_regularization(jp)), rtol=1e-6)
    # No gaussian alive: a strict no-op.
    dead = dict(tp, opacities_raw=torch.full((64,), -10.0))
    out, m = tdensify.mcmc_relocate(dead, torch.Generator())
    assert int(m["relocated"]) == 0 and all(torch.equal(out[k], dead[k]) for k in dead)


def test_port_draws_follow_their_distributions():
    gen = torch.Generator().manual_seed(0)
    weights = torch.tensor([0.0, 0.1, 0.2, 0.7])
    idx = tdensify._categorical(gen, weights, 200_000)
    freq = torch.bincount(idx, minlength=4).double() / idx.numel()
    assert freq[0] == 0
    np.testing.assert_allclose(freq[1:].numpy(), [0.1, 0.2, 0.7], atol=5e-3)
    z = tdensify._normal(gen, (100_000, 3), "cpu")
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1) < 0.01
    # Relocated slots land on alive gaussians, more often on opaque ones.
    raw, _, _ = densify_scene(2)
    raw["opacities_raw"][:40] = np.where(np.arange(40) < 20, -8.0, 0.0)
    raw["opacities_raw"][38:40] = 4.0
    out, m = tdensify.mcmc_relocate(from_np(raw), gen)
    moved = out["means3d"][:20]
    src = torch.from_numpy(raw["means3d"])
    hits = [int(torch.nonzero((src == row).all(1))[0]) for row in moved]
    assert all(20 <= h < 40 for h in hits) and int(m["relocated"]) >= 20


@functools.cache
def jax_step(absgrad):
    opt = optax.sgd(0.05)
    fn = functools.partial(jtrain.train_step_with_densify_stats, optimizer=opt, config=JCFG,
                           absgrad=absgrad)
    return opt, jax.jit(fn)


def step_inputs(seed, n=64):
    """Raw params and two target views; 64 gaussians in both step tests,
    so they share one compile of the JAX step."""
    raw = raw_scene(n, seed)
    targets = np.random.default_rng(seed).uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    return raw, targets


@pytest.mark.parametrize("absgrad", [False, True])
def test_train_step_with_densify_stats_matches_jax(absgrad):
    raw, targets = step_inputs(5)
    opt, step = jax_step(absgrad)
    state = jtrain.init_train_state({k: jnp.asarray(v) for k, v in raw.items()}, opt)
    jstate, jd, jloss = step(state, jdensify.DensifyState.zero(64), jcam(2),
                             jnp.asarray(targets))
    assert np.asarray(jd.grad_accum).max() > 0
    for route in ("torch", "cuda"):
        leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(raw, "cpu").items()}
        d, loss = ttrain.train_step_with_densify_stats(
            leaves, torch.optim.SGD(leaves.values(), lr=0.05),
            tdensify.DensifyState.zero(64, device="cpu"), [tcam(), tcam()],
            torch.from_numpy(targets), config=port_cfg(route), absgrad=absgrad)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
        np.testing.assert_array_equal(d.count.numpy(), np.asarray(jd.count))
        assert_close(d.grad_accum.numpy(), jd.grad_accum, f"{route} stats")
        for k in raw:
            step_t = (leaves[k].detach().numpy() - raw[k]) / -0.05
            step_j = (np.asarray(jstate.params[k]) - raw[k]) / -0.05
            np.testing.assert_allclose(
                step_t, step_j, rtol=RTOL, atol=ATOL * float(np.abs(step_j).max())
                + 2 * float(np.abs(raw[k]).max()) * 2**-23 / 0.05, err_msg=f"{route} {k}")


def test_steps_then_densify_match_jax_counts(monkeypatch):
    """Three steps with the statistics, then one event: the same counts."""
    raw, targets = step_inputs(6, n=48)
    raw = {k: np.array(v) for k, v in jdensify.pad_to_capacity(
        {k: jnp.asarray(v) for k, v in raw.items()}, 64).items()}
    raw["opacities_raw"][:4] = -6.0  # transparent: pruned
    opt, step = jax_step(False)
    state = jtrain.init_train_state({k: jnp.asarray(v) for k, v in raw.items()}, opt)
    jd = jdensify.DensifyState.zero(64)
    leaves = {k: v.requires_grad_(True) for k, v in params_from_numpy(raw, "cpu").items()}
    topt = torch.optim.SGD(leaves.values(), lr=0.05)
    td = tdensify.DensifyState.zero(64, device="cpu")
    for _ in range(3):
        state, jd, _ = step(state, jd, jcam(2), jnp.asarray(targets))
        td, _ = ttrain.train_step_with_densify_stats(leaves, topt, td, [tcam(), tcam()],
                                                     torch.from_numpy(targets),
                                                     config=port_cfg("cuda"))
    # A threshold in the widest gap between the middle mean gradients, so a
    # rounding difference cannot move a gaussian across it.
    mean = np.sort(np.asarray(jd.grad_accum / jnp.maximum(jd.count, 1)))
    mid = mean[16:48]
    gap = int(np.argmax(mid[1:] - mid[:-1]))
    cfg = jdensify.DensifyConfig(grad_threshold=float(mid[gap] + mid[gap + 1]) / 2)
    key = jax.random.PRNGKey(9)
    draws = np.array(jax.random.normal(key, (64, 1)))
    monkeypatch.setattr(tdensify, "_normal", lambda gen, shape, device: torch.from_numpy(draws))
    jnew, _, jm = jdensify.densify_and_prune(state.params, jd, key, 2.0, cfg)
    with torch.no_grad():
        tnew, _, tm = tdensify.densify_and_prune(
            leaves, td, torch.Generator(), 2.0, tdensify.DensifyConfig(**dataclasses.asdict(cfg)))
    assert {k: int(v) for k, v in tm.items()} == {k: int(v) for k, v in jm.items()}
    assert int(tm["pruned"]) > 0 and int(tm["cloned"]) + int(tm["split"]) > 0
    assert_params_close(tnew, jnew, "after steps")
