"""Seeded noise: the initial latent noise, the ancestral samplers' per-step
noise and the Brownian-tree noise of the SDE samplers.

Counterpart of lightdiffusion_next_tpu/sampling/noise.py in both its
modes (``RuntimeConfig.rng_mode``), bit for bit:

- "torch": torch's CPU generator, seeded per call, the reference's
  stream, and for the SDE samplers torchsde's Brownian tree
  (``TorchSDEBrownianTree``);
- "jax": numpy's Philox generator (the JAX package names this mode after
  itself, but draws with numpy on the host): ``Philox(seed)`` for the
  initial noise, ``Philox(key=seed, counter=1)`` for the ancestral
  samplers' steps, and a Brownian path summed in float64 over the sigma
  breakpoints (``BrownianIntervalSampler``) for the SDE samplers.

The same float32 numpy arithmetic runs in the same order. Noise is drawn
in the shape of the latent the caller passes, which is NHWC here as in the
JAX package; drawing NCHW and transposing gives different numbers. All of
it is drawn on the host before the sampler loop, f32 on the CPU; the
caller moves it to the device once.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _check_mode(mode: str) -> None:
    if mode != "jax":
        raise ValueError(f'rng mode must be "torch" or "jax", not {mode!r}')


def _by_index(draw, shape, noise_inds) -> np.ndarray:
    """The reference's batch-repeat scheme: one (1, *shape[1:]) draw for
    each index up to the largest in ``noise_inds``, kept where the index
    occurs, gathered in ``noise_inds``' order."""
    unique_inds, inverse = np.unique(noise_inds, return_inverse=True)
    noises = []
    for i in range(unique_inds[-1] + 1):
        noise = draw((1,) + tuple(shape)[1:])
        if i in unique_inds:
            noises.append(noise)
    return np.concatenate([noises[i] for i in inverse.reshape(-1)], axis=0)


def prepare_noise(shape: Sequence[int], seed: int, mode: str = "torch",
                  noise_inds: Optional[Sequence[int]] = None) -> torch.Tensor:
    """Initial latent noise, f32 on the CPU. ``noise_inds``: batch-repeat
    indices (``_by_index``)."""
    if mode == "torch":
        generator = torch.Generator(device="cpu").manual_seed(seed)
        if noise_inds is None:
            return torch.randn(tuple(shape), generator=generator)

        def draw(s):
            return torch.randn(s, generator=generator).numpy()
    else:
        _check_mode(mode)
        rng = np.random.Generator(np.random.Philox(seed))
        if noise_inds is None:
            return torch.from_numpy(rng.standard_normal(tuple(shape)).astype(np.float32))
        draw = rng.standard_normal
    return torch.from_numpy(_by_index(draw, shape, noise_inds).astype(np.float32))


def step_noise_batch(shape: Sequence[int], n: int, seed: int,
                     mode: str = "torch") -> torch.Tensor:
    """(n, *shape) standard normals for the ancestral samplers, f32 on the
    CPU. "torch": the stream ``prepare_noise(shape, seed)`` started,
    continued past the initial noise (the reference's ``randn_like`` on the
    generator state that call left behind); "jax": Philox at counter 1."""
    if mode == "torch":
        generator = torch.Generator(device="cpu").manual_seed(seed)
        torch.randn(tuple(shape), generator=generator)  # the initial noise
        return torch.randn((n,) + tuple(shape), generator=generator)
    _check_mode(mode)
    rng = np.random.Generator(np.random.Philox(key=seed, counter=1))
    return torch.from_numpy(rng.standard_normal((n,) + tuple(shape)).astype(np.float32))


class TorchSDEBrownianTree:
    """The value stream of torchsde's ``BrownianTree(t0, w0, t1,
    entropy=seed)`` (torchsde 0.2.6's halfway-tree ``BrownianInterval``),
    as the JAX package computes it:

    - seeds: ``np.random.SeedSequence(entropy, pool_size=24)`` gives
      (initial W seed, initial H seed, top seed); each gaussian is
      ``torch.randn`` from ``torch.Generator().manual_seed(seed)``;
    - W(t1) - W(t0) = randn(W seed) * sqrt(t1 - t0);
    - W(t) bisects [t0, t1] at midpoints: a child's increment is the
      Brownian bridge W_left = W * lf + std * randn(node seed), the node
      seed spawned from the top seed by (2 * spawn key, depth + 1), until
      the interval is at most ``tol`` wide, then snaps to the nearer end;
    - ``__call__(ta, tb)`` = W(tb) - W(ta), with torchsde's signs.

    Bridge noises are cached per node, at most 64, the oldest unused
    evicted first: the upper levels that queries share stay resident.
    """

    def __init__(self, shape: Sequence[int], t0: float, t1: float, entropy: int,
                 tol: float = 1e-6, dtype=np.float32):
        self.shape = tuple(shape)
        self._t0, self._t1 = float(t0), float(t1)
        self._sign_init = 1.0
        if self._t0 > self._t1:
            self._t0, self._t1 = self._t1, self._t0
            self._sign_init = -1.0
        self._tol = float(tol)
        self.dtype = dtype
        ss = np.random.SeedSequence(entropy=int(entropy), pool_size=24)
        w_seed, _h_seed, top_seed = (int(s) for s in ss.generate_state(3))
        self._top_seed = top_seed
        self._W_global = self._randn(w_seed) * np.float32(math.sqrt(self._t1 - self._t0))
        self._bridge_cache: dict = {}
        self._cache_max = 64

    def _randn(self, seed: int) -> np.ndarray:
        g = torch.Generator().manual_seed(int(seed))
        return torch.randn(self.shape, generator=g, dtype=torch.float32).numpy()

    def _node_noise(self, spawn_key: int, depth: int) -> np.ndarray:
        key = (spawn_key, depth)
        cached = self._bridge_cache.pop(key, None)
        if cached is not None:
            self._bridge_cache[key] = cached  # most recently used
            return cached
        seed = int(np.random.SeedSequence(entropy=self._top_seed,
                                          spawn_key=key).generate_state(1)[0])
        noise = self._randn(seed)
        if len(self._bridge_cache) >= self._cache_max:
            self._bridge_cache.pop(next(iter(self._bridge_cache)))
        self._bridge_cache[key] = noise
        return noise

    def _w_at(self, t: float) -> np.ndarray:
        """W(t) - W(t0) by dyadic bisection to within tol."""
        t = min(max(float(t), self._t0), self._t1)
        lo, hi = self._t0, self._t1
        w_lo = np.zeros(self.shape, dtype=np.float32)
        w_int = self._W_global
        spawn_key, depth = 0, 0
        while (hi - lo) > self._tol and lo < t < hi:
            mid = (lo + hi) / 2
            lf = np.float32((mid - lo) / (hi - lo))
            std = np.float32(math.sqrt((mid - lo) * (hi - mid) / (hi - lo)))
            w_left = w_int * lf + std * self._node_noise(2 * spawn_key, depth + 1)
            if t <= mid:
                hi, w_int = mid, w_left
                spawn_key, depth = 2 * spawn_key, depth + 1
            else:
                lo = mid
                w_lo = w_lo + w_left
                w_int = w_int - w_left
                spawn_key, depth = 2 * spawn_key + 1, depth + 1
        if t >= (lo + hi) / 2:
            w_lo = w_lo + w_int
        return w_lo

    def __call__(self, t_a: float, t_b: float) -> np.ndarray:
        ta, tb, sign = ((float(t_a), float(t_b), 1.0) if float(t_a) < float(t_b)
                        else (float(t_b), float(t_a), -1.0))
        w = (self._w_at(tb) - self._w_at(ta)) * (self._sign_init * sign)
        return w.astype(self.dtype)


class BrownianIntervalSampler:
    """The "jax" mode's Brownian path W over the sigma axis, made once over
    every breakpoint the sampler will query: each segment's increment is a
    standard normal from numpy's Philox at ``seed`` times sqrt(dt), summed
    in float64 (the JAX package's dtypes and order, so the increments agree
    to the last bit). ``__call__(s_from, s_to)`` = (W(t1) - W(t0)) /
    sqrt(|t1 - t0|)."""

    def __init__(self, shape: Sequence[int], levels: Sequence[float],
                 seed: Optional[int] = None, dtype=np.float32):
        self.shape = tuple(shape)
        self.points = np.asarray(sorted({float(v) for v in levels}), dtype=np.float64)
        n_seg = max(len(self.points) - 1, 0)
        rng = np.random.Generator(np.random.Philox(seed or 0))
        gauss = rng.standard_normal((n_seg,) + self.shape)
        seg_std = np.sqrt(np.diff(self.points)).astype(np.float64)
        incs = gauss.astype(np.float64) * seg_std.reshape((n_seg,) + (1,) * len(self.shape))
        self.W = np.concatenate([np.zeros((1,) + self.shape), np.cumsum(incs, axis=0)],
                                axis=0)
        self.dtype = dtype

    def _w_at(self, t: float) -> np.ndarray:
        idx = int(np.argmin(np.abs(self.points - t)))
        if not np.isclose(self.points[idx], t, rtol=1e-5, atol=1e-8):
            raise KeyError(f"sigma level {t} was not registered at construction")
        return self.W[idx]

    def __call__(self, sigma_from: float, sigma_to: float) -> np.ndarray:
        t0, t1 = float(sigma_from), float(sigma_to)
        lo, hi, sign = (t0, t1, 1.0) if t0 < t1 else (t1, t0, -1.0)
        dt = hi - lo
        if dt <= 0:
            return np.zeros(self.shape, dtype=self.dtype)
        w = (self._w_at(hi) - self._w_at(lo)) * sign
        return (w / np.sqrt(dt)).astype(self.dtype)


def sde_noise_for_steps(shape: Sequence[int], sigmas: np.ndarray, r: float, eta: float,
                        seed: Optional[int], mode: str = "torch"
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """The two per-step noises of dpmpp_sde, (n_steps, *shape) f32 each:
    step i's normalized increments over (sigma_i, sigma_mid_i) and (sigma_i,
    sigma_i+1), with sigma_mid = exp(lerp(log sigmas, r)); zero where
    sigma_i+1 is 0. "torch": torchsde's tree from the smallest positive
    sigma to the largest, seeded by ``seed``, each increment divided by sqrt
    of its interval's width; "jax": ``BrownianIntervalSampler`` over the
    positive sigmas and the midpoints of the steps that end above 0.
    ``eta`` is not read: it keeps the JAX function's signature."""
    sigmas = np.asarray(sigmas, dtype=np.float64)
    n = len(sigmas) - 1
    t = -np.log(np.maximum(sigmas, 1e-20))
    mids = np.exp(-(t[:-1] + (t[1:] - t[:-1]) * r))
    if mode == "torch":
        pos = sigmas[sigmas > 0]
        tree = TorchSDEBrownianTree(shape, float(pos.min()), float(sigmas.max()),
                                    entropy=seed or 0)

        def sampler(s_from, s_to):
            return tree(s_from, s_to) / np.sqrt(abs(s_to - s_from))
    else:
        _check_mode(mode)
        levels = list(sigmas[sigmas > 0]) + [m for i, m in enumerate(mids)
                                             if sigmas[i + 1] > 0]
        sampler = BrownianIntervalSampler(shape, levels, seed=seed)

    noise1 = np.zeros((n,) + tuple(shape), dtype=np.float32)
    noise2 = np.zeros((n,) + tuple(shape), dtype=np.float32)
    for i in range(n):
        if sigmas[i + 1] == 0:
            continue
        noise1[i] = sampler(sigmas[i], mids[i])
        noise2[i] = sampler(sigmas[i], sigmas[i + 1])
    return noise1, noise2
