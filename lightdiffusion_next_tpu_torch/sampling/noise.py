"""Seeded noise: the initial latent noise and the Brownian-tree noise of
the SDE samplers.

Counterpart of lightdiffusion_next_tpu/sampling/noise.py in its "torch"
mode, bit for bit: torch's CPU generator, seeded per call, and the same
float32 numpy arithmetic in the same order. Noise is drawn in the shape of
the latent the caller passes, which is NHWC here as in the JAX package;
drawing NCHW and transposing gives different numbers. All of it is drawn
on the host before the sampler loop; the caller moves it to the device
once.

Not ported yet (ROADMAP Queue 1, item 2): the "jax" mode and its
``BrownianIntervalSampler``, the batch-repeat ``noise_inds`` and the
ancestral per-step noise.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def prepare_noise(shape: Sequence[int], seed: int) -> torch.Tensor:
    """Initial latent noise, f32 on the CPU."""
    generator = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(tuple(shape), generator=generator)


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


def sde_noise_for_steps(shape: Sequence[int], sigmas: np.ndarray, r: float, eta: float,
                        seed: Optional[int], mode: str = "torch"
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """The two per-step noises of dpmpp_sde, (n_steps, *shape) f32 each:
    step i's increments of the tree over (sigma_i, sigma_mid_i) and (sigma_i,
    sigma_i+1), each divided by sqrt of its interval's width, with sigma_mid
    = exp(lerp(log sigmas, r)); zero where sigma_i+1 is 0. The tree spans
    the smallest positive sigma to the largest, seeded by ``seed``. ``eta``
    is not read: it keeps the JAX function's signature."""
    if mode != "torch":
        raise NotImplementedError(
            f"rng mode {mode!r} is not ported yet (ROADMAP Queue 1, item 2)")
    sigmas = np.asarray(sigmas, dtype=np.float64)
    n = len(sigmas) - 1
    t = -np.log(np.maximum(sigmas, 1e-20))
    mids = np.exp(-(t[:-1] + (t[1:] - t[:-1]) * r))
    pos = sigmas[sigmas > 0]
    tree = TorchSDEBrownianTree(shape, float(pos.min()), float(sigmas.max()),
                                entropy=seed or 0)

    def sampler(s_from, s_to):
        return tree(s_from, s_to) / np.sqrt(abs(s_to - s_from))

    noise1 = np.zeros((n,) + tuple(shape), dtype=np.float32)
    noise2 = np.zeros((n,) + tuple(shape), dtype=np.float32)
    for i in range(n):
        if sigmas[i + 1] == 0:
            continue
        noise1[i] = sampler(sigmas[i], mids[i])
        noise2[i] = sampler(sigmas[i], sigmas[i + 1])
    return noise1, noise2
