"""The port's ops/nn.py and ops/window.py against the JAX package's.

Inputs are numpy arrays from a seed, handed to both. Conv weights go in as
HWIO to JAX and as OIHW to the port. Tolerance for f32 ops: atol/rtol 1e-5
(summation order differs between XLA and PyTorch on the CPU); the window
partition, reverse and shift are pure data movement and must match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu.ops import nn as jnn
from lightdiffusion_next_tpu.ops import window as jwin
from lightdiffusion_next_tpu.sampling.model_sampling import ModelSamplingDiscrete as JMSD
from lightdiffusion_next_tpu_torch.ops import nn as tnn
from lightdiffusion_next_tpu_torch.ops import window as twin
from lightdiffusion_next_tpu_torch.sampling.model_sampling import (
    ModelSamplingDiscrete as TMSD,
)


def _r(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(out, ref, tol=1e-5):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=tol, rtol=tol)


def test_linear_and_geglu():
    x, w, b = _r(0, 2, 5, 16), _r(1, 32, 16), _r(2, 32)
    _close(tnn.linear(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)),
           jnn.linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    _close(tnn.geglu(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)),
           jnn.geglu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("k,stride,padding", [(3, 1, 1), (3, 2, 1), (1, 1, 0)])
def test_conv2d_nhwc(k, stride, padding):
    x, w, b = _r(3, 2, 9, 10, 6), _r(4, k, k, 6, 8), _r(5, 8)
    ref = jnn.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                     stride=stride, padding=padding)
    out = tnn.conv2d(torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                     torch.from_numpy(b), stride=stride, padding=padding)
    _close(out, ref, 1e-4)


@pytest.mark.parametrize("groups,eps", [(4, 1e-5), (2, 1e-6)])
def test_group_norm(groups, eps):
    x, s, b = _r(6, 2, 5, 7, 8) * 3 + 1, _r(7, 8), _r(8, 8)
    _close(tnn.group_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b),
                          groups=groups, eps=eps),
           jnn.group_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                          groups=groups, eps=eps))


def test_group_norm_bf16_keeps_dtype():
    x = torch.from_numpy(_r(9, 1, 4, 4, 8)).bfloat16()
    y = tnn.group_norm(x, torch.ones(8), torch.zeros(8), groups=2)
    assert y.dtype == torch.bfloat16


def test_layer_norm_and_silu():
    x, s, b = _r(10, 3, 12) * 2, _r(11, 12), _r(12, 12)
    _close(tnn.layer_norm(torch.from_numpy(x), torch.from_numpy(s), torch.from_numpy(b)),
           jnn.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    _close(tnn.silu(torch.from_numpy(x)), jnn.silu(jnp.asarray(x)))


def test_interpolate_nearest():
    x = _r(13, 2, 3, 5, 4)
    np.testing.assert_array_equal(tnn.interpolate_nearest(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnn.interpolate_nearest(jnp.asarray(x))))


@pytest.mark.parametrize("size", [(8, 8), (4, 6), (17, 9)])
def test_interpolate_bilinear(size):
    """Down (no antialias) and up, half-pixel sample positions."""
    x = _r(14, 2, 16, 12, 3)
    _close(tnn.interpolate_bilinear(torch.from_numpy(x), size),
           jnn.interpolate_bilinear(jnp.asarray(x), size))


@pytest.mark.parametrize("hw,idx", [((8, 8), 0), ((8, 8), 3), ((16, 12), 2)])
def test_window_partition_reverse_shift(hw, idx):
    x = _r(15, 2, hw[0] * hw[1], 6)
    jshift = jwin.shift_for_index(hw, idx)
    tshift = twin.shift_for_index(hw, idx)
    assert tuple(int(s) for s in jshift) == tshift
    jp = jwin.window_partition(jnp.asarray(x), hw, jshift)
    tp = twin.window_partition(torch.from_numpy(x), hw, tshift)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    back = twin.window_reverse(tp, hw, tshift)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jwin.window_reverse(jp, hw, jshift)))


def test_odd_dim_rescale_matches_jax_nearest():
    x = _r(16, 1, 7 * 5, 3)
    ref = jwin._rescale_tokens(jnp.asarray(x), (7, 5), (8, 6))
    out = twin._rescale_tokens(torch.from_numpy(x), (7, 5), (8, 6))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    back = twin._rescale_tokens(out, (8, 6), (7, 5))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jwin._rescale_tokens(ref, (8, 6), (7, 5))))


@pytest.mark.parametrize("hw", [(8, 8), (7, 5)])
def test_msw_override_matches_jax(hw):
    """Windowed attention on a listed block (with the odd-dim rescale)."""
    heads, c = 2, 8
    q, k, v = (_r(17 + i, 2, hw[0] * hw[1], c) for i in range(3))
    block = ("input", 1)
    jo = jwin.make_msw_msa_override(shift_idx=1)(
        *(jnp.asarray(t) for t in (q, k, v)), heads, block=block, hw=hw)
    to = twin.make_msw_msa_override(shift_idx=1)(
        *(torch.from_numpy(t) for t in (q, k, v)), heads, block=block, hw=hw)
    _close(to, jo)


def test_msw_gate_and_shift_index_match_jax():
    """Bounds, shift index and gate for every timestep of the table: the
    port reads them on the host from f32 t exactly as the JAX factory
    computes them in its trace."""
    jms, tms = JMSD(), TMSD()
    jfac = jwin.make_msw_msa_factory(model_sampling=jms)
    tfac = twin.make_msw_msa_factory(model_sampling=tms)
    # the JAX factory closes over its bounds; recompute them the same way
    start = float(jms.percent_to_sigma(0.2))
    t_hi = float(jms.timestep(jnp.float32(start)))
    t_lo = float(jms.timestep(jnp.float32(max(float(jms.percent_to_sigma(1.0)), 1e-20))))
    assert tfac.bounds == (t_lo, t_hi)
    for t in (0.0, 1.0, 2.0, 3.0, 5.0, t_hi - 1, t_hi, t_hi + 1, 998.0, 999.0):
        tt = np.array([t, t], np.float32)
        idx = int(jnp.mod(jnp.floor(jnp.max(tt)).astype(jnp.int32), 4))
        active = bool(t_lo <= np.max(tt) <= t_hi)
        assert twin.msw_step_state(torch.from_numpy(tt), tfac.bounds) == (idx, active)
    assert callable(jfac)


def test_timestep_matches_jax():
    jms, tms = JMSD(), TMSD()
    sig = np.array([14.6146, 5.0, 1.0, 0.1, 0.0292], np.float32)
    np.testing.assert_array_equal(tms.timestep(torch.from_numpy(sig)).numpy(),
                                  np.asarray(jms.timestep(jnp.asarray(sig))))
    np.testing.assert_array_equal(tms.sigmas, jms.sigmas)
    assert tms.percent_to_sigma(0.2) == jms.percent_to_sigma(0.2)
