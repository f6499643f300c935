"""K3's head-interleaved variant on the CPU: the port's plain version
(``fused_qkv_attention_plain(interleaved=True)``, which the wrapper runs on
a CPU tensor) against the JAX kernel ``fused_qkv_attention(interleaved=
True)`` in interpret mode, with and without text rows; the interleaved
input equals the proj-major input with its columns permuted; the unfused
forward's interleaved head split against JAX's.

Tolerance: K3's existing CPU test's, max |error| <= 1e-5 * max |JAX| (f32;
the interpret-mode kernel and the plain version round the same way but
sum in other orders), also for the permutation check: the same values
reach the same arithmetic, but strided views of other layouts reach the
CPU's matmul, which may sum in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu.models import flux as jflux
from lightdiffusion_next_tpu.ops import flash_attention as jfa
from lightdiffusion_next_tpu_torch.models import flux as tflux
from lightdiffusion_next_tpu_torch.ops import flash_attention as tfa
from lightdiffusion_next_tpu_torch.parallel import layout as tlayout

AXES = (16, 56, 56)


def _t(x):
    return torch.from_numpy(np.array(x))


def _case(b, l, h, extra, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, l, 3 * h * 128 + extra)).astype(np.float32)
    scales = [(1.0 + 0.3 * rng.standard_normal(128)).astype(np.float32) for _ in range(4)]
    ids = rng.integers(0, 32, (1, l, 3)).astype(np.float32)
    cos, sin = (np.asarray(a) for a in jflux.rope_cos_sin(jnp.asarray(ids), AXES))
    return qkv, scales, cos, sin


@pytest.mark.parametrize("b,l,h,txt_len,extra", [
    (1, 77, 2, 10, 0),      # odd L, text rows (a double block's joint sequence)
    (1, 130, 3, 0, 0),      # a single block's
    (2, 200, 2, 64, 128),   # trailing lanes are never read
])
def test_interleaved_plain_matches_jax(b, l, h, txt_len, extra):
    qkv, s, cos, sin = _case(b, l, h, extra, l + txt_len)
    ref = np.asarray(jfa.fused_qkv_attention(
        jnp.asarray(qkv), jnp.asarray(s[0]), jnp.asarray(s[1]), jnp.asarray(cos),
        jnp.asarray(sin), num_heads=h, txt_len=txt_len, txt_q_scale=jnp.asarray(s[2]),
        txt_k_scale=jnp.asarray(s[3]), interleaved=True))
    kw = dict(num_heads=h, txt_len=txt_len, txt_q_scale=_t(s[2]), txt_k_scale=_t(s[3]),
              interleaved=True)
    out = tfa.fused_qkv_attention_plain(_t(qkv), _t(s[0]), _t(s[1]), _t(cos), _t(sin), **kw)
    assert out.shape == (b, l, h * 128)
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    counts = tfa.fused_qkv_attention.launches, tfa.fused_qkv_attention.launches_interleaved
    wrapped = tfa.fused_qkv_attention(_t(qkv), _t(s[0]), _t(s[1]), _t(cos), _t(sin), **kw)
    assert torch.equal(wrapped, out)
    assert (tfa.fused_qkv_attention.launches,
            tfa.fused_qkv_attention.launches_interleaved) == counts


@pytest.mark.parametrize("txt_len", [0, 16])
def test_interleaved_equals_permuted_proj_major(txt_len):
    """Head h's q, k, v at 128-lane blocks 3h, 3h + 1, 3h + 2 give what
    blocks h, H + h, 2H + h give: the TP layout's interleave of the
    columns changes nothing but where the stripes are read."""
    h = 3
    qkv, s, cos, sin = _case(1, 96, h, 0, 7 + txt_len)
    perm = tlayout.qkv_interleave_perm(h, 128)
    kw = dict(num_heads=h, txt_len=txt_len, txt_q_scale=_t(s[2]), txt_k_scale=_t(s[3]))
    base = tfa.fused_qkv_attention_plain(_t(qkv), _t(s[0]), _t(s[1]), _t(cos), _t(sin), **kw)
    inter = tfa.fused_qkv_attention_plain(_t(qkv[..., perm]), _t(s[0]), _t(s[1]), _t(cos),
                                          _t(sin), interleaved=True, **kw)
    assert (inter - base).abs().max() <= 1e-5 * base.abs().max()
    wrong = tfa.fused_qkv_attention_plain(_t(qkv[..., perm]), _t(s[0]), _t(s[1]), _t(cos),
                                          _t(sin), **kw)
    assert not torch.allclose(wrong, base, atol=1e-3)


def test_split_qkv_and_split_heads_match_jax():
    rng = np.random.default_rng(3)
    qkv = rng.standard_normal((2, 5, 3 * 3 * 128)).astype(np.float32)
    for interleaved in (False, True):
        for got, ref in zip(tflux._split_heads(_t(qkv), 3, interleaved),
                            jflux._split_heads(jnp.asarray(qkv), 3, interleaved)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        for got, ref in zip(tfa.split_qkv(_t(qkv), 3, interleaved),
                            jflux._split_heads(jnp.asarray(qkv), 3, interleaved)):
            np.testing.assert_array_equal(got.transpose(1, 2).numpy(), np.asarray(ref))
