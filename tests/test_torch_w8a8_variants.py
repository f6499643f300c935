"""The W8A8 matmuls' bf16-rate variant (``int8_mxu=False``: the int8 codes
multiplied at the bf16 rate into an f32 accumulator) against the JAX
package: K7 (``w8a8_matmul``), K8 (``w8a8_matmul_stacked``) and K11
(``w8a8_matmul_ep``, with the bias, the gated residual and the stacked
``(q3, idx)`` operand), each with ``int8_mxu=False`` on both sides; the JAX
Pallas kernels run in interpret mode on the CPU, the port's wrappers take
their plain versions (the codes as f32 through ``torch.matmul``).

Tolerance: rtol = atol = 1e-4 on f32 outputs, as the JAX package's own test
of the variant (``tests/test_w8a8.py``). At these K every partial sum is an
integer below 2^24, so the f32 products are exact on both sides and the
variant also equals the port's integer default bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu.ops import ggml as jggml
from lightdiffusion_next_tpu.ops import quant_matmul as jqm
from lightdiffusion_next_tpu_torch.ops import quant_matmul as tqm
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax
from test_torch_flux import _t
from test_torch_scan import _jax_q8_stack
from test_torch_w8a8 import _w8_pair

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensor ops: one torch thread is as fast and leaves the other
    test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(rng, m, k, n, stacked):
    """The same W8A8 weight (or a stack of three) in both packages, and x."""
    if stacked:
        js = jggml.to_w8a8({"s": _jax_q8_stack(rng, k, n)})["s"]
        return js, from_jax({"s": js})["s"], rng.standard_normal((m, k)).astype(np.float32)
    jw, tw = _w8_pair(rng, k, n)
    return jw, tw, rng.standard_normal((m, k)).astype(np.float32)


@pytest.mark.parametrize("m,k,n,idx", [
    (64, 256, 128, None), (37, 512, 256, None), (1, 256, 384, None),   # K7
    (50, 384, 256, 0), (33, 256, 128, 2),                               # K8
])
def test_k7_k8_bf16_rate_match_jax(m, k, n, idx):
    rng = np.random.default_rng(m + k + n + (idx or 0))
    jw, tw, x = _operands(rng, m, k, n, idx is not None)
    if idx is None:
        ref = jqm.w8a8_matmul_2d(jnp.asarray(x), jw.qt, jw.col_scales, out_dtype=jnp.float32,
                                 interpret=True, int8_mxu=False)
        out = tqm.w8a8_matmul(_t(x), tw.q, tw.col_scales, torch.float32, int8_mxu=False)
        default = tqm.w8a8_matmul(_t(x), tw.q, tw.col_scales, torch.float32)
    else:
        ref = jqm.w8a8_matmul_stacked(jnp.asarray(x), jw.qt3, jw.col_scales3, idx,
                                      out_dtype=jnp.float32, int8_mxu=False)
        out = tqm.w8a8_matmul_stacked(_t(x), tw.q3, tw.col_scales3, idx, torch.float32,
                                      int8_mxu=False)
        default = tqm.w8a8_matmul_stacked(_t(x), tw.q3, tw.col_scales3, idx, torch.float32)
    assert out.shape == (m, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert torch.equal(out, default)


@pytest.mark.parametrize("m,k,n,gated,residual,idx", [
    (64, 256, 128, False, False, None),
    (37, 512, 256, True, False, None),     # ragged M, gate folded into the scales
    (1, 256, 384, True, True, None),       # one row, gated residual
    (33, 256, 384, True, True, 1),         # the stacked (q3, idx) operand
])
def test_k11_bf16_rate_matches_jax(m, k, n, gated, residual, idx):
    rng = np.random.default_rng(m * 7 + k + n)
    jw, tw, x = _operands(rng, m, k, n, idx is not None)
    xq, sx = jqm.quantize_rows(jnp.asarray(x))
    b = rng.standard_normal((1, n)).astype(np.float32)
    cs = np.asarray(jw.col_scales if idx is None else jw.col_scales3[idx])
    if gated:  # the caller's folds, in f32
        g = rng.standard_normal((1, n)).astype(np.float32)
        cs, b = cs * g, b * g
    r = rng.standard_normal((m, n)).astype(np.float32) if residual else None
    jq, tq = (jw.qt, tw.q) if idx is None else ((jw.qt3, idx), (tw.q3, idx))
    ref = jqm.w8a8_matmul_ep(xq, sx, jq, jnp.asarray(cs), jnp.asarray(b),
                             residual=None if r is None else jnp.asarray(r),
                             out_dtype=jnp.float32, int8_mxu=False)
    args = (_t(xq), _t(sx), tq, _t(cs), _t(b))
    tr = None if r is None else _t(r)
    out = tqm.w8a8_matmul_ep(*args, residual=tr, out_dtype=torch.float32, int8_mxu=False)
    assert out.shape == (m, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    assert torch.equal(out, tqm.w8a8_matmul_ep(*args, residual=tr, out_dtype=torch.float32))


def test_bf16_rate_launch_refuses_cpu_tensors():
    xq = torch.zeros((4, 256), dtype=torch.int8)
    q = torch.zeros((128, 256), dtype=torch.int8)
    with pytest.raises(ValueError):
        tqm._launch_w8a8(xq, torch.ones(4), q, torch.ones(128), int8_mxu=False)
    for fn in (tqm.w8a8_matmul, tqm.w8a8_matmul_stacked, tqm.w8a8_matmul_ep,
               tqm.w8a8_matmul_ep_stacked):
        assert fn.launches_bf16 == 0  # the CPU takes the plain versions
