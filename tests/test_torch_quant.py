"""The port's Q8_0 layer against the JAX package: the plain version of the
dequant-matmul kernel (K5), the quantizer, the GGUF reader, the matmul
layout and the Q8_0-aware ops of ``ops/nn.py``.

Inputs come from a numpy seed and go through both packages; JAX's Pallas
kernel runs in interpret mode on the CPU. Tolerances: K5's plain version
and JAX's kernel dequantize to the same f32 weights and sum in another
order, so they agree to 1e-5 of max |ref| in f32; the quantizer, the reader
and the layouts are exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightdiffusion_next_tpu.ops import ggml as jggml
from lightdiffusion_next_tpu.ops import nn as jnn
from lightdiffusion_next_tpu.ops import quant_matmul as jqm
from lightdiffusion_next_tpu_torch.ops import ggml as tggml
from lightdiffusion_next_tpu_torch.ops import nn as tnn
from lightdiffusion_next_tpu_torch.ops import quant_matmul as tqm
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax


def _jax_qt(w):
    q, s = jggml.quantize_q8_0(w)
    return jggml.transpose_for_matmul(
        jggml.QTensor8(q=q, scales=s, shape=w.shape), device=False)


@pytest.mark.parametrize("m,k,n", [
    (64, 256, 128),
    (37, 512, 256),     # ragged M
    (1, 256, 384),      # a single row
    (300, 1280, 256),   # the tiny single block's linear2
])
def test_quant_matmul_plain_matches_jax_kernel(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * k**-0.5).astype(np.float32)
    t = _jax_qt(w)
    assert jqm.supported(m, k, n) and tqm.supported(m, k, n)
    ref = np.asarray(jqm.quant_matmul(jnp.asarray(x), jnp.asarray(t.qt),
                                      jnp.asarray(t.scales_t)))
    out = tqm.quant_matmul(torch.from_numpy(x), torch.from_numpy(t.qt),
                           torch.from_numpy(t.scales_t)).numpy()
    assert out.shape == (m, n)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("k,n", [(96, 128), (256, 200), (64, 40)])
def test_fused_matmul_fallback_matches_jax(k, n):
    """Shapes K5 does not take (K % 256 or N % 128) dequantize and multiply,
    in the port as in the JAX package."""
    rng = np.random.default_rng(k * n)
    x = rng.standard_normal((2, 5, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.1).astype(np.float32)
    t = _jax_qt(w)
    assert not tqm.supported(10, k, n)
    ref = np.asarray(t.fused_matmul(jnp.asarray(x)))
    out = from_jax({"w": t})["w"].fused_matmul(torch.from_numpy(x)).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_quantize_q8_0_is_exact():
    rng = np.random.default_rng(1)
    w = rng.standard_normal((48, 256)).astype(np.float32)
    w[3, :32] = 0.0  # an all-zero block: scale 0, codes 0
    w[5, 40] = 1e4   # one block dominated by a large value
    q, s = jggml.quantize_q8_0(w)
    tq, ts = tggml.quantize_q8_0(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), q)
    np.testing.assert_array_equal(ts.numpy(), s)


def test_matmul_layout_and_dequantize_match_jax():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((384, 512)).astype(np.float32)
    jt = _jax_qt(w)
    tt = tggml.transpose_for_matmul(tggml.quantize(torch.from_numpy(w)))
    np.testing.assert_array_equal(tt.qt.numpy(), jt.qt)
    np.testing.assert_array_equal(tt.scales_t.numpy(), jt.scales_t)
    assert tt.shape == jt.shape == (384, 512)
    np.testing.assert_array_equal(tt.dequantize(torch.float32).numpy(),
                                  np.asarray(jt.dequantize(jnp.float32)))


def test_gguf_reader_matches_jax(tmp_path):
    """A file from the JAX package's writer reads into equal arrays and
    records, through the plain and the T5 loaders."""
    rng = np.random.default_rng(3)
    tensors = {
        "enc.blk.0.attn_q.weight": rng.standard_normal((64, 128)).astype(np.float32),
        "enc.blk.0.attn_norm.weight": rng.standard_normal((128,)).astype(np.float32),
        "enc.blk.0.ffn_gate.weight": rng.standard_normal((96, 64)).astype(np.float32),
        "token_embd.weight": rng.standard_normal((10, 64)).astype(np.float32),
        "enc.output_norm.weight": rng.standard_normal((64,)).astype(np.float32),
    }
    path = str(tmp_path / "t.gguf")
    jggml.write_gguf(path, tensors, arch="t5",
                     quantize=("attn_q.weight", "ffn_gate.weight", "token_embd.weight"))
    for jload, tload in ((jggml.gguf_sd_loader, tggml.gguf_sd_loader),
                         (jggml.gguf_clip_loader, tggml.gguf_clip_loader)):
        ref, out = jload(path), tload(path)
        assert sorted(ref) == sorted(out)
        for key, r in ref.items():
            o = out[key]
            if isinstance(r, jggml.QTensor8):
                assert isinstance(o, tggml.QTensor8) and o.shape == r.shape
                np.testing.assert_array_equal(o.q.numpy(), np.asarray(r.q))
                np.testing.assert_array_equal(o.scales.numpy(), np.asarray(r.scales))
            else:
                np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    t5 = tggml.gguf_clip_loader(path)
    assert "encoder.block.0.layer.0.SelfAttention.q.weight" in t5
    assert "encoder.block.0.layer.1.DenseReluDense.wi_0.weight" in t5
    placed = tggml.to_device_quantized(t5, dtype=torch.float32, device="cpu")
    assert isinstance(placed["encoder.block.0.layer.0.SelfAttention.q.weight"],
                      tggml.QTensor8T)
    assert isinstance(placed["shared.weight"], tggml.QTensor8)  # row layout kept
    assert placed["encoder.final_layer_norm.weight"].dtype == torch.float32


def test_from_jax_carries_q8_0_records():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((128, 256)).astype(np.float32)
    q, s = jggml.quantize_q8_0(w)
    rows = jggml.QTensor8(q=q, scales=s, shape=w.shape)
    out = from_jax({"a": rows, "b": _jax_qt(w), "c": w})
    assert isinstance(out["a"], tggml.QTensor8) and out["a"].q.dtype == torch.int8
    assert isinstance(out["b"], tggml.QTensor8T) and out["b"].scales_t.dtype == torch.float32
    np.testing.assert_array_equal(out["a"].dequantize(torch.float32).numpy(),
                                  out["b"].dequantize(torch.float32).numpy())
    np.testing.assert_array_equal(out["c"].numpy(), w)


@pytest.mark.parametrize("quantized", [False, True])
def test_linear_matches_jax(quantized):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 256)).astype(np.float32)
    w = (rng.standard_normal((128, 256)) * 0.06).astype(np.float32)
    b = rng.standard_normal((128,)).astype(np.float32)
    jw = _jax_qt(w) if quantized else w
    ref = np.asarray(jnn.linear(jnp.asarray(x), jw if quantized else jnp.asarray(w),
                                jnp.asarray(b)))
    tw = from_jax({"w": jw})["w"]
    out = tnn.linear(torch.from_numpy(x), tw, torch.from_numpy(b)).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_embedding_lookup_matches_jax():
    rng = np.random.default_rng(6)
    table = rng.standard_normal((50, 64)).astype(np.float32)
    q, s = jggml.quantize_q8_0(table)
    ids = rng.integers(0, 50, (2, 9))
    jt = jggml.QTensor8(q=jnp.asarray(q), scales=jnp.asarray(s), shape=table.shape)
    tt = from_jax({"t": jggml.QTensor8(q=q, scales=s, shape=table.shape)})["t"]
    for dtype_j, dtype_t in ((jnp.float32, torch.float32), (None, None)):
        ref = np.asarray(jnn.embedding_lookup(jnp.asarray(ids), jt, dtype=dtype_j),
                         dtype=np.float32)
        out = tnn.embedding_lookup(torch.from_numpy(ids), tt, dtype=dtype_t).float().numpy()
        np.testing.assert_array_equal(out, ref)
    ref = np.asarray(jnn.embedding_lookup(jnp.asarray(ids), jnp.asarray(table)))
    out = tnn.embedding_lookup(torch.from_numpy(ids), torch.from_numpy(table)).numpy()
    np.testing.assert_array_equal(out, ref)
    with pytest.raises(TypeError):
        tnn.embedding_lookup(torch.from_numpy(ids), tggml.transpose_for_matmul(tt))


def test_rms_norm_and_gelu_match_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((4, 33)).astype(np.float32) * 3
    s = rng.standard_normal((33,)).astype(np.float32)
    np.testing.assert_allclose(
        tnn.rms_norm(torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(jnn.rms_norm(jnp.asarray(x), jnp.asarray(s))), rtol=2e-6, atol=2e-6)
    for approximate in (False, True):
        np.testing.assert_allclose(
            tnn.gelu(torch.from_numpy(x), approximate=approximate).numpy(),
            np.asarray(jnn.gelu(jnp.asarray(x), approximate=approximate)),
            rtol=2e-6, atol=2e-6)


def test_kernel_wrapper_raises_off_the_card_layouts():
    """On the CPU the wrapper takes the plain version; the launch helper
    refuses a CPU tensor rather than fall back."""
    x = torch.zeros((4, 256))
    qt = torch.zeros((256, 128), dtype=torch.int8)
    st = torch.zeros((8, 128))
    assert tqm.quant_matmul(x, qt, st).shape == (4, 128)
    with pytest.raises(ValueError):
        tqm._launch(x.bfloat16(), qt, st)
