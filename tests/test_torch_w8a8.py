"""The port's W8A8 and fused-elementwise path against the JAX package: the
row quantization (``quantize_rows``, K9 in each prologue, K10), the int8
matmuls (K7, K11), the per-column requant (``to_w8a8``) and its RoPE
permutation, ``from_jax`` of a W8A8 record, the fused path's decline rules,
the tiny Flux forward with ``w8a8`` and ``fused_ew`` on and off, and the
whole tiny W8A8 slice through ``pipeline(flux_enabled=True)``.

Inputs come from a numpy seed and go through both packages; the JAX Pallas
kernels run in interpret mode on the CPU, and the port's wrappers take
their plain versions for a CPU tensor. Tolerances:

- ``quantize_rows`` and K9 "none": codes and scales exact (one law of f32
  operations on both sides);
- K9 "gelu" and "ln_mod", K10: torch's GELU against ``jax.nn.gelu`` and
  the LayerNorm's sums in another order can move a value across a rounding
  boundary: every code within 1, at most 1e-3 of the codes different,
  scales within 1e-6 relative;
- K7 and K11: the int32 accumulator is exact on both sides and the f32
  epilogue is the same sequence of operations: 1e-5 of max |ref|;
- ``to_w8a8``, the permutation and ``from_jax``: exact;
- the DiT forward and the whole slice: looser than the Q8_0 path's 1e-4
  and 1e-3. The row quantization rounds: where the two packages' f32
  operations (LayerNorm sums, GELU, attention) differ in the last bits, a
  value near a rounding boundary takes the other code, a step of 1/127 of
  its row's absmax. The matmul's error then grows as the square root of its
  input's (measured on the tiny DiT: 4.8e-6 relative RMS error into the
  first matmul, 3.0e-4 out of it; 3.4e-3 at the DiT's output). Limits:
  DiT_REL_RMSE on the forward; on the whole slice, the same FBCache hits,
  the final latent within SLICE_LATENT_REL_RMSE (measured 1.3e-3) and the
  image within 1 level.
"""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu import config as jconfig
from lightdiffusion_next_tpu.models import flux as jflux
from lightdiffusion_next_tpu.ops import ggml as jggml
from lightdiffusion_next_tpu.ops import quant_matmul as jqm
from lightdiffusion_next_tpu_torch import config as tconfig
from lightdiffusion_next_tpu_torch.models import base as tbase
from lightdiffusion_next_tpu_torch.models import flux as tflux
from lightdiffusion_next_tpu_torch.ops import ggml as tggml
from lightdiffusion_next_tpu_torch.ops import quant_matmul as tqm
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax
from test_torch_flux import (TINY, _flux_params, _jax_flux, _rel_rmse, _t,
                             _write_flux_gguf, run_flux_slice_against_jax)


DIT_REL_RMSE = 1e-2
SLICE_LATENT_REL_RMSE = 5e-3


@contextlib.contextmanager
def w8a8_config(w8a8=True, fused_ew=True):
    """Both packages' ``RuntimeConfig`` with ``w8a8`` and ``fused_ew`` set
    (and the fused attention on in both, in the JAX package the scan
    layout off, the configuration the port runs); restored after."""
    saved_j, saved_t = jconfig.get_config(), tconfig.get_config()
    jconfig.set_config(dataclasses.replace(saved_j, w8a8=w8a8, fused_ew=fused_ew,
                                           fused_attn=True, flux_scan=False))
    tconfig.set_config(dataclasses.replace(saved_t, w8a8=w8a8, fused_ew=fused_ew,
                                           fused_attn=True))
    try:
        yield
    finally:
        jconfig.set_config(saved_j)
        tconfig.set_config(saved_t)


def _assert_codes_close(codes, sx, ref_codes, ref_sx, exact=False):
    check = tqm.codes_agreement(codes, sx, _t(ref_codes), _t(ref_sx), exact=exact)
    assert codes.shape == ref_codes.shape and sx.shape == ref_sx.shape
    assert check["ok"], check


def _w8_pair(rng, k, n):
    """The same W8A8 weight in both packages: the JAX package's ``to_w8a8``
    of a Q8_0 weight, carried over by ``from_jax``."""
    w = (rng.standard_normal((n, k)) * k**-0.5).astype(np.float32)
    q, s = jggml.quantize_q8_0(w)
    jt = jggml.transpose_for_matmul(jggml.QTensor8(q=q, scales=s, shape=w.shape),
                                    device=False)
    jw = jggml.to_w8a8({"w": jt})["w"]
    return jw, from_jax({"w": jw})["w"]


# --- row quantization: quantize_rows, K9, K10 ------------------------------


@pytest.mark.parametrize("shape,scale", [((9, 256), 2.5), ((2, 3, 128), 1.0),
                                         ((64, 1024), 40.0)])
def test_quantize_rows_and_k9_none_match_jax_exactly(shape, scale):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    x[0, ..., :7] = 0.0
    ref = jqm.quantize_rows(jnp.asarray(x))
    _assert_codes_close(*tqm.quantize_rows(_t(x)), *ref, exact=True)
    kernel_ref = jqm.row_quantize_fused(jnp.asarray(x))
    codes, sx = tqm.row_quantize_fused(_t(x))
    assert codes.dtype == torch.int8 and sx.shape == shape[:-1] + (1,)
    _assert_codes_close(codes, sx, *kernel_ref, exact=True)


def test_k9_zero_rows_are_safe():
    codes, sx = tqm.row_quantize_fused(torch.zeros((4, 128)))
    assert not codes.any() and bool(torch.isfinite(sx).all())


@pytest.mark.parametrize("prologue,m,k", [("gelu", 96, 1024), ("gelu", 7, 384),
                                          ("ln_mod", 96, 1024), ("ln_mod", 6, 384)])
def test_k9_prologues_match_jax(prologue, m, k):
    rng = np.random.default_rng(m * k)
    x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    s = t = None
    if prologue == "ln_mod":
        x += 0.5  # a mean to subtract
        s = (rng.standard_normal((1, k)) * 0.3 + 1).astype(np.float32)
        t = (rng.standard_normal((1, k)) * 0.1).astype(np.float32)
    ref = jqm.row_quantize_fused(jnp.asarray(x), None if s is None else jnp.asarray(s),
                                 None if t is None else jnp.asarray(t), prologue=prologue)
    out = tqm.row_quantize_fused(_t(x), None if s is None else _t(s),
                                 None if t is None else _t(t), prologue=prologue)
    _assert_codes_close(*out, *ref)


@pytest.mark.parametrize("m,ka,kb_full,lo,hi", [
    (7, 256, 1280, 1024, 1280),   # the single block's linear2 input: the MLP tail
    (40, 128, 1024, 256, 768),    # a window that neither starts at 0 nor ends at the row
])
def test_k10_matches_jax(m, ka, kb_full, lo, hi):
    rng = np.random.default_rng(m + lo)
    a = rng.standard_normal((m, ka)).astype(np.float32)
    b = (rng.standard_normal((m, kb_full)) * 2).astype(np.float32)
    ref = jqm.row_quantize_concat_gelu(jnp.asarray(a), jnp.asarray(b), lo, hi)
    codes, sx = tqm.row_quantize_concat_gelu(_t(a), _t(b), lo, hi)
    assert codes.shape == (m, ka + hi - lo)
    _assert_codes_close(codes, sx, *ref)


# --- int8 matmuls: K7, K11 --------------------------------------------------


@pytest.mark.parametrize("m,k,n", [(64, 256, 128), (37, 512, 256), (1, 256, 384)])
def test_k7_matches_jax(m, k, n):
    rng = np.random.default_rng(m + k + n)
    jw, tw = _w8_pair(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    assert jqm.supported_w8a8(m, k, n) and tqm.supported_w8a8(m, k, n)
    ref = np.asarray(jqm.w8a8_matmul(jnp.asarray(x), jw.qt, jw.col_scales))
    out = tqm.w8a8_matmul(_t(x), tw.q, tw.col_scales).numpy()
    assert out.shape == (m, n)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    # the record's method takes the same kernel
    np.testing.assert_array_equal(tw.fused_matmul(_t(x)).numpy(), out)


@pytest.mark.parametrize("m,k,n,gated,residual", [
    (64, 256, 128, False, False),
    (37, 512, 256, True, False),     # ragged M, gate folded into the scales
    (1, 256, 384, True, True),       # one row, gated residual
    (50, 384, 128, False, True),
])
def test_k11_matches_jax(m, k, n, gated, residual):
    rng = np.random.default_rng(m * 7 + k + n)
    jw, tw = _w8_pair(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    xq, sx = jqm.quantize_rows(jnp.asarray(x))
    b = rng.standard_normal((1, n)).astype(np.float32)
    cs = np.asarray(jw.col_scales)
    if gated:  # the caller's folds, in f32
        g = rng.standard_normal((1, n)).astype(np.float32)
        cs, b = cs * g, b * g
    r = rng.standard_normal((m, n)).astype(np.float32) if residual else None
    ref = np.asarray(jqm.w8a8_matmul_ep(xq, sx, jw.qt, jnp.asarray(cs), jnp.asarray(b),
                                        residual=None if r is None else jnp.asarray(r),
                                        out_dtype=jnp.float32))
    out = tqm.w8a8_matmul_ep(_t(xq), _t(sx), tw.q, _t(cs), _t(b),
                             residual=None if r is None else _t(r),
                             out_dtype=torch.float32).numpy()
    assert out.shape == (m, n)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_k11_stacked_operand_is_not_ported():
    """The stacked ``(q3, idx)`` operand no longer raises: it is the stacked
    K11 (``tests/test_torch_scan.py`` holds it against the JAX package), and
    on block idx it equals K11 on that block."""
    rng = np.random.default_rng(16)
    q3 = torch.from_numpy(rng.integers(-127, 128, (2, 128, 256)).astype(np.int8))
    xq = torch.from_numpy(rng.integers(-127, 128, (4, 256)).astype(np.int8))
    args = (torch.ones((4, 1)), torch.full((1, 128), 1e-3), torch.zeros((1, 128)))
    out = tqm.w8a8_matmul_ep(xq, args[0], (q3, 1), *args[1:])
    assert torch.equal(out, tqm.w8a8_matmul_ep(xq, args[0], q3[1], *args[1:]))
    with pytest.raises(IndexError):
        tqm.w8a8_matmul_ep(xq, args[0], (q3, 2), *args[1:])


@pytest.mark.parametrize("prologue,gated,residual", [
    ("ln_mod", False, False), ("none", True, True), ("gelu", True, True)])
def test_modulated_matmul_matches_jax(prologue, gated, residual):
    """``QTensor8W.modulated_matmul`` (K9, the folds, K11) against the JAX
    record's, on (1, L, K) activations and (1, 1, .) vectors."""
    rng = np.random.default_rng(len(prologue) + gated + 2 * residual)
    k, n, l = 256, 384, 33
    jw, tw = _w8_pair(rng, k, n)
    x = (rng.standard_normal((1, l, k)) * 2).astype(np.float32)
    kw = {"bias": rng.standard_normal((n,)).astype(np.float32)}
    if prologue == "ln_mod":
        kw["mod_scale"] = (rng.standard_normal((1, 1, k)) * 0.2 + 1).astype(np.float32)
        kw["mod_shift"] = (rng.standard_normal((1, 1, k)) * 0.1).astype(np.float32)
    if gated:
        kw["gate"] = rng.standard_normal((1, 1, n)).astype(np.float32)
    if residual:
        kw["residual"] = rng.standard_normal((1, l, n)).astype(np.float32)
    ref = np.asarray(jw.modulated_matmul(jnp.asarray(x), prologue=prologue,
                                         **{a: jnp.asarray(v) for a, v in kw.items()}))
    out = tw.modulated_matmul(_t(x), prologue=prologue, **{a: _t(v) for a, v in kw.items()})
    assert out.shape == (1, l, n)
    assert _rel_rmse(out.numpy(), ref) <= 1e-3


def test_modulated_matmul_declines_as_jax():
    """None (the caller runs the unfused ops) for a batched gate, batched
    modulation vectors, a bias of the wrong width and K % 128 != 0."""
    rng = np.random.default_rng(11)
    jw, tw = _w8_pair(rng, 128, 128)
    x = np.ones((2, 4, 128), np.float32)
    cases = [
        dict(gate=np.ones((2, 1, 128), np.float32)),
        dict(prologue="ln_mod", mod_scale=np.ones((2, 1, 128), np.float32),
             mod_shift=np.zeros((2, 1, 128), np.float32)),
        dict(bias=np.ones((64,), np.float32)),
    ]
    for kw in cases:
        assert jw.modulated_matmul(jnp.asarray(x), **{a: v if isinstance(v, str) else
                                                      jnp.asarray(v) for a, v in kw.items()}) is None
        assert tw.modulated_matmul(_t(x), **{a: v if isinstance(v, str) else _t(v)
                                            for a, v in kw.items()}) is None
    jw96, tw96 = _w8_pair(rng, 96, 128)
    x96 = np.ones((1, 4, 96), np.float32)
    assert jw96.modulated_matmul(jnp.asarray(x96)) is None
    assert tw96.modulated_matmul(_t(x96)) is None
    # K % 128 != 0 also keeps K7 out: dequantize and matmul, as in JAX
    assert not tqm.supported_w8a8(4, 96, 128)
    ref = np.asarray(jw96.fused_matmul(jnp.asarray(x96)))
    assert np.abs(tw96.fused_matmul(_t(x96)).numpy() - ref).max() <= 1e-5 * np.abs(ref).max()


def test_launch_helpers_refuse_cpu_tensors():
    """On the CPU the wrappers take the plain versions; the launch helpers
    refuse a CPU tensor rather than fall back."""
    xq = torch.zeros((4, 128), dtype=torch.int8)
    one = torch.ones((128,))
    with pytest.raises(ValueError):
        tqm._launch_w8a8(xq, torch.ones((4,)), xq.new_zeros((128, 128)), one)
    with pytest.raises(ValueError):
        tqm._launch_rowquant(torch.zeros((4, 128), dtype=torch.bfloat16), "none",
                             None, None, 1e-6)
    with pytest.raises(ValueError):
        tqm._launch_concat(torch.zeros((4, 128), dtype=torch.bfloat16),
                           torch.zeros((4, 256), dtype=torch.bfloat16), 128, 256)


# --- records: to_w8a8, permute_rope_basis, from_jax -------------------------


def _assert_same_records(port, ref):
    assert sorted(port) == sorted(ref)
    n_w8 = 0
    for key, r in ref.items():
        o = port[key]
        if isinstance(r, jggml.QTensor8W):
            n_w8 += 1
            assert isinstance(o, tggml.QTensor8W) and o.shape == r.shape, key
            np.testing.assert_array_equal(o.q.numpy(), np.asarray(r.qt).T)
            np.testing.assert_array_equal(o.col_scales.numpy(), np.asarray(r.col_scales))
        else:
            np.testing.assert_array_equal(np.asarray(o), np.asarray(r))
    return n_w8


def test_to_w8a8_and_permutation_match_jax_exactly(tmp_path):
    """``to_w8a8`` then ``permute_rope_basis`` (the JAX loader's order),
    by hand and through ``flux_model``, gives the JAX package's records bit
    for bit; the requant frees each Q8_0 leaf from the dict it consumes."""
    cfg, params = _flux_params(12)
    path = _write_flux_gguf(tmp_path, params)
    jp, _ = _jax_flux(path, cfg, w8a8=True)
    sd = tggml.to_device_quantized(tggml.gguf_sd_loader(path), dtype=torch.float32,
                                   device="cpu")
    n_q8 = sum(isinstance(v, tggml.QTensor8T) for v in sd.values())
    converted = tggml.to_w8a8(sd)
    assert not sd  # consumed
    tp = tflux.permute_rope_basis(converted, tflux.FluxConfig(**TINY))
    assert _assert_same_records(tp, jp) == n_q8 == 10
    with w8a8_config():
        model = tbase.flux_model(tggml.gguf_sd_loader(path), cfg=tflux.FluxConfig(**TINY),
                                 device="cpu")
    _assert_same_records(model.params, jp)


def test_from_jax_carries_w8a8_records():
    rng = np.random.default_rng(13)
    jw, tw = _w8_pair(rng, 256, 128)
    assert isinstance(tw, tggml.QTensor8W) and tw.shape == jw.shape == (128, 256)
    assert tw.q.shape == (128, 256) and tw.q.is_contiguous()
    np.testing.assert_array_equal(tw.dequantize(torch.float32).numpy(),
                                  np.asarray(jw.dequantize(jnp.float32)))
    placed = tggml.to_device_quantized({"w": tw}, dtype=torch.float32, device="cpu")["w"]
    assert isinstance(placed, tggml.QTensor8W) and tggml.is_quantized(placed)


def test_runtime_config_resolves_by_device():
    cfg = tconfig.RuntimeConfig()
    assert (cfg.w8a8, cfg.fused_ew) == ("auto", "auto")
    assert not cfg.resolve_w8a8("cpu") and not cfg.resolve_fused_ew(torch.device("cpu"))
    assert cfg.resolve_w8a8("cuda") and cfg.resolve_fused_ew(torch.device("cuda"))
    pinned = tconfig.RuntimeConfig(w8a8=False, fused_ew=True)
    assert not pinned.resolve_w8a8("cuda") and pinned.resolve_fused_ew("cpu")
    with pytest.raises(ValueError):
        tconfig.RuntimeConfig(w8a8="on")


# --- the DiT forward and the whole slice -----------------------------------


@pytest.mark.parametrize("fused_ew", [True, False])
def test_apply_flux_w8a8_matches_jax(tmp_path, fused_ew):
    """The tiny DiT on W8A8 weights: with ``fused_ew`` (K9, K10, K11) and
    without it (K7 on every matmul), each against the JAX package in the
    same configuration."""
    cfg, params = _flux_params(14)
    path = _write_flux_gguf(tmp_path, params)
    rng = np.random.default_rng(15)
    x = rng.standard_normal((1, 16, 16, 16)).astype(np.float32)
    t = np.asarray([0.6], np.float32)
    ctx = rng.standard_normal((1, 64, 256)).astype(np.float32)
    y = rng.standard_normal((1, 64)).astype(np.float32)
    g = np.asarray([3.5], np.float32)
    with w8a8_config(fused_ew=fused_ew):
        jp, jcfg = _jax_flux(path, cfg, w8a8=True)
        ref = np.asarray(jflux.apply_flux(jp, jnp.asarray(x), jnp.asarray(t),
                                          jnp.asarray(ctx), jnp.asarray(y),
                                          jnp.asarray(g), cfg=jcfg))
        model = tbase.flux_model(tggml.gguf_sd_loader(path), cfg=tflux.FluxConfig(**TINY),
                                 device="cpu")
        launches = (tqm.w8a8_matmul.launches, tqm.w8a8_matmul_ep.launches)
        out = model.apply_fn(model.params, _t(x), _t(t), _t(ctx), y=_t(y),
                             guidance=_t(g)).numpy()
    assert launches == (tqm.w8a8_matmul.launches, tqm.w8a8_matmul_ep.launches)  # CPU: plain
    assert out.shape == x.shape
    assert _rel_rmse(out, ref) <= DIT_REL_RMSE


def test_flux_w8a8_slice_matches_jax_composition(tmp_path, monkeypatch):
    """pipeline(flux_enabled=True) with the DiT in W8A8 and the fused
    elementwise path on, in both packages: the same FBCache hits, the final
    latent and the image within the limits stated above."""
    with w8a8_config():
        run_flux_slice_against_jax(tmp_path, monkeypatch, w8a8=True,
                                   latent_tol=SLICE_LATENT_REL_RMSE)
