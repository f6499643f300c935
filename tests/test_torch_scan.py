"""The port's scan layout against the JAX package and against its own
unrolled layout: the plain versions of K6, K8 and the stacked K11 at every
block of a small stack, the stacked records and their requant, the Flux
stacker's contract, the stacked Flux forward (Q8_0, W8A8 with ``fused_ew``
on and off), T5's scan layout, ``from_jax`` of stacked dicts, the
``flux_scan`` switch, and the tiny Flux slice with ``flux_scan`` on through
``pipeline()``.

Inputs come from a numpy seed and go through both packages; JAX's Pallas
kernels run in interpret mode on the CPU. Widths keep what the kernels
need: head dim 128, K and N multiples of 256 and 128. Tolerances:

- K6, K8 and the stacked K11 against JAX: those of their unstacked
  counterparts (K5, K7, K11), 1e-5 of max |ref| (f32, another summation
  order for K6; the same f32 epilogue for K8 and K11);
- the stacked layout against the port's unrolled one, forward and T5
  encode: ``torch.equal`` (the same kernels and the same arithmetic read
  the same weights from another place), and the stacked requant against
  the unstacked: equal bit for bit, as the JAX package states;
- the stacked forward against the JAX stacked forward on ``from_jax``
  weights: the unrolled tests' limits, 1e-4 relative RMS error on Q8_0
  (``test_torch_flux.py``) and 1e-2 on W8A8 (``test_torch_w8a8.py``); T5:
  1e-4 (``test_torch_t5.py``);
- the slice: the W8A8 slice's limits (``test_torch_w8a8.py``): the same
  FBCache hits, the final latent within 5e-3, the image within 1 level.
"""

import dataclasses
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu.models import flux as jflux
from lightdiffusion_next_tpu.models.clip import t5 as jt5
from lightdiffusion_next_tpu.ops import ggml as jggml
from lightdiffusion_next_tpu.ops import quant_matmul as jqm
from lightdiffusion_next_tpu_torch import config as tconfig
from lightdiffusion_next_tpu_torch.models import base as tbase
from lightdiffusion_next_tpu_torch.models import flux as tflux
from lightdiffusion_next_tpu_torch.models.clip import t5 as tt5
from lightdiffusion_next_tpu_torch.models.clip import t5_tokenizer as ttok
from lightdiffusion_next_tpu_torch.ops import ggml as tggml
from lightdiffusion_next_tpu_torch.ops import nn as tnn
from lightdiffusion_next_tpu_torch.ops import quant_matmul as tqm
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax
from test_torch_flux import (TINY, _flux_params, _jax_flux, _rel_rmse, _t,
                             _write_flux_gguf, run_flux_slice_against_jax)
from test_torch_t5 import TINY as T5_TINY
from test_torch_t5 import _t5_gguf
from test_torch_w8a8 import DIT_REL_RMSE, SLICE_LATENT_REL_RMSE, w8a8_config

DEPTH = 3  # blocks of the small stacks


@pytest.fixture
def port_config():
    """The port's ``RuntimeConfig`` with the fields given and the fused
    attention pinned on (the JAX forwards held against are fused); restored
    after the test."""
    saved = tconfig.get_config()
    yield lambda **kw: tconfig.set_config(dataclasses.replace(saved, **{"fused_attn": True,
                                                                       **kw}))
    tconfig.set_config(saved)


def _jax_q8_stack(rng, k, n, depth=DEPTH):
    """A JAX ``StackedQTensor8T`` of ``depth`` Q8_0 weights (N, K)."""
    leaves = []
    for _ in range(depth):
        w = (rng.standard_normal((n, k)) * k**-0.5).astype(np.float32)
        q, s = jggml.quantize_q8_0(w)
        leaves.append(jggml.transpose_for_matmul(jggml.QTensor8(q=q, scales=s, shape=w.shape),
                                                 device=False))
    return jggml.stack_leaves(leaves)


def _close(out, ref, rel=1e-5):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= rel * np.abs(ref).max()


# --- the kernels' plain versions: K6, K8, the stacked K11 -------------------


@pytest.mark.parametrize("idx", range(DEPTH))
def test_k6_plain_matches_jax_at_every_block(idx):
    rng = np.random.default_rng(40)
    m, k, n = 37, 512, 256
    js = _jax_q8_stack(rng, k, n)
    ts = from_jax({"s": js})["s"]
    assert isinstance(ts, tggml.StackedQTensor8T) and ts.qt3.shape == (DEPTH, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    ref = jqm.quant_matmul_stacked(jnp.asarray(x), js.qt3, js.scales3, idx)
    out = tqm.quant_matmul_stacked(_t(x), ts.qt3, ts.scales3, idx)
    _close(out.numpy(), ref)
    # the record's view takes the same path and equals K5's on the block
    np.testing.assert_array_equal(ts.at_index(idx).fused_matmul(_t(x)).numpy(), out.numpy())
    np.testing.assert_array_equal(
        tqm.quant_matmul(_t(x), ts.qt3[idx], ts.scales3[idx]).numpy(), out.numpy())


@pytest.mark.parametrize("idx", range(DEPTH))
def test_k8_plain_matches_jax_at_every_block(idx):
    rng = np.random.default_rng(41)
    m, k, n = 50, 384, 256
    js = jggml.to_w8a8({"s": _jax_q8_stack(rng, k, n)})["s"]
    ts = from_jax({"s": js})["s"]
    assert isinstance(ts, tggml.StackedQTensor8W) and ts.q3.shape == (DEPTH, n, k)
    assert ts.q3.is_contiguous() and ts.col_scales3.shape == (DEPTH, 1, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    ref = jqm.w8a8_matmul_stacked(jnp.asarray(x), js.qt3, js.col_scales3, idx)
    out = tqm.w8a8_matmul_stacked(_t(x), ts.q3, ts.col_scales3, idx)
    _close(out.numpy(), ref)
    np.testing.assert_array_equal(ts.at_index(idx).fused_matmul(_t(x)).numpy(), out.numpy())


@pytest.mark.parametrize("idx", range(DEPTH))
@pytest.mark.parametrize("residual", [False, True])
def test_stacked_k11_plain_matches_jax_at_every_block(idx, residual):
    rng = np.random.default_rng(42 + residual)
    m, k, n = 33, 256, 384
    js = jggml.to_w8a8({"s": _jax_q8_stack(rng, k, n)})["s"]
    ts = from_jax({"s": js})["s"]
    x = rng.standard_normal((m, k)).astype(np.float32)
    xq, sx = jqm.quantize_rows(jnp.asarray(x))
    g = rng.standard_normal((1, n)).astype(np.float32)
    cs = np.asarray(js.col_scales3[idx]) * g
    b = rng.standard_normal((1, n)).astype(np.float32) * g
    r = rng.standard_normal((m, n)).astype(np.float32) if residual else None
    ref = jqm.w8a8_matmul_ep(xq, sx, (js.qt3, idx), jnp.asarray(cs), jnp.asarray(b),
                             residual=None if r is None else jnp.asarray(r),
                             out_dtype=jnp.float32)
    args = (_t(xq), _t(sx), (ts.q3, idx), _t(cs), _t(b))
    out = tqm.w8a8_matmul_ep(*args, residual=None if r is None else _t(r),
                             out_dtype=torch.float32)
    _close(out.numpy(), ref)
    # the stacked K11 on block idx equals the unstacked K11 on that block
    unstacked = tqm.w8a8_matmul_ep(_t(xq), _t(sx), ts.q3[idx], _t(cs), _t(b),
                                   residual=None if r is None else _t(r),
                                   out_dtype=torch.float32)
    assert torch.equal(out, unstacked)


def test_stacked_modulated_matmul_matches_jax():
    """``_StackedSlice8W.modulated_matmul`` (K9 "ln_mod", the folds, the
    stacked K11) against the JAX slice's, and bit for bit against the
    unstacked record's on the same block."""
    rng = np.random.default_rng(44)
    k, n, l, idx = 256, 384, 21, 2
    js = jggml.to_w8a8({"s": _jax_q8_stack(rng, k, n)})["s"]
    ts = from_jax({"s": js})["s"]
    x = (rng.standard_normal((1, l, k)) * 2).astype(np.float32)
    kw = {"bias": rng.standard_normal((n,)).astype(np.float32),
          "mod_scale": (rng.standard_normal((1, 1, k)) * 0.2 + 1).astype(np.float32),
          "mod_shift": (rng.standard_normal((1, 1, k)) * 0.1).astype(np.float32)}
    ref = js.at_index(idx).modulated_matmul(jnp.asarray(x), prologue="ln_mod",
                                            **{a: jnp.asarray(v) for a, v in kw.items()})
    out = ts.at_index(idx).modulated_matmul(_t(x), prologue="ln_mod",
                                            **{a: _t(v) for a, v in kw.items()})
    assert _rel_rmse(out.numpy(), ref) <= 1e-3
    block = tggml.QTensor8W(ts.q3[idx], ts.col_scales3[idx], ts.shape)
    assert torch.equal(out, block.modulated_matmul(_t(x), prologue="ln_mod",
                                                   **{a: _t(v) for a, v in kw.items()}))


def test_stacked_slices_fall_back_where_the_kernels_decline():
    """K not a multiple of 256 (K6) or 128 (K8): dequantize block idx and
    ``torch.matmul``, as the JAX slices do."""
    rng = np.random.default_rng(45)
    q8 = from_jax({"s": _jax_q8_stack(rng, 96, 128)})["s"]
    x = _t(rng.standard_normal((4, 96)).astype(np.float32))
    assert not tqm.supported(4, 96, 128)
    ref = torch.matmul(x, q8.at_index(1).dequantize(torch.float32).t())
    assert torch.equal(q8.at_index(1).fused_matmul(x), ref)
    w8 = tggml.to_w8a8({"s": q8})["s"]
    assert w8.at_index(1).modulated_matmul(x[None]) is None
    ref = torch.matmul(x, w8.at_index(1).dequantize(torch.float32).t())
    assert torch.equal(w8.at_index(1).fused_matmul(x), ref)


# --- records: stacking, requant, from_jax -----------------------------------


def test_stacked_requant_equals_unstacked_and_jax():
    """``to_w8a8`` of a Q8_0 stack requantizes each block exactly as
    ``requant_col`` requantizes it on its own, and as the JAX package's
    stacked requant does."""
    rng = np.random.default_rng(46)
    js = _jax_q8_stack(rng, 512, 256)
    ts = from_jax({"s": js})["s"]
    blocks = [tggml.requant_col(tggml.QTensor8T(ts.qt3[i], ts.scales3[i], ts.shape))
              for i in range(DEPTH)]
    src = {"s": ts}
    w8 = tggml.to_w8a8(src)["s"]
    assert not src  # consumed
    assert isinstance(w8, tggml.StackedQTensor8W) and w8.shape == (256, 512)
    assert torch.equal(w8.q3, torch.stack([b.q for b in blocks]))
    assert torch.equal(w8.col_scales3, torch.stack([b.col_scales for b in blocks]))
    jw8 = from_jax({"s": jggml.to_w8a8({"s": js})["s"]})["s"]
    assert torch.equal(w8.q3, jw8.q3) and torch.equal(w8.col_scales3, jw8.col_scales3)


def test_stack_leaves_and_views():
    """Stacks of each kind, and the views ``StackView`` hands out: a dense
    stacked leaf gives ``leaf[idx]``, a view of the stack's memory."""
    rng = np.random.default_rng(47)
    dense = [_t(rng.standard_normal((4, 6)).astype(np.float32)) for _ in range(DEPTH)]
    stack = tggml.stack_leaves(dense)
    view = tnn.StackView({"w": stack, "x.y": stack}, 1)
    assert torch.equal(view("w"), dense[1]) and view("w").data_ptr() != dense[1].data_ptr()
    assert view("w").untyped_storage().data_ptr() == stack.untyped_storage().data_ptr()
    assert view.scope("x.")("y") is not None and view.get("missing") is None
    q8 = from_jax({"s": _jax_q8_stack(rng, 256, 128)})["s"]
    assert isinstance(tnn.StackView({"q": q8}, 2)("q"), tggml._StackedSlice8T)
    with pytest.raises(ValueError, match="non-uniform"):
        tggml.stack_leaves(dense[:2] + [dense[2][:3]])
    with pytest.raises(ValueError, match="non-uniform"):
        tggml.check_stackable([tggml.QTensor8T(q8.qt3[0], q8.scales3[0], q8.shape), dense[0]])
    with pytest.raises(ValueError, match="cannot stack"):
        tggml.check_stackable([q8, q8])


def _tiny_flux(seed, depth=2, single=3):
    """A tiny Flux config and its Q8_0 params in the port's records, from the
    JAX package's init_params (via its GGUF writer and the port's reader)."""
    cfg = tflux.FluxConfig(**{**TINY, "depth": depth, "depth_single_blocks": single})
    params = tflux.init_params(cfg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for k in params:
        if k.endswith("norm.scale"):
            params[k] = (1.0 + 0.3 * rng.standard_normal(params[k].shape)).astype(np.float32)
        elif k.endswith(".bias"):
            params[k] = (0.05 * rng.standard_normal(params[k].shape)).astype(np.float32)
    return cfg, params


def _placed(params, cfg):
    sd = {k: tggml.transpose_for_matmul(tggml.quantize(_t(v)))
          if k.endswith(tflux.Q8_0_SUFFIXES) else _t(v) for k, v in params.items()}
    return tflux.permute_rope_basis(sd, dataclasses.replace(cfg, fused_attn=True))


def test_stack_block_params_contract():
    """Validates every family before it consumes anything, refuses ragged
    and non-uniform families with ``params`` untouched, consumes its input,
    and leaves ``permute_rope_basis`` refusing the stacked dict."""
    cfg, params = _tiny_flux(50)
    sd = _placed(params, cfg)
    n_keys = len(sd)
    ragged = {k: v for k, v in sd.items() if k != "single_blocks.2.linear2.bias"}
    with pytest.raises(ValueError, match="linear2.bias"):
        tflux.stack_block_params(ragged, cfg)
    assert len(ragged) == n_keys - 1  # untouched
    mixed = dict(sd)
    w = mixed["double_blocks.1.img_mlp.0.weight"]
    mixed["double_blocks.1.img_mlp.0.weight"] = w.dequantize(torch.float32)
    with pytest.raises(ValueError, match="non-uniform"):
        tflux.stack_block_params(mixed, cfg)
    assert len(mixed) == n_keys
    stacked = tflux.stack_block_params(sd, cfg)
    assert not sd  # consumed
    assert tflux.is_stacked(stacked)
    ds, ss = stacked[tflux.DOUBLE_STACK_KEY], stacked[tflux.SINGLE_STACK_KEY]
    assert ds["img_attn.qkv.weight"].qt3.shape[0] == 2 and ss["linear1.weight"].qt3.shape[0] == 3
    assert ss["norm.key_norm.scale"].shape == (3, 128)
    assert "img_in.weight" in stacked and not any(k.startswith("double_blocks.") for k in stacked)
    with pytest.raises(ValueError, match="permute before stacking"):
        tflux.permute_rope_basis(stacked, dataclasses.replace(cfg, fused_attn=True))
    with pytest.raises(ValueError, match="stacked already"):
        tflux.stack_block_params(stacked, cfg)


def test_stackers_free_each_family_before_the_next(monkeypatch, tmp_path):
    """Extra memory peaks at one family's stack: when a family stacks, the
    per-block leaves of every family stacked before it are freed (nothing
    holds them), in the Flux and the T5 stacker."""
    real = tggml.stack_leaves
    done = []

    def watching(leaves):
        assert all(ref() is None for ref in done), "a stacked family's leaves are still held"
        out = real(leaves)
        done.extend(weakref.ref(leaf.qt if isinstance(leaf, tggml.QTensor8T) else leaf)
                    for leaf in leaves)
        return out

    monkeypatch.setattr(tggml, "stack_leaves", watching)
    cfg, params = _tiny_flux(55)
    stacked = tflux.stack_block_params(_placed(params, cfg), cfg)
    assert len(done) == 2 * len(stacked[tflux.DOUBLE_STACK_KEY]) + 3 * len(
        stacked[tflux.SINGLE_STACK_KEY])
    done.clear()
    sd = tggml.to_device_quantized(tggml.gguf_clip_loader(_t5_gguf(tmp_path)),
                                   dtype=torch.float32, device="cpu")
    tt5.stack_t5_block_params(sd, tt5.T5Config(**T5_TINY))
    assert done


def test_runtime_config_flux_scan():
    cfg = tconfig.RuntimeConfig()
    assert cfg.flux_scan == "auto" and cfg.sage_attention is False
    assert not cfg.resolve_flux_scan("cpu") and cfg.resolve_flux_scan(torch.device("cuda"))
    assert tconfig.RuntimeConfig(flux_scan=True).resolve_flux_scan("cpu")
    assert not tconfig.RuntimeConfig(flux_scan=False).resolve_flux_scan("cuda")
    with pytest.raises(ValueError, match="flux_scan"):
        tconfig.RuntimeConfig(flux_scan="on")


# --- the stacked Flux forward ------------------------------------------------


def _flux_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, 16, 16, 16)).astype(np.float32)
    t = np.asarray([0.6], np.float32)
    ctx = rng.standard_normal((1, 64, 256)).astype(np.float32)
    y = rng.standard_normal((1, 64)).astype(np.float32)
    g = np.asarray([3.5], np.float32)
    return x, t, ctx, y, g


@pytest.mark.parametrize("w8a8,fused_ew", [(False, False), (True, True), (True, False)])
def test_stacked_forward_equals_unrolled(port_config, w8a8, fused_ew):
    """``flux_model`` with ``flux_scan`` on and off on the same weights: the
    forward is the same bit for bit, and FBCache's hook sees the same block
    0 output."""
    cfg, params = _tiny_flux(51)
    x, t, ctx, y, g = (_t(a) for a in _flux_inputs(52))
    outs, firsts = [], []

    def hook(prev, first, run_rest):
        firsts.append(first)
        return run_rest(first)

    for scan in (False, True):
        port_config(w8a8=w8a8, fused_ew=fused_ew, flux_scan=scan)
        sd = {k: tggml.transpose_for_matmul(tggml.quantize(_t(v)))
              if k.endswith(tflux.Q8_0_SUFFIXES) else _t(v) for k, v in params.items()}
        model = tbase.flux_model(sd, cfg=cfg, device="cpu")
        assert tflux.is_stacked(model.params) == scan
        kind = tggml.StackedQTensor8W if w8a8 else tggml.StackedQTensor8T
        if scan:
            assert isinstance(model.params[tflux.SINGLE_STACK_KEY]["linear1.weight"], kind)
        outs.append(model.apply_fn(model.params, x, t, ctx, y=y, guidance=g,
                                   first_block_hook=hook))
    assert torch.equal(outs[0], outs[1])
    assert firsts[0].shape == (1, 64, 256) and torch.equal(firsts[0], firsts[1])


@pytest.mark.parametrize("w8a8,fused_ew", [(False, False), (True, True), (True, False)])
def test_stacked_forward_matches_jax_stacked(tmp_path, w8a8, fused_ew):
    """The port's stacked forward on ``from_jax`` of the JAX package's
    stacked params (requant, permute, stack: its loader's order) against
    the JAX stacked forward, with the FBCache hook."""
    cfg, params = _flux_params(53)
    path = _write_flux_gguf(tmp_path, params)
    x, t, ctx, y, g = _flux_inputs(54)
    with w8a8_config(w8a8=w8a8, fused_ew=fused_ew):
        jp, jcfg = _jax_flux(path, cfg, w8a8=w8a8)
        jp = jflux.stack_block_params(jp, jcfg)
        assert jflux.is_stacked(jp)
        ref = np.asarray(jflux.apply_flux(jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                                          jnp.asarray(y), jnp.asarray(g), cfg=jcfg))
        tp = from_jax(jp)
        kind = tggml.StackedQTensor8W if w8a8 else tggml.StackedQTensor8T
        assert isinstance(tp[tflux.DOUBLE_STACK_KEY]["img_attn.qkv.weight"], kind)
        seen = []

        def hook(prev, first, run_rest):
            seen.append(first.shape)
            return run_rest(first)

        tcfg = tflux.FluxConfig(**TINY, fused_attn=True)
        out = tflux.apply_flux(tp, _t(x), _t(t), _t(ctx), _t(y), guidance=_t(g), cfg=tcfg,
                               first_block_hook=hook).numpy()
    assert seen == [(1, 64, 256)]
    assert _rel_rmse(out, ref) <= (DIT_REL_RMSE if w8a8 else 1e-4)


# --- T5 in the scan layout ---------------------------------------------------


def test_t5_scan_matches_jax_and_unrolled(tmp_path, port_config):
    """The scan-layout encoder against the JAX package's scan encoder and
    bit for bit against the port's unrolled encoder, with an intermediate
    output; ``scan_blocks`` follows ``flux_scan`` by default; ``from_jax``
    carries the JAX stacked dict across."""
    path = _t5_gguf(tmp_path)
    jsd = jggml.to_device_quantized(jggml.gguf_clip_loader(path), dtype=jnp.float32)
    jmodel = jt5.T5XXLModel(jsd, cfg=jt5.detect_config(jsd), compute_dtype=jnp.float32,
                            scan_blocks=True)
    assert jt5.is_stacked(jmodel.params)
    port_config(flux_scan=True)
    scan = tt5.T5XXLModel(tggml.gguf_clip_loader(path), device="cpu")
    port_config(flux_scan="auto")
    flat = tt5.T5XXLModel(tggml.gguf_clip_loader(path), device="cpu")
    assert tt5.is_stacked(scan.params) and not tt5.is_stacked(flat.params)
    assert scan.cfg == flat.cfg == tt5.T5Config(**{**T5_TINY, "relative_num_buckets": 32})
    stack = scan.params[tt5.T5_STACK_KEY]
    assert isinstance(stack["layer.1.DenseReluDense.wo.weight"], tggml.StackedQTensor8T)
    assert tt5._BIAS_KEY in scan.params and isinstance(scan.params["shared.weight"],
                                                       tggml.QTensor8)
    rows = [ttok.flux_t5_tokenize("a castle on a hill, fine details")]
    ref, _ = jmodel.encode_token_weights(rows)
    out, _ = scan.encode_token_weights(rows)
    assert torch.equal(out, flat.encode_token_weights(rows)[0])
    assert _rel_rmse(out.numpy(), ref) <= 1e-4
    tokens = torch.tensor([[int(a[0]) for a in rows[0]]])
    for params in (scan.params, flat.params, from_jax(jmodel.params)):
        x, inter, _ = tt5.apply_t5(params, tokens, intermediate_output=0, cfg=scan.cfg)
        if params is scan.params:
            first = (x, inter)
        else:
            assert inter is not None and _rel_rmse(inter.numpy(), first[1].numpy()) <= 1e-4
            assert _rel_rmse(x.numpy(), first[0].numpy()) <= 1e-4
    assert tt5.detect_config(from_jax(jmodel.params)) == scan.cfg


def test_t5_stacker_refuses_ragged_families(tmp_path):
    path = _t5_gguf(tmp_path)
    sd = tggml.to_device_quantized(tggml.gguf_clip_loader(path), dtype=torch.float32,
                                   device="cpu")
    del sd["encoder.block.1.layer.1.layer_norm.weight"]
    n = len(sd)
    with pytest.raises(ValueError, match="layer.1.layer_norm"):
        tt5.stack_t5_block_params(sd, tt5.T5Config(**T5_TINY))
    assert len(sd) == n


# --- the whole slice ---------------------------------------------------------


def test_flux_scan_slice_matches_jax_composition(tmp_path, monkeypatch, port_config):
    """pipeline(flux_enabled=True) with the JAX package's accelerator
    default, ``w8a8``, ``fused_ew`` and ``flux_scan`` on, in both packages:
    the DiT and T5 in the scan layout on both sides."""
    with w8a8_config():
        port_config(w8a8=True, fused_ew=True, flux_scan=True)
        run_flux_slice_against_jax(tmp_path, monkeypatch, w8a8=True,
                                   latent_tol=SLICE_LATENT_REL_RMSE, scan=True)
