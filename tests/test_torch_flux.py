"""The port's Flux slice against the JAX package: the plain version of the
fused-prologue attention (K3), the RoPE basis permutation and tables, the
Flux DiT forward on Q8_0 weights, the Flux schedule and parameterization,
the dy Euler sampler, FBCache, and the whole tiny Flux txt2img slice from
the tokenizers to the decoded image.

Inputs come from a numpy seed and go through both packages; JAX's Pallas
kernels run in interpret mode on the CPU. Widths are small but keep what
the kernels need: head dim 128, K and N multiples of 256 and 128.
Tolerances: K3's plain version and JAX's kernel agree to 1e-5 of max |ref|
(f32 on both sides, another summation order); index shuffles and the
schedules are exact; cos/sin agree to f32 rounding; the DiT forward to a
relative RMS error of 1e-4; the whole slice (20 steps) to 1e-3 on the
final latent, with the same FBCache hits and misses.
"""

import contextlib
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu.models import base as jbase
from lightdiffusion_next_tpu.models import flux as jflux
from lightdiffusion_next_tpu.models import vae as jvae
from lightdiffusion_next_tpu.models.clip import t5 as jt5
from lightdiffusion_next_tpu.models.clip import text_encoder as jte
from lightdiffusion_next_tpu.ops import flash_attention as jfa
from lightdiffusion_next_tpu.ops import ggml as jggml
from lightdiffusion_next_tpu.pipelines import pipeline as jpipe
from lightdiffusion_next_tpu.sampling import fbcache as jfb
from lightdiffusion_next_tpu.sampling import ksampler as jks
from lightdiffusion_next_tpu.sampling import model_sampling as jms
from lightdiffusion_next_tpu.sampling import samplers as jsamp
from lightdiffusion_next_tpu.sampling import schedules as jsched
from lightdiffusion_next_tpu.utils import image as jimage
from lightdiffusion_next_tpu.utils import latent as jlatent
from lightdiffusion_next_tpu_torch import config as tconfig
from lightdiffusion_next_tpu_torch.models import base as tbase
from lightdiffusion_next_tpu_torch.models import flux as tflux
from lightdiffusion_next_tpu_torch.models import vae as tvae
from lightdiffusion_next_tpu_torch.models.clip import t5 as tt5
from lightdiffusion_next_tpu_torch.models.clip import text_encoder as tte
from lightdiffusion_next_tpu_torch.ops import flash_attention as tfa
from lightdiffusion_next_tpu_torch.ops import ggml as tggml
from lightdiffusion_next_tpu_torch.pipelines import pipeline as tpipe
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax
from lightdiffusion_next_tpu_torch.sampling import fbcache as tfb
from lightdiffusion_next_tpu_torch.sampling import model_sampling as tms
from lightdiffusion_next_tpu_torch.sampling import samplers as tsamp
from lightdiffusion_next_tpu_torch.sampling import schedules as tsched

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = (16, 56, 56)
TINY = dict(hidden_size=256, num_heads=2, depth=1, depth_single_blocks=1,
            context_in_dim=256, vec_in_dim=64, axes_dim=AXES)
T5_TINY = dict(d_model=256, d_ff=512, num_heads=4, num_layers=2, vocab_size=32128)
SEED = 20261016


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel_rmse(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    return float(np.sqrt(np.mean((out - ref) ** 2) / np.mean(ref**2)))


def _flux_params(seed):
    """JAX init_params with unequal QKNorm scales and non-zero biases, so a
    wrong permutation of either shows."""
    cfg = jflux.FluxConfig(**TINY)
    params = jflux.init_params(cfg, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for k in params:
        if k.endswith("norm.scale"):
            params[k] = (1.0 + 0.3 * rng.standard_normal(params[k].shape)).astype(np.float32)
        elif k.endswith(".bias"):
            params[k] = (0.05 * rng.standard_normal(params[k].shape)).astype(np.float32)
    return cfg, params


@contextlib.contextmanager
def fused_attn_on():
    """The port's ``RuntimeConfig`` with ``fused_attn`` pinned on, restored
    after: on the CPU "auto" builds the unfused attention, and these tests
    hold the port's fused path (K3's plain version, the permuted basis) to
    the JAX package's."""
    saved = tconfig.get_config()
    tconfig.set_config(dataclasses.replace(saved, fused_attn=True))
    try:
        yield
    finally:
        tconfig.set_config(saved)


def _jax_flux(path, cfg, w8a8=False):
    """The JAX package's unrolled fused-attention Flux on Q8_0 weights read
    from ``path`` (requantized to W8A8 with ``w8a8``), f32 compute."""
    sd = jggml.to_device_quantized(jggml.gguf_sd_loader(path), dtype=jnp.float32)
    if w8a8:
        sd = jggml.to_w8a8(sd)
    cfg = dataclasses.replace(cfg, fused_attn=True)
    return jflux.permute_rope_basis(sd, cfg), cfg


def _write_flux_gguf(tmp_path, params):
    path = str(tmp_path / "flux.gguf")
    jggml.write_gguf(path, params, arch="flux", quantize=tflux.Q8_0_SUFFIXES)
    return path


# --- K3 ---------------------------------------------------------------------


@pytest.mark.parametrize("b,l,h,txt_len,extra", [
    (1, 77, 2, 10, 64),     # odd L, text rows, trailing lanes (single blocks' MLP)
    (1, 130, 1, 0, 0),
    (2, 200, 2, 64, 256),
])
def test_fused_qkv_attention_plain_matches_jax(b, l, h, txt_len, extra):
    rng = np.random.default_rng(l + txt_len)
    qkv = rng.standard_normal((b, l, 3 * h * 128 + extra)).astype(np.float32)
    scales = [(1.0 + 0.3 * rng.standard_normal(128)).astype(np.float32) for _ in range(4)]
    ids = rng.integers(0, 32, (1, l, 3)).astype(np.float32)
    cos, sin = (np.asarray(a) for a in jflux.rope_cos_sin(jnp.asarray(ids), AXES))
    ref = np.asarray(jfa.fused_qkv_attention(
        jnp.asarray(qkv), *(jnp.asarray(s) for s in scales[:2]), jnp.asarray(cos),
        jnp.asarray(sin), num_heads=h, txt_len=txt_len,
        txt_q_scale=jnp.asarray(scales[2]), txt_k_scale=jnp.asarray(scales[3])))
    out = tfa.fused_qkv_attention(
        _t(qkv), *(_t(s) for s in scales[:2]), _t(cos), _t(sin), num_heads=h,
        txt_len=txt_len, txt_q_scale=_t(scales[2]), txt_k_scale=_t(scales[3])).numpy()
    assert out.shape == (b, l, h * 128)
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()


def test_rope_tables_and_permutation_match_jax():
    rng = np.random.default_rng(0)
    ids = np.concatenate([np.zeros((1, 16, 3), np.float32),
                          np.asarray(jflux.img_ids(1, 16, 24))], axis=1)
    jc, js = jflux.rope_cos_sin(jnp.asarray(ids), AXES)
    tc, ts = tflux.rope_cos_sin(_t(ids), AXES)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tflux.rope_pair_permutation(128),
                                  jflux.rope_pair_permutation(128))
    np.testing.assert_array_equal(tflux._qk_out_index(1792, 256, 128),
                                  jflux._qk_out_index(1792, 256, 128))
    np.testing.assert_array_equal(tflux.img_ids(2, 16, 24).numpy(),
                                  np.asarray(jflux.img_ids(2, 16, 24)))
    x = rng.standard_normal((2, 16, 24, 16)).astype(np.float32)
    tok = tflux.patchify(_t(x))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jflux.patchify(jnp.asarray(x))))
    np.testing.assert_array_equal(tflux.unpatchify(tok, 16, 24).numpy(), x)


def test_permute_rope_basis_matches_jax(tmp_path):
    cfg, params = _flux_params(1)
    jp, jcfg = _jax_flux(_write_flux_gguf(tmp_path, params), cfg)
    sd = tggml.to_device_quantized(tggml.gguf_sd_loader(str(tmp_path / "flux.gguf")),
                                   dtype=torch.float32, device="cpu")
    tp = tflux.permute_rope_basis(sd, tflux.FluxConfig(**TINY))
    assert sorted(tp) == sorted(jp)
    for key, ref in jp.items():
        out = tp[key]
        if isinstance(ref, jggml.QTensor8T):
            np.testing.assert_array_equal(out.qt.numpy(), np.asarray(ref.qt))
            np.testing.assert_array_equal(out.scales_t.numpy(), np.asarray(ref.scales_t))
        else:
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_apply_flux_matches_jax(tmp_path):
    """The DiT forward with fused attention on Q8_0 weights, with the
    FBCache boundary hook passing through."""
    cfg, params = _flux_params(2)
    path = _write_flux_gguf(tmp_path, params)
    jp, jcfg = _jax_flux(path, cfg)
    with fused_attn_on():
        model = tbase.flux_model(tggml.gguf_sd_loader(path), cfg=tflux.FluxConfig(**TINY),
                                 device="cpu")
    assert model.config.fused_attn and model.model_type == "flux"
    assert model.model_options["fbcache"] == tfb.FBCacheConfig(0.120)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 16, 16, 16)).astype(np.float32)
    t = np.asarray([0.7], np.float32)
    ctx = rng.standard_normal((1, 64, 256)).astype(np.float32)
    y = rng.standard_normal((1, 64)).astype(np.float32)
    g = np.asarray([3.0], np.float32)
    ref = np.asarray(jflux.apply_flux(jp, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx),
                                      jnp.asarray(y), jnp.asarray(g), cfg=jcfg))
    seen = []

    def hook(prev, first, run_rest):
        seen.append(first.shape)
        return run_rest(first)

    out = model.apply_fn(model.params, _t(x), _t(t), _t(ctx), y=_t(y), guidance=_t(g),
                         first_block_hook=hook).numpy()
    assert seen == [(1, 64, 256)]
    assert out.shape == x.shape
    assert _rel_rmse(out, ref) <= 1e-4


def test_random_params_layout():
    """The seeded builder for the card draws what init_params lays out,
    with the Q8_0 set quantized in the matmul layout."""
    cfg = tflux.FluxConfig(**TINY)
    p = tflux.random_params(cfg, seed=0, device="cpu", dtype=torch.float32)
    ref = tflux.init_params(cfg, seed=0)
    assert sorted(p) == sorted(ref)
    for k, v in ref.items():
        assert tuple(p[k].shape) == v.shape, k
        assert isinstance(p[k], tggml.QTensor8T) == k.endswith(tflux.Q8_0_SUFFIXES), k
    w = p["single_blocks.0.linear2.weight"].dequantize(torch.float32)
    assert abs(float(w.std()) - 1280 ** -0.5) < 0.05 * 1280 ** -0.5


# --- schedule, parameterization, sampler, FBCache --------------------------


def test_beta_schedule_and_model_sampling_flux_match_jax():
    jm, tm = jms.ModelSamplingFlux(), tms.ModelSamplingFlux()
    np.testing.assert_array_equal(tm.sigmas, jm.sigmas)
    assert (tm.sigma_min, tm.sigma_max) == (jm.sigma_min, jm.sigma_max)
    assert tm.percent_to_sigma(0.3) == jm.percent_to_sigma(0.3)
    for steps in (1, 4, 20):
        np.testing.assert_array_equal(tsched.calculate_sigmas(tm, "beta", steps),
                                      jsched.calculate_sigmas(jm, "beta", steps))
    sig = np.asarray([0.9, 0.25], np.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    out = rng.standard_normal((2, 4, 4, 16)).astype(np.float32)
    np.testing.assert_allclose(
        tm.calculate_denoised(_t(sig), _t(out), _t(x)).numpy(),
        np.asarray(jm.calculate_denoised(jnp.asarray(sig), jnp.asarray(out), jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tm.noise_scaling(torch.tensor(0.9), _t(x), _t(out)).numpy(),
        np.asarray(jm.noise_scaling(jnp.asarray(0.9), jnp.asarray(x), jnp.asarray(out))),
        rtol=1e-6, atol=1e-6)
    # arguments reach 1000 rad, where one f32 ulp of the argument is 6e-5
    t = np.asarray([0.0, 0.3, 0.999], np.float32)
    np.testing.assert_allclose(
        tsched.timestep_embedding_flux(_t(t), 256).numpy(),
        np.asarray(jsched.timestep_embedding_flux(jnp.asarray(t), 256)), atol=1e-4, rtol=0)


def test_euler_dy_sampler_matches_jax():
    """euler_cfgpp (the dy variant) with a toy denoiser: the Euler steps
    and the half-res checkerboard updates at steps 2 and 3."""
    sigmas = jsched.calculate_sigmas(jms.ModelSamplingFlux(), "beta", 6)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 9, 10, 4)).astype(np.float32)  # odd rows: untouched edge
    w = rng.standard_normal((4, 4)).astype(np.float32) * 0.3

    def jden(xx, s):
        d = jnp.tanh(xx @ jnp.asarray(w)) * (1.0 - jnp.max(jnp.asarray(s)))
        return d, d

    def tden(xx, s):
        s = torch.as_tensor(s, dtype=torch.float32)
        d = torch.tanh(xx @ _t(w)) * (1.0 - s.max())
        return d, d

    ref = np.asarray(jsamp.sample(jden, jnp.asarray(x), sigmas, sampler="euler_cfgpp",
                                  callback=lambda info: None))
    calls = []
    out = tsamp.sample(lambda xx, s: (calls.append(xx.shape), tden(xx, s))[1], _t(x),
                       sigmas, sampler="euler_cfgpp").numpy()
    assert calls.count((1, 4, 5, 4)) == 2  # the two half-res extra calls
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)


def test_fbcache_hits_misses_and_caps():
    """A tiny Flux model under FBCache: the first call misses, a hit adds
    the cached residual, the consecutive-hit cap and a zero threshold
    force misses, and the dy call's own state leaves the loop's alone."""
    tcfg = tflux.FluxConfig(**TINY)
    _, params = _flux_params(6)
    model = tbase.flux_model(from_jax(params), cfg=tcfg, device="cpu")
    rng = np.random.default_rng(6)
    cond = tpipe.cfg_mod.CondInput(cross_attn=_t(rng.standard_normal((1, 8, 256)).astype(np.float32)),
                                   pooled=_t(rng.standard_normal((1, 64)).astype(np.float32)),
                                   guidance=3.0)
    x = _t(rng.standard_normal((1, 8, 8, 16)).astype(np.float32))

    def run(threshold, max_hits, sigmas):
        den = tfb.for_model(model, cond, None, 1.0, tfb.FBCacheConfig(threshold, max_consecutive_cache_hits=max_hits))
        state = den.init_state(x)
        assert not state.valid
        tfb.history.clear()
        outs = []
        for s in sigmas:
            d, _, state = den(x, np.float32(s), state)
            outs.append(d)
        return list(tfb.history), outs

    hist, outs = run(10.0, -1, [0.9, 0.8, 0.7])
    assert hist == [False, True, True]
    hist, _ = run(10.0, 1, [0.9, 0.8, 0.7, 0.6])
    assert hist == [False, True, False, True]
    hist, _ = run(0.0, -1, [0.9, 0.8])
    assert hist == [False, False]


# --- the whole slice --------------------------------------------------------


def _read_png(path):
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke.read_png(path)


def test_flux_slice_matches_jax_composition(tmp_path, monkeypatch):
    """pipeline(flux_enabled=True) on a tiny DiT, T5 and Flux AE from GGUF /
    seeded params, against the JAX package's functions composed as its
    _flux_txt2img: same tokens, same conditioning, the same FBCache hits
    and misses, the final latent within 1e-3 and the image within 1 level."""
    run_flux_slice_against_jax(tmp_path, monkeypatch)


def run_flux_slice_against_jax(tmp_path, monkeypatch, w8a8=False, latent_tol=1e-3,
                               scan=False):
    """The whole tiny Flux slice through the port's ``pipeline`` and through
    the JAX package's functions; ``w8a8``: the DiT requantized to W8A8 in
    both packages (``to_w8a8`` before the RoPE permutation, as the JAX
    loader does), the run under each package's current ``RuntimeConfig``;
    ``scan``: the DiT and T5 in the scan layout in both packages (the port's
    from its ``flux_scan``, the JAX package's stacked after the permutation,
    as its loader does). The final latent is held to ``latent_tol``
    (relative RMS error)."""
    prompt = "a castle on a hill, ﬁne détails"
    cfg, fparams = _flux_params(7)
    fpath = _write_flux_gguf(tmp_path, fparams)
    t5cfg = jt5.T5Config(**T5_TINY)
    t5p = jt5.init_params(t5cfg, seed=8)
    inv = {"shared": "token_embd", "encoder.": "enc.", ".block.": ".blk.",
           "layer.0.SelfAttention.relative_attention_bias": "attn_rel_b",
           "layer.0.SelfAttention.q": "attn_q", "layer.0.SelfAttention.k": "attn_k",
           "layer.0.SelfAttention.v": "attn_v", "layer.0.SelfAttention.o": "attn_o",
           "layer.0.layer_norm": "attn_norm", "layer.1.DenseReluDense.wi_0": "ffn_gate",
           "layer.1.DenseReluDense.wi_1": "ffn_up", "layer.1.DenseReluDense.wo": "ffn_down",
           "layer.1.layer_norm": "ffn_norm", "final_layer_norm": "output_norm"}
    named = {}
    for k, v in t5p.items():
        for a, b in inv.items():
            k = k.replace(a, b)
        named[k] = np.asarray(v)
    t5path = str(tmp_path / "t5.gguf")
    jggml.write_gguf(t5path, named, arch="t5", quantize=(
        "attn_q.weight", "attn_k.weight", "attn_v.weight", "attn_o.weight",
        "ffn_up.weight", "ffn_down.weight", "ffn_gate.weight", "token_embd.weight"))
    clip_p = jte.init_params(num_layers=2, width=64, heads=4, seed=9, with_projection=True)
    vcfg_j = jvae.VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=16,
                            has_quant_conv=False)
    vae_p = jvae.init_params(vcfg_j, seed=10)

    # --- the port, through its entry point. At the pipeline's threshold
    # (0.120) this tiny random DiT misses on every call; at 0.5 it hits on
    # some, so both branches of the cache are compared.
    fb_cfg = tfb.FBCacheConfig(0.5)
    with fused_attn_on():
        model = tbase.flux_model(tggml.gguf_sd_loader(fpath), cfg=tflux.FluxConfig(**TINY),
                                 device="cpu").with_options(fbcache=fb_cfg)
    if scan:
        lin1 = model.params[tflux.SINGLE_STACK_KEY]["linear1.weight"]
        assert isinstance(lin1, tggml.StackedQTensor8W if w8a8 else tggml.StackedQTensor8T)
    else:
        lin1 = model.params["single_blocks.0.linear1.weight"]
        assert isinstance(lin1, tggml.QTensor8W if w8a8 else tggml.QTensor8T)
    t5 = tt5.T5XXLModel(tggml.gguf_clip_loader(t5path), device="cpu")
    assert tt5.is_stacked(t5.params) == scan
    clip = tte.SDClipModel(from_jax(clip_p), num_layers=2, heads=4, device="cpu")
    vcfg_t = tvae.VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=16,
                            has_quant_conv=False)
    vae = tvae.VAE(from_jax(vae_p), vcfg_t, device="cpu")
    latents = []
    tfb.history.clear()
    paths = tpipe.pipeline(prompt, 256, 256, flux_enabled=True, autohdr=False,
                           model=model, clip=clip, vae=vae, t5=t5, seed=SEED,
                           output_dir=str(tmp_path / "out"),
                           progress_callback=lambda info: latents.append(info["x"]))
    port_hits = list(tfb.history)
    assert len(latents) == 20 and len(port_hits) == 22  # 20 steps + 2 dy calls
    assert "Flux" in paths[0] and os.path.basename(paths[0]) == "LD_00001_.png"

    # --- the JAX package's functions, composed as its _flux_txt2img
    jp, jcfg = _jax_flux(fpath, cfg, w8a8=w8a8)
    if scan:
        jp = jflux.stack_block_params(jp, jcfg)
    t5sd = jggml.to_device_quantized(jggml.gguf_clip_loader(t5path), dtype=jnp.float32)
    jt5m = jt5.T5XXLModel(t5sd, cfg=jt5.detect_config(t5sd), compute_dtype=jnp.float32,
                          scan_blocks=scan)
    jclip = jte.SDClipModel(clip_p, heads=4)
    pos = jpipe.encode_flux_conditioning(prompt, prompt, guidance=3.0, t5_model=jt5m,
                                         clip_model=jclip)
    neg = dataclasses.replace(pos, cross_attn=jnp.zeros_like(pos.cross_attn),
                              pooled=jnp.zeros_like(pos.pooled))
    tpos = tpipe.encode_flux_conditioning(prompt, prompt, 3.0, t5_model=t5, clip_model=clip)
    assert _rel_rmse(tpos.cross_attn.numpy(), pos.cross_attn) <= 1e-4
    assert _rel_rmse(tpos.pooled.numpy(), pos.pooled) <= 1e-4

    jax_hits = []
    real_make_hook = jfb.make_hook

    def recording_make_hook(box, fb_cfg, gate):
        hook = real_make_hook(box, fb_cfg, gate)

        def wrapped(h_prev, h_first, run_rest):
            h = hook(h_prev, h_first, run_rest)
            jax.debug.callback(lambda hit: jax_hits.append(bool(hit)),
                               box[0].consecutive_hits > 0, ordered=True)
            return h

        return wrapped

    monkeypatch.setattr(jfb, "make_hook", recording_make_hook)
    jmodel = jbase.DiffusionModel(
        apply_fn=jflux.make_apply_fn(jcfg), params=jp,
        model_sampling=jms.ModelSamplingFlux(), latent_format=jlatent.FLUX1,
        config=jcfg, model_type="flux",
    ).with_options(fbcache=jfb.FBCacheConfig(fb_cfg.residual_diff_threshold))
    res = jks.ksample(
        jmodel, seed=SEED, steps=20, cfg_scale=1.0, sampler_name="euler_cfgpp",
        scheduler="beta", positive=pos, negative=neg,
        latent_image=jlatent.empty_latent(256, 256, 1, channels=16), denoise=1.0,
    )
    jax.effects_barrier()
    jimg = jimage.to_uint8(np.asarray(jvae.VAE(vae_p, vcfg_j).decode(res.latent)))[0]

    assert port_hits == jax_hits
    assert any(port_hits) and not all(port_hits)
    assert _rel_rmse(latents[-1].numpy(), res.raw) <= latent_tol
    port_img = _read_png(paths[0])
    assert port_img.shape == jimg.shape
    diff = np.abs(port_img.astype(np.int32) - jimg.astype(np.int32))
    assert diff.max() <= 1
