"""Flux.1-dev through ``pipeline(flux_enabled=True)``: the program's models
from seeded weights, the steps the comparison checks, and the comparison
with the plain reference.

The DiT and T5-XXL are drawn on the device with their matmul weights in
Q8_0, in the form the port's GGUF reader gives them (``ops.ggml.QTensor8``
records, dense leaves beside them), and handed to ``models.base.flux_model``
and ``models.clip.t5.T5XXLModel``, whose own set-up builds the W8A8 weights
and the stacked scan layout under the configuration's ``runtime`` (the
card's defaults); CLIP-L and the AE go to ``SDClipModel`` and ``VAE``.
``pipeline()`` then runs 20 ``euler_cfgpp`` steps at guidance 3.0 with
FBCache at its default threshold, the AE decode, AutoHDR and the PNG.

What is compared (``check``) on the checked image:

- ``t5`` and ``clip``: the T5-XXL sequence and CLIP-L's projected pooled
  vector the sampler got, against the reference's encoding of the same
  tokens (relative RMS error);
- ``model``: the DiT's velocity (x - denoised) / sigma at the checked
  steps, the reference's W8A8 DiT given the program's state x and the
  conditioning the program's sampler got; the largest relative RMS error;
- ``update``: the sampler's arithmetic, every piece from the program's
  own state before it: the start from the empty latent and the initial
  noise the program drew; at every step the DiT's input, its timestep, and
  the Euler update from the DiT's output, with the dy steps' (2 and 3)
  half-resolution call and its update of every 2x2 block's (1, 1) pixel;
  the latent the pass returns;
- ``png_levels``: the saved PNG against the reference's AE decode of the
  program's final latent, AutoHDR and 8-bit rounding, in mean levels.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from benchmark import families, png, weights
from benchmark.runtime import configure  # noqa: F401  (the family's RuntimeConfig)
from benchmark.reference import clip as clip_ref
from benchmark.reference import common as C
from benchmark.reference import flux as flux_ref
from benchmark.reference import sampling as S
from benchmark.reference import t5 as t5_ref
from benchmark.reference import vae as vae_ref

GUIDANCE = 3.0
DY_STEPS = (2, 3)  # euler_cfgpp's extra half-resolution updates follow these
# the Flux AE's: model-space latent = (AE latent - 0.1159) * 0.3611
LATENT_SCALE, LATENT_SHIFT = 0.3611, 0.1159


def _port_leaves(drawn: dict) -> dict:
    """Drawn leaves as the port's GGUF reader gives them."""
    from lightdiffusion_next_tpu_torch.ops import ggml

    return {k: ggml.QTensor8(q=v.q, scales=v.scales, shape=v.shape)
            if isinstance(v, weights.Q8) else v for k, v in drawn.items()}


def build(cfg: dict, seed: int, device):
    from lightdiffusion_next_tpu_torch.models import base, flux
    from lightdiffusion_next_tpu_torch.models import vae as vae_mod
    from lightdiffusion_next_tpu_torch.models.clip import t5 as t5_mod
    from lightdiffusion_next_tpu_torch.models.clip import text_encoder as te

    dev = torch.device(device)
    d = cfg["dit"]
    fcfg = flux.FluxConfig(
        in_channels=d["in_channels"], hidden_size=d["hidden_size"], mlp_ratio=d["mlp_ratio"],
        num_heads=d["num_heads"], depth=d["depth"], depth_single_blocks=d["depth_single_blocks"],
        axes_dim=tuple(d["axes_dim"]), theta=d["theta"], qkv_bias=d["qkv_bias"],
        guidance_embed=d["guidance_embed"], vec_in_dim=d["vec_in_dim"],
        context_in_dim=d["context_in_dim"], patch_size=d["patch_size"])
    model = base.flux_model(_port_leaves(weights.draw(seed, flux_ref.layout(d), dev)),
                            cfg=fcfg, device=dev)
    t = cfg["t5"]
    tcfg = t5_mod.T5Config(d_model=t["d_model"], d_ff=t["d_ff"], num_heads=t["num_heads"],
                           num_layers=t["num_layers"], vocab_size=t["vocab"])
    t5 = t5_mod.T5XXLModel(_port_leaves(weights.draw(seed, t5_ref.layout(t), dev)), cfg=tcfg,
                           device=dev)
    c = cfg["clip"]
    clip = te.SDClipModel(weights.draw(seed, [("flux.clip", clip_ref.layout(c))], dev),
                          num_layers=c["layers"], heads=c["width"] // 64, device=dev)
    a = cfg["ae"]
    acfg = vae_mod.VAEConfig(ch=a["ch"], ch_mult=tuple(a["ch_mult"]),
                             num_res_blocks=a["num_res_blocks"], z_channels=a["z_channels"],
                             has_quant_conv=a["has_quant_conv"])
    vae = vae_mod.VAE(weights.draw(seed, [("flux.ae", vae_ref.layout(a))], dev), cfg=acfg,
                      device=dev)
    return {"model": model, "clip": clip, "vae": vae, "t5": t5}


def pipeline_kwargs(models: dict, traffic: dict) -> dict:
    return dict(models, flux_enabled=True)


def instrument(models: dict, rec):
    """The recorder's hooks: each DiT call's shapes and FBCache decision,
    each decode and text encode."""
    from lightdiffusion_next_tpu_torch.sampling import fbcache

    m = models["model"]

    def dit(*args, **kwargs):
        before = len(fbcache.history)
        out = m.apply_fn(*args, **kwargs)
        dit.hit = len(fbcache.history) > before and fbcache.history[-1]
        return out

    def dit_info(args, kwargs, out):
        x, ctx = args[1], args[3]
        return {"b": x.shape[0], "h": x.shape[1], "w": x.shape[2], "txt": ctx.shape[1],
                "hit": bool(dit.hit)}

    models["model"] = dataclasses.replace(
        m, apply_fn=rec.model_call("flux", "dit", dit, dit_info, capture=True))
    vae = models["vae"]
    vae.decode = rec.model_call(
        "vae", "ae", vae.decode, lambda a, k, o: {"b": a[0].shape[0], "h": a[0].shape[1],
                                            "w": a[0].shape[2]})
    clip = models["clip"]
    clip.encode = rec.model_call("clip", "clip", clip.encode,
                                 lambda a, k, o: {"b": len(a[0]), "l": len(a[0][0])})
    t5 = models["t5"]
    t5.encode_token_weights = rec.model_call(
        "t5", "t5", t5.encode_token_weights, lambda a, k, o: {"b": len(a[0]), "l": len(a[0][0])})


def check_steps(cfg: dict, traffic: dict, pass_index: int, n: int, rng):
    """The two steps whose velocity is compared, drawn from the seed.
    (Every step's update is compared.)"""
    return sorted(rng.sample(range(1, n), 2))


def _pass_pieces(rec, sig, dt):
    """The reference's own values, in dt, of what the sampler computed,
    each from the program's state just before it: the start (sigma * noise
    + (1 - sigma) * the empty latent in model space); per step the DiT's
    input (the state itself), the Euler update from the DiT's output (the
    velocity: denoised = x - v * sigma) and, after the dy steps, the
    input of the half-resolution call (the (1, 1) pixel of every 2x2 block
    after the Euler update) and the same update of those pixels from its
    output; the latent out of model space."""
    lat = (rec["kw"]["latent_image"].double() - LATENT_SHIFT) * LATENT_SCALE
    out = [S.flow_noise_scaling(sig[0], rec["init_noise"], lat, dt)]
    x = rec["x0"]
    for i in range(rec["n"]):
        s, sn, calls = float(sig[i]), float(sig[i + 1]), rec["calls"].get(i, [])
        out.append(x.to(dt))
        if not calls:
            break
        nxt = S.euler(x, x.to(dt) - calls[0][3].to(dt) * s, s, sn, dt)
        if i in DY_STEPS and sn > 0:
            m, k = x.shape[1] // 2, x.shape[2] // 2
            c = nxt[:, 1:2 * m:2, 1:2 * k:2, :]
            out.append(c)
            if len(calls) < 2:
                break
            nxt = nxt.clone()
            nxt[:, 1:2 * m:2, 1:2 * k:2, :] = S.euler(c, c - calls[1][3].to(dt) * s, s, sn, dt)
        out.append(nxt)
        x = rec["steps"][i][0]
    out.append(x.to(dt) / LATENT_SCALE + LATENT_SHIFT)
    return out


def update_gap(rec, sig, control: bool) -> float:
    """``update``: the largest relative gap of the sampler's arithmetic
    (``_pass_pieces``) against the reference's in float64; of the
    program's, or with ``control`` of the reference's own in bfloat16. A
    model call too many or too few, or a timestep other than its sigma,
    reads infinite."""
    if control:
        got = _pass_pieces(rec, sig, torch.bfloat16)
    else:
        if not all(rec["calls"].get(i) and all(bool(torch.all(c[1] == float(sig[i])))
                                                for c in rec["calls"][i])
                   for i in range(rec["n"])):
            return math.inf
        got = families.program_pieces(rec)
    return families.largest_gap(got, _pass_pieces(rec, sig, torch.float64))


def check(cfg: dict, traffic: dict, prompts: dict, seed: int, device, cap, control: bool):
    dev = torch.device(device)
    ref, ctl = C.Precision(False), C.Precision(True)
    entry = prompts["prompts"][cap.prompt]
    kw = cap.passes[0]["kw"]
    out = {}

    c = cfg["clip"]
    params = {k: v.float() for k, v in
              weights.draw(seed, [("flux.clip", clip_ref.layout(c))], dev).items()}
    pooled = clip_ref.TextEncoder(params, c, ref).encode(entry["clip"], entry["clip_weights"],
                                                         c["layer"], dev)[1]
    got = (clip_ref.TextEncoder(params, c, ctl).encode(entry["clip"], entry["clip_weights"],
                                                       c["layer"], dev)[1]
           if control else kw["positive"].pooled)
    out["clip"] = C.rel_rms(got, pooled)
    del params

    t5_groups = dict(t5_ref.layout(cfg["t5"]))
    draw_t5 = lambda g: weights.draw_group(seed, g, t5_groups[g], dev)
    ids = torch.tensor(entry["t5"], device=dev)
    seq = t5_ref.Encoder(draw_t5, cfg["t5"], ref)(ids)
    got = t5_ref.Encoder(draw_t5, cfg["t5"], ctl)(ids) if control else kw["positive"].cross_attn
    out["t5"] = C.rel_rms(got, seq)

    rec = cap.passes[0]
    n = rec["n"]
    sig = S.beta(S.flux_sigmas_table(), n)
    groups = dict(flux_ref.layout(cfg["dit"]))
    draw = lambda g: weights.draw_group(seed, g, groups[g], dev)
    steps = rec["model_steps"]
    x = torch.cat([rec["steps"][i - 1][0] for i in steps]).float()
    t = torch.tensor([float(sig[i]) for i in steps], device=dev)
    # the DiT is held to the reference given the conditioning the program's
    # sampler got, which ``t5`` and ``clip`` judged on their own
    cond = (kw["positive"].cross_attn.float(), kw["positive"].pooled.float())
    want = flux_ref.DiT(draw, cfg["dit"], ref)(x, t, *cond, GUIDANCE)
    if control:
        cand = flux_ref.DiT(draw, cfg["dit"], ctl)(x, t, *cond, GUIDANCE)
    else:
        cand = torch.cat([S.derivative(rec["steps"][i - 1][0], rec["steps"][i][1],
                                       float(sig[i])) for i in steps])
    out["model"] = max(C.rel_rms(cand[k:k + 1], want[k:k + 1]) for k in range(len(steps)))
    del want, cand

    out["update"] = update_gap(rec, sig, control)

    a = cfg["ae"]
    params = {k: v.float() for k, v in
              weights.draw(seed, [("flux.ae", vae_ref.layout(a))], dev).items()}
    z = rec["latent"]
    want = S.to_uint8(S.autohdr(vae_ref.Decoder(params, a, ref)(z)))[0]
    if control:
        got = S.to_uint8(S.autohdr(vae_ref.Decoder(params, a, ctl)(z)))[0].cpu().numpy()
    else:
        got = png.read_png(cap.png)
    out["png_levels"] = S.level_gap(got, want)
    return out
