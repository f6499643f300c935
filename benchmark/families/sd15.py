"""SD1.5 through ``pipeline()``: the program's models from seeded weights,
the steps the comparison checks, and the comparison with the plain
reference.

The UNet, the VAE and CLIP-L are drawn on the device in the checkpoint's
key layout (``benchmark.reference``'s layouts) and handed to
``models.base.sd15_model``, ``models.vae.VAE`` and
``models.clip.facade.sd1_clip_from_params``: the objects a loaded
checkpoint gives ``pipeline()``, without a LoRA or embeddings (those come
from files). Every other argument of ``pipeline()`` keeps its default:
``dpmpp_sde_cfgpp`` over 20 karras steps at CFG 7 with the multi-scale plan
and MSW-MSA, AutoHDR, and with ``hires_fix`` 10 ``euler_ancestral_cfgpp``
steps at 2048^2.

What is compared (``check``), on the checked image, each against the plain
reference that computes it again from the same weights and prompt tokens:

- ``clip``: the prompt's and the default negative prompt's conditioning
  (relative RMS error, the larger of the two);
- ``model``: the UNet's output (cond and uncond) at checked steps against
  the reference UNet with MSW-MSA given the same inputs, the program's
  scaled latent, timestep and CFG batch; the largest relative RMS error;
- ``denoise``: the sampler's arithmetic around that output, the model's
  inputs (the latent scaled and, on multi-scale steps, resized; the
  timestep; the CFG batch) and the derivative (x - denoised) / sigma of the
  CFG combination, against the reference's from the program's model output;
- ``update``: each pass's sampler arithmetic, every piece from the
  program's own state before it: the start from the pass's latent and the
  initial noise the program drew; at every step each model call's input
  (the latent scaled and, on multi-scale steps, resized; the timestep) and
  the step's update from the program's model outputs and the noises it
  drew (DPM++ SDE's two stages, Euler-ancestral's step and noise); the
  latent the pass returns;
- ``upscale`` (hires-fix): the bislerp of the first pass's latent that the
  second pass starts from;
- ``png_levels``: the saved PNG against the reference's decode of the
  program's final latent, AutoHDR and 8-bit rounding, in mean levels.

With ``control`` the same numbers are read of the control (the reference
one precision step down) in the program's place.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from benchmark import families, png, weights
from benchmark.runtime import configure  # noqa: F401  (the family's RuntimeConfig)
from benchmark.reference import clip as clip_ref
from benchmark.reference import common as C
from benchmark.reference import sampling as S
from benchmark.reference import unet as unet_ref
from benchmark.reference import vae as vae_ref

MULTISCALE = {"enabled": True, "start": 3, "end": 8}  # pipeline()'s defaults
CFG_SCALE = (7.0, 8.0)  # the first pass's, hires-fix's
LATENT_SCALE = 0.18215  # the SD VAE's: model-space latent = VAE latent * 0.18215


def build(cfg: dict, seed: int, device):
    from lightdiffusion_next_tpu_torch import config
    from lightdiffusion_next_tpu_torch.models import base, unet
    from lightdiffusion_next_tpu_torch.models import vae as vae_mod
    from lightdiffusion_next_tpu_torch.models.clip import facade

    dev = torch.device(device)
    u = cfg["unet"]
    ucfg = unet.UNetConfig(
        in_channels=u["in_channels"], out_channels=u["out_channels"],
        model_channels=u["model_channels"], channel_mult=tuple(u["channel_mult"]),
        num_res_blocks=(u["num_res_blocks"],) * len(u["channel_mult"]),
        transformer_depth=tuple(u["transformer_depth"]), context_dim=u["context_dim"],
        num_heads=u["num_heads"], dtype=config.DtypePolicy.for_device(dev).param_dtype)
    model = base.sd15_model(weights.draw(seed, [("sd15.unet", unet_ref.layout(u))], dev),
                            cfg=ucfg, device=dev)
    v = cfg["vae"]
    vcfg = vae_mod.VAEConfig(ch=v["ch"], ch_mult=tuple(v["ch_mult"]),
                             num_res_blocks=v["num_res_blocks"], z_channels=v["z_channels"],
                             has_quant_conv=v["has_quant_conv"])
    vae = vae_mod.VAE(weights.draw(seed, [("sd15.vae", vae_ref.layout(v))], dev), cfg=vcfg,
                      device=dev)
    clip = facade.sd1_clip_from_params(
        weights.draw(seed, [("sd15.clip", clip_ref.layout(cfg["clip"]))], dev), device=dev)
    return {"model": model, "vae": vae, "clip": clip}


def pipeline_kwargs(models: dict, traffic: dict) -> dict:
    return dict(models, hires_fix=bool(traffic["hires_fix"]))


def instrument(models: dict, rec):
    """The recorder's hooks on the models: each UNet call's shapes (and
    whether MSW-MSA windowed it), each decode and text encode."""
    disc = S.Discrete()

    def unet_info(args, kwargs, out):
        x, t, ctx = args[1], args[2], args[3]
        _, windowed = S.msw_state(disc, float(t.max()))
        return {"b": x.shape[0], "h": x.shape[1], "w": x.shape[2], "ctx": ctx.shape[1],
                "windowed": windowed}

    m = models["model"]
    models["model"] = dataclasses.replace(m, apply_fn=rec.model_call(
        "unet", "unet", m.apply_fn, unet_info, capture=True))
    vae = models["vae"]
    vae.decode = rec.model_call(
        "vae", "vae", vae.decode, lambda a, k, o: {"b": a[0].shape[0], "h": a[0].shape[1],
                                            "w": a[0].shape[2]})
    inner = models["clip"].model.model  # SD1ClipModel -> SDClipModel
    inner.encode = rec.model_call("clip", "clip", inner.encode,
                                  lambda a, k, o: {"b": len(a[0]), "l": len(a[0][0])})


def check_steps(cfg: dict, traffic: dict, pass_index: int, n: int, rng):
    """The steps of a ``ksample`` pass of n steps whose model output is
    compared, the same for every seed, so that every run compares like with
    like: the first pass's second step (MSW-MSA's gate still shut), the
    middle step of its half-resolution stretch and its third step from the
    end; the hires pass's second and second-to-last steps. (Every step's
    update is compared.)"""
    del rng
    if pass_index == 0:
        full = _fullres(n, traffic["height"] // 8, traffic["width"] // 8)
        low = [i for i in range(1, n) if not full[i]]
        return sorted({1, n - 3} | ({low[len(low) // 2]} if low else set()))
    return sorted({1, n - 2})


def _f32(params):
    return {k: v.float() for k, v in params.items()}


def _bf16(t):
    return t.to(torch.bfloat16).double()


def _scaled(h: int, w: int):
    """pipeline's multi-scale size: half, snapped to multiples of 8."""
    return (int(max(8, ((h * 0.5) // 8) * 8)), int(max(8, ((w * 0.5) // 8) * 8)))


def _fullres(n: int, h: int, w: int):
    """The multi-scale plan of an (h, w) latent: all full resolution where
    the half size snaps back to the full one."""
    return S.fullres_flags(n, MULTISCALE["enabled"] and _scaled(h, w) != (h, w),
                           MULTISCALE["start"], MULTISCALE["end"])


def _model_input(x, sigma: float, fullres: bool, dt):
    """The CFG batch the denoiser hands the UNet at state x: the latent,
    resized down on a half-resolution step, over sqrt(sigma^2 + 1), twice."""
    h, w = x.shape[1:3]
    xs = x.to(dt) if fullres else C.bilinear(x, _scaled(h, w)).to(dt)
    xs = xs / math.sqrt(float(sigma) ** 2 + 1.0)
    return torch.cat([xs, xs])


def _denoised(x, eps, sigma: float, fullres: bool, scale: float, dt):
    """The CFG denoiser's output at x's resolution, in dt, around the model
    output ``eps`` (cond, uncond): the latent, resized down on a
    half-resolution step, minus eps * sigma, combined with the CFG scale,
    resized back up."""
    h, w = x.shape[1:3]
    xs = x.to(dt) if fullres else C.bilinear(x, _scaled(h, w)).to(dt)
    den = xs - eps.to(dt) * float(np.float32(sigma))
    den = den[1:] + (den[:1] - den[1:]) * scale
    return den if fullres else C.bilinear(den, (h, w)).to(dt)


def _pass_plan(disc, traffic: dict, p: int, rec):
    """(sigmas, full-resolution flags, CFG scale, sampler, whether the pass
    starts at the schedule's top) of pass p: 20 karras steps of DPM++ SDE
    with the multi-scale plan, or hires-fix's 10 "normal" steps of
    Euler-ancestral at denoise 0.45, all at full resolution."""
    n = rec["n"]
    if p == 0:
        sig = S.karras(disc, n)
        full = _fullres(n, traffic["height"] // 8, traffic["width"] // 8)
        sampler = "sde"
    else:
        sig = S.denoise_tail(lambda k: S.normal(disc, k), n, float(rec["kw"]["denoise"]))
        full = np.ones(n, dtype=bool)
        sampler = "ancestral"
    top = float(disc.sigmas[-1])
    return sig, full, CFG_SCALE[p], sampler, abs(top - float(sig[0])) < 1e-4 or sig[0] > top


def _pass_pieces(rec, plan, dt):
    """The reference's own values, in dt, of what pass rec's sampler
    computed, each from the program's state just before it: the state the
    pass starts from (its latent in model space plus the initial noise);
    per step each model call's input and the state after the step's update
    from the program's model outputs and the step's noises; the pass's
    latent out of model space."""
    sig, full, scale, sampler, top = plan
    out = [S.eps_noise_scaling(sig[0], rec["init_noise"],
                               rec["kw"]["latent_image"].double() * LATENT_SCALE, top, dt)]
    x = rec["x0"]
    for i in range(rec["n"]):
        s, sn, calls = float(sig[i]), float(sig[i + 1]), rec["calls"].get(i, [])
        out.append(_model_input(x, s, full[i], dt))
        if not calls:
            break
        den = _denoised(x, calls[0][3], s, full[i], scale, dt)
        if sampler == "ancestral":
            out.append(S.euler_ancestral(x, den, rec["step_noise"][i], s, sn, dt))
        elif sn == 0:  # DPM++ SDE's last step is an Euler step
            out.append(S.euler(x, den, s, sn, dt))
        else:
            mid = S.sde_midpoint(s, sn)
            x2 = S.sde_stage(x, den, rec["sde_noise"][0][i], s, mid, dt)
            out.append(_model_input(x2, mid, full[i], dt))
            if len(calls) < 2:
                break
            den2 = _denoised(x2, calls[1][3], mid, full[i], scale, dt)
            out.append(S.sde_stage(x, den2, rec["sde_noise"][1][i], s, sn, dt))
        x = rec["steps"][i][0]
    out.append(x.to(dt) / LATENT_SCALE)
    return out


def _timesteps_match(disc, rec, plan) -> bool:
    """Every model call's timestep is the table index of its sigma (the
    step's, then DPM++ SDE's midpoint)."""
    sig, _, _, sampler, _ = plan
    for i in range(rec["n"]):
        s, sn = float(sig[i]), float(sig[i + 1])
        want = [s] + ([S.sde_midpoint(s, sn)] if sampler == "sde" and sn > 0 else [])
        calls = rec["calls"].get(i, [])
        if len(calls) != len(want) or not all(
                bool(torch.all(c[1] == disc.timestep(w))) for c, w in zip(calls, want)):
            return False
    return True


def update_gap(disc, traffic: dict, cap, control: bool) -> float:
    """``update``: the largest relative gap of each pass's sampler
    arithmetic (``_pass_pieces``) against the reference's in float64; of
    the program's, or with ``control`` of the reference's own in bfloat16.
    A model call too many or too few, or a timestep off the table, reads
    infinite."""
    gap = 0.0
    for p, rec in enumerate(cap.passes):
        plan = _pass_plan(disc, traffic, p, rec)
        if not (control or _timesteps_match(disc, rec, plan)):
            return math.inf
        got = (_pass_pieces(rec, plan, torch.bfloat16) if control
               else families.program_pieces(rec))
        gap = max(gap, families.largest_gap(got, _pass_pieces(rec, plan, torch.float64)))
    return gap


def check(cfg: dict, traffic: dict, prompts: dict, seed: int, device, cap, control: bool):
    dev = torch.device(device)
    ref, ctl = C.Precision(False), C.Precision(True)
    disc = S.Discrete()
    entry, neg = prompts["prompts"][cap.prompt], prompts["default_negative"]
    out = {}

    params = _f32(weights.draw(seed, [("sd15.clip", clip_ref.layout(cfg["clip"]))], dev))
    layer = cfg["clip"]["layer"]

    def encode(prec, e):
        return clip_ref.TextEncoder(params, cfg["clip"], prec).encode(
            e["clip"], e["clip_weights"], layer, dev)[0]

    pos, negc = encode(ref, entry), encode(ref, neg)
    kw0 = cap.passes[0]["kw"]
    got = ((encode(ctl, entry), encode(ctl, neg)) if control
           else (kw0["positive"].cross_attn, kw0["negative"].cross_attn))
    out["clip"] = max(C.rel_rms(got[0], pos), C.rel_rms(got[1], negc))
    del params

    params = _f32(weights.draw(seed, [("sd15.unet", unet_ref.layout(cfg["unet"]))], dev))
    nets = {False: unet_ref.UNet(params, cfg["unet"], ref)}
    if control:
        nets[True] = unet_ref.UNet(params, cfg["unet"], ctl)
    # the CFG batch as the program's sampler got it, which ``clip`` judged
    ctx = torch.cat([kw0["positive"].cross_attn, kw0["negative"].cross_attn]).float()
    model_gap, denoise_gap = 0.0, 0.0
    for p, rec in enumerate(cap.passes):
        sig, full, scale, _, _ = _pass_plan(disc, traffic, p, rec)
        for i in rec["model_steps"]:
            x, s = rec["steps"][i - 1][0], float(sig[i])
            xin, t, c, eps = rec["calls"][i][0]
            # the model's inputs: the scaled latent, the timestep, the batch
            t_ref = disc.timestep(s)
            inputs = max(C.rel_rms(xin, _model_input(x, s, full[i], torch.float64)),
                         C.rel_rms(c, ctx), float(not torch.all(t == t_ref)))
            want = nets[False](xin, t, c, S.msw_state(disc, t_ref))
            cand = nets[True](xin, t, c, S.msw_state(disc, t_ref)) if control else eps
            model_gap = max(model_gap, C.rel_rms(cand, want))
            # the sampler's arithmetic around the program's model output
            want = S.derivative(x, _denoised(x, eps, s, full[i], scale, torch.float64), s)
            cand = (S.derivative(x, _denoised(x, eps, s, full[i], scale, torch.bfloat16), s,
                                 torch.bfloat16)
                    if control else S.derivative(x, rec["steps"][i][1], s))
            denoise_gap = max(denoise_gap, C.rel_rms(cand, want), 0.0 if control else inputs)
        if p == 1:
            first = cap.passes[0]["latent"].float().cpu().numpy()
            w2, h2 = traffic["width"] * 2 // 8, traffic["height"] * 2 // 8
            want = torch.from_numpy(S.bislerp(first, w2, h2))
            cand = (_bf16(torch.from_numpy(S.bislerp(_bf16(torch.from_numpy(first)).float()
                                                     .numpy(), w2, h2)))
                    if control else rec["kw"]["latent_image"])
            out["upscale"] = C.rel_rms(cand, want)
    out["model"], out["denoise"] = model_gap, denoise_gap
    out["update"] = update_gap(disc, traffic, cap, control)
    del nets, params

    params = _f32(weights.draw(seed, [("sd15.vae", vae_ref.layout(cfg["vae"]))], dev))
    z = cap.passes[-1]["latent"]
    want = S.to_uint8(S.autohdr(vae_ref.Decoder(params, cfg["vae"], ref)(z)))[0]
    if control:
        got = S.to_uint8(S.autohdr(vae_ref.Decoder(params, cfg["vae"], ctl)(z)))[0].cpu().numpy()
    else:
        got = png.read_png(cap.png)
    out["png_levels"] = S.level_gap(got, want)
    return out
