"""The sampling arithmetic the pipelines use, in plain PyTorch and numpy:
the discrete EPS table of SD1.5 and Flux's shifted flow table, the
karras, normal and beta schedules, MSW-MSA's shift index and gate, the
multi-scale plan, the denoised-to-derivative map, the updates of the Euler,
Euler-ancestral and DPM++ SDE samplers and the start of a pass from its
latent and noise, bislerp, AutoHDR and the 8-bit rounding of a saved
image.

As published: k-diffusion's karras schedule (rho 7), its samplers, ComfyUI's "normal"
and "beta" (alpha = beta = 0.6) schedulers, LDM's linear beta table
(0.00085 to 0.012, 1000 steps), Flux's time shift mu = 1.15 over 10 000
steps, HiDiffusion's MSW-MSA (gate from 20% of the schedule on), ComfyUI's
bislerp and LightDiffusion-Next's AutoHDR (Lab luminance shaping).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import common as C


class Discrete:
    """SD1.5's EPS table."""

    def __init__(self):
        betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000, dtype=np.float64) ** 2
        acp = np.cumprod(1.0 - betas)
        self.sigmas = np.sqrt((1.0 - acp) / acp).astype(np.float32)
        self.log_sigmas = np.log(self.sigmas)

    def timestep(self, sigma: float) -> float:
        """The nearest table index, in f32 log space."""
        d = np.abs(np.log(np.float32(sigma)) - self.log_sigmas)
        return float(np.argmin(d))

    def sigma(self, t: float) -> float:
        t = float(np.clip(np.float32(t), 0, 999))
        lo, hi = int(math.floor(t)), int(math.ceil(t))
        w = np.float32(t) - np.float32(lo)
        return float(np.exp((1 - w) * self.log_sigmas[lo] + w * self.log_sigmas[hi]))

    def percent_to_sigma(self, percent: float) -> float:
        if percent <= 0.0:
            return 999999999.9
        if percent >= 1.0:
            return 0.0
        return self.sigma((1.0 - percent) * 999.0)


def karras(model: Discrete, steps: int, rho: float = 7.0) -> np.ndarray:
    ramp = np.linspace(0, 1, steps, dtype=np.float32)
    lo, hi = float(model.sigmas[0]) ** (1 / rho), float(model.sigmas[-1]) ** (1 / rho)
    s = ((hi + ramp * (lo - hi)) ** rho).astype(np.float32)
    return np.append(s, np.float32(0))


def normal(model: Discrete, steps: int) -> np.ndarray:
    start = model.timestep(model.sigmas[-1])
    end = model.timestep(model.sigmas[0])
    ts = np.linspace(start, end, steps, dtype=np.float32)
    return np.asarray([model.sigma(t) for t in ts] + [0.0], dtype=np.float32)


def denoise_tail(schedule, steps: int, denoise: float) -> np.ndarray:
    """The last steps + 1 sigmas of ``schedule(int(steps / denoise))``, the
    schedule of a pass with denoise < 1."""
    if denoise >= 0.9999:
        return schedule(steps)
    return schedule(int(steps / denoise))[-(steps + 1):]


def flux_sigmas_table(shift: float = 1.15, n: int = 10000) -> np.ndarray:
    ts = np.arange(1, n + 1, dtype=np.float64) / n
    return np.asarray([math.exp(shift) / (math.exp(shift) + (1 / t - 1)) for t in ts],
                      dtype=np.float32)


def beta(table: np.ndarray, steps: int, a: float = 0.6, b: float = 0.6) -> np.ndarray:
    import scipy.stats

    total = len(table) - 1
    ts = scipy.stats.beta.ppf(1 - np.linspace(0, 1, steps, endpoint=False), a, b)
    idx = np.rint(ts * total).astype(np.int32)
    uniq, first = np.unique(idx, return_index=True)
    return np.asarray([float(table[i]) for i in uniq[np.argsort(first)]] + [0.0],
                      dtype=np.float32)


def msw_state(model: Discrete, t: float):
    """(shift index, active) of MSW-MSA at timestep t."""
    t_hi = model.timestep(model.percent_to_sigma(0.2))
    t_lo = model.timestep(max(model.percent_to_sigma(1.0), 1e-20))
    return int(math.floor(t)) % 4, t_lo <= t <= t_hi


def fullres_flags(n: int, enabled: bool, start: int, end: int) -> np.ndarray:
    """Multi-scale: full resolution for the first ``start`` and the last
    ``end`` steps, half resolution in between (intermittent off)."""
    if not enabled:
        return np.ones(n, dtype=bool)
    return np.array([i < start or i >= n - end for i in range(n)])


def derivative(x, denoised, sigma: float, dtype=torch.float64):
    """(x - denoised) / sigma, in ``dtype``."""
    return (x.to(dtype) - denoised.to(dtype)) / sigma


def euler(x, denoised, sigma: float, sigma_next: float, dtype=torch.float64):
    """x + d * (sigma_next - sigma) in ``dtype``: the Euler update; with
    sigma_next = 0 also the last step of DPM++ SDE and of the ancestral
    samplers."""
    d = derivative(x, denoised, sigma, dtype)
    return x.to(dtype) + d * (float(sigma_next) - float(sigma))


def ancestral_step(sigma: float, sigma_next: float, eta: float = 1.0):
    """k-diffusion's ``get_ancestral_step``: (sigma_down, sigma_up) of a
    step from sigma to sigma_next, in float64."""
    s, sn = float(sigma), float(sigma_next)
    if sn == 0.0:
        return 0.0, 0.0
    up = min(sn, eta * math.sqrt(sn * sn * (s * s - sn * sn) / (s * s)))
    return math.sqrt(sn * sn - up * up), up


def _noise(noise, like, dtype):
    return torch.as_tensor(noise).to(device=like.device, dtype=dtype)


def euler_ancestral(x, denoised, noise, sigma: float, sigma_next: float,
                    dtype=torch.float64):
    """k-diffusion's ``sample_euler_ancestral`` step (eta 1, s_noise 1): the
    Euler step to sigma_down, plus the noise times sigma_up."""
    down, up = ancestral_step(sigma, sigma_next)
    x = euler(x, denoised, sigma, down, dtype)
    return x + _noise(noise, x, dtype) * up if up else x


def sde_midpoint(sigma: float, sigma_next: float, r: float = 0.5) -> float:
    """DPM++ SDE's intermediate sigma: exp(-(t + r (t_next - t))), t = -log sigma."""
    t, t_next = -math.log(float(sigma)), -math.log(float(sigma_next))
    return math.exp(-(t + (t_next - t) * r))


def sde_stage(x, denoised, noise, sigma: float, sigma_to: float, dtype=torch.float64):
    """One stage of k-diffusion's ``sample_dpmpp_sde`` (eta 1, s_noise 1):
    (sigma_fn(s_) / sigma_fn(t)) x - expm1(t - s_) denoised, plus the noise
    times sigma_up, where s_ = t_fn(sigma_down) of the ancestral step from
    sigma to sigma_to. The first stage goes to the midpoint around the
    step's denoised latent; the second to sigma_next around the midpoint's
    (with r = 1/2 the mix (1 - 1/2r) d + (1/2r) d_2 is d_2 alone)."""
    down, up = ancestral_step(sigma, sigma_to)
    t, s_ = -math.log(float(sigma)), -math.log(down)
    x = x.to(dtype) * (down / float(sigma)) - denoised.to(dtype) * math.expm1(t - s_)
    return x + _noise(noise, x, dtype) * up


def eps_noise_scaling(sigma: float, noise, latent, max_denoise: bool, dtype=torch.float64):
    """The start of an EPS sampling pass: noise * sigma (sqrt(1 + sigma^2)
    at the schedule's top) plus the model-space latent."""
    s = float(sigma)
    scale = math.sqrt(1.0 + s * s) if max_denoise else s
    return latent.to(dtype) + _noise(noise, latent, dtype) * scale


def flow_noise_scaling(sigma: float, noise, latent, dtype=torch.float64):
    """The start of a rectified-flow pass: sigma * noise + (1 - sigma) * latent."""
    s = float(sigma)
    return _noise(noise, latent, dtype) * s + latent.to(dtype) * (1.0 - s)


# ---------------------------------------------------------------------------
# bislerp (ComfyUI's), on the host
# ---------------------------------------------------------------------------


def _lerp_coords(n_old: int, n_new: int):
    x = (np.arange(n_new, dtype=np.float64) + 0.5) * (n_old / n_new) - 0.5
    x = np.clip(x, 0, n_old - 1)

    def interp(arr):
        lo = np.floor(x).astype(np.int64)
        hi = np.minimum(lo + 1, n_old - 1)
        w = x - lo
        return arr[lo] * (1 - w) + arr[hi] * w

    ramp = np.arange(n_old, dtype=np.float32)
    c1f = interp(ramp)
    ramp2 = ramp + 1
    ramp2[-1] -= 1
    return ((c1f - np.floor(c1f)).astype(np.float32), c1f.astype(np.int64),
            interp(ramp2).astype(np.int64))


def _slerp(b1, b2, r):
    n1 = np.linalg.norm(b1, axis=-1, keepdims=True)
    n2 = np.linalg.norm(b2, axis=-1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        u1 = np.where(n1 == 0, 0.0, b1 / np.maximum(n1, 1e-30))
        u2 = np.where(n2 == 0, 0.0, b2 / np.maximum(n2, 1e-30))
        dot = np.sum(u1 * u2, axis=-1)
        om = np.arccos(np.clip(dot, -1.0, 1.0))
        so = np.sin(om)
        res = (np.sin((1.0 - r[:, 0]) * om) / so)[:, None] * u1 + (
            np.sin(r[:, 0] * om) / so)[:, None] * u2
    res = res * (n1 * (1.0 - r) + n2 * r)
    same = dot > 1 - 1e-5
    res[same] = b1[same]
    opp = dot < 1e-5 - 1
    res[opp] = (b1 * (1.0 - r) + b2 * r)[opp]
    return res


def bislerp(x: np.ndarray, width: int, height: int) -> np.ndarray:
    """NHWC spherical-bilinear resize: along w, then along h."""
    x = np.asarray(x, dtype=np.float32)
    n, h, w, c = x.shape
    r, c1, c2 = _lerp_coords(w, width)
    x = _slerp(x[:, :, c1].reshape(-1, c), x[:, :, c2].reshape(-1, c),
               np.tile(r[None, None, :], (n, h, 1)).reshape(-1, 1)).reshape(n, h, width, c)
    r, c1, c2 = _lerp_coords(h, height)
    return _slerp(x[:, c1].reshape(-1, c), x[:, c2].reshape(-1, c),
                  np.tile(r[None, :, None], (n, 1, width)).reshape(-1, 1)).reshape(
        n, height, width, c)


# ---------------------------------------------------------------------------
# AutoHDR and the saved image
# ---------------------------------------------------------------------------

SRGB_TO_XYZ = torch.tensor([[0.4360747, 0.3850649, 0.1430804],
                            [0.2225045, 0.7168786, 0.0606169],
                            [0.0139322, 0.0971045, 0.7141733]], dtype=torch.float64)
XYZ_TO_SRGB = torch.tensor([[3.1338561, -1.6168667, -0.4906146],
                            [-0.9787684, 1.9161415, 0.0334540],
                            [0.0719453, -0.2289914, 1.4052427]], dtype=torch.float64)
WHITE_D50 = torch.tensor([0.9642957, 1.0, 0.8251046], dtype=torch.float64)
LUMA = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float64)
EPS, KAPPA = 216 / 24389, 24389 / 27


def autohdr(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) [0, 1] -> the same after AutoHDR's defaults (HDR 0.75,
    shadows 0.25, highlights 0.5, gamma 0.25, contrast 0.1, colour 0.25),
    computed in float64; the contrast mean is per image."""
    dev = images.device
    rgb = images.double().clamp(0, 1)
    lin = torch.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
    xyz = (lin @ SRGB_TO_XYZ.to(dev).T) / WHITE_D50.to(dev)
    f = torch.where(xyz > EPS, torch.sign(xyz) * xyz.abs() ** (1 / 3), (KAPPA * xyz + 16) / 116)
    L = 116 * f[..., 1] - 16
    a, b = 500 * (f[..., 0] - f[..., 1]), 200 * (f[..., 1] - f[..., 2])
    base = L * 255.0 / 100.0
    hdr = 0.75
    shadows = torch.clamp(base * (1 - torch.clamp((1 - base / 255) ** 2, 0, 1) * 0.25 ** 2 * hdr),
                          0, 255)
    highs = torch.clamp(base + (255 - base) * torch.clamp((base / 255) ** 2, 0, 1)
                        * 0.5 ** 2 * hdr, 0, 255)
    adjusted = torch.clamp(shadows + highs - base, 0, 255)
    lum = torch.clamp(base * (1 - hdr) + adjusted * hdr, 0, 255)
    lum = 255 * ((lum / 255) ** (1 / (1.1 - 0.25)))
    fy = (lum * 100.0 / 255.0 + 16) / 116
    fx, fz = fy + a / 500, fy - b / 200
    finv = lambda v: torch.where(v ** 3 > EPS, v ** 3, (116 * v - 16) / KAPPA)
    xyz2 = torch.stack([finv(fx), finv(fy), finv(fz)], dim=-1) * WHITE_D50.to(dev)
    out = torch.clamp(xyz2 @ XYZ_TO_SRGB.to(dev).T, 0, 1)
    out = torch.where(out <= 0.0031308, out * 12.92, 1.055 * out ** (1 / 2.4) - 0.055)
    luma = LUMA.to(dev)
    mean = (out @ luma).mean(dim=(1, 2), keepdim=True)[..., None]
    out = torch.clamp(mean + (out - mean) * 1.1, 0, 1)
    gray = (out @ luma)[..., None]
    return torch.clamp(gray + (out - gray) * (1 + 0.25 * 0.2), 0, 1)


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> 8-bit levels, rounded half up."""
    return torch.clamp(torch.floor(images.double() * 255.0 + 0.5), 0, 255)


def level_gap(png: np.ndarray, levels: torch.Tensor) -> float:
    """Mean absolute difference, in 8-bit levels, of a saved image and the
    reference's levels."""
    got = torch.as_tensor(png, dtype=torch.float64, device=levels.device)
    return float((got - levels.reshape(got.shape)).abs().mean())


def rel(got, want) -> float:
    return C.rel_rms(got, want)
