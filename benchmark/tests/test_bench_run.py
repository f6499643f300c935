"""Whole runs of the harness at small widths on the CPU (the program's
plain kernel versions), the planted faults that must make ``correct``
false, the control's readings, and the control on the card at the cells'
own sizes (marked ``cuda``)."""

from __future__ import annotations

import contextlib
import io
import json
from types import SimpleNamespace as NS

import numpy as np
import pytest
import torch

from benchmark import harness, manifest
from benchmark.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bench"))
    tiny.make_root(path)
    return path


def run(root, name, seed=2**31 + 11, trace=False):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = harness.run_cell(tiny.cell(root, name), seed, 0.05, trace, device="cpu")
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("name", sorted(tiny.CELLS))
def test_a_sound_run_is_correct(root, name):
    result = run(root, name)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks" and result["attempted"] >= 1 and not result["failed"]
    assert set(result["metrics"]) == {"s_per_image", "setup_s"}  # no peak on the CPU
    expected = {"clip", "model", "update", "png_levels"} | ({"denoise"} if "sd15" in name else set())
    expected |= {"t5"} if "flux" in name else set()
    expected |= {"upscale"} if "hires" in name else set()
    assert set(result["checks"]) == expected


def test_a_traced_run_reads_the_layers(root):
    result = run(root, "tiny-sd15-txt2img", trace=True)
    assert result["correct"]
    m = result["metrics"]
    assert m["outside_sampler_ms"]["value"] > 0 and m["sampler_it_per_s"]["value"] > 0
    assert 0 < m["mfu"]["value"] < 100


def plant(monkeypatch, fault, cell):
    """step_unchanged: every sampler step returns its state unchanged;
    middle_step_unchanged: one step in the middle of each pass does;
    noise_dropped: the sampler's steps leave out the noises they are given;
    half_batch: the CFG batch's uncond half is left out; token: a prompt
    token is altered where the tokenizer produces it; image: the image is
    altered where it is produced (AutoHDR's output)."""
    from lightdiffusion_next_tpu_torch.models.clip import t5_tokenizer, tokenizer
    from lightdiffusion_next_tpu_torch.sampling import cfg, samplers
    from lightdiffusion_next_tpu_torch.utils import hdr

    flux = "flux" in cell
    # the step function of the checked pass and its steps: Flux's Euler,
    # hires-fix's Euler-ancestral, SD1.5's first pass's DPM++ SDE
    name, steps = (("_euler_step", 20) if flux else ("_euler_step", 10) if "hires" in cell
                   else ("_dpmpp_sde_step", 20))
    if fault == "step_unchanged":
        orig = getattr(samplers, name)
        monkeypatch.setattr(samplers, name,
                            lambda carry, *a, **k: (carry[0],) + orig(carry, *a, **k)[1:])
    elif fault == "middle_step_unchanged":
        orig, calls = getattr(samplers, name), [0]

        def step(carry, *a, **k):
            out = orig(carry, *a, **k)
            calls[0] += 1
            return (carry[0],) + out[1:] if calls[0] % steps == steps // 2 else out

        monkeypatch.setattr(samplers, name, step)
    elif fault == "noise_dropped" and "hires" in cell:
        orig = samplers._euler_step
        monkeypatch.setattr(samplers, "_euler_step", lambda carry, *a, noise=None, **k: orig(
            carry, *a, noise=None if noise is None else noise * 0, **k))
    elif fault == "noise_dropped":
        orig = samplers._dpmpp_sde_step
        monkeypatch.setattr(samplers, "_dpmpp_sde_step", lambda carry, cs, den, n1, n2, **k: orig(
            carry, cs, den, n1 * 0, n2 * 0, **k))
    elif fault == "half_batch":
        monkeypatch.setattr(cfg, "cfg_result", lambda c, u, s: c)
    elif fault == "token" and flux:
        orig = t5_tokenizer.flux_t5_tokenize
        monkeypatch.setattr(t5_tokenizer, "flux_t5_tokenize",
                            lambda text, **k: [(7, 1.0)] + orig(text, **k)[1:])
    elif fault == "token":
        orig = tokenizer.SDTokenizer.tokenize_with_weights

        def altered(self, text, return_word_ids=False):
            rows = orig(self, text, return_word_ids)
            rows[0][1] = (320,) + tuple(rows[0][1][1:])
            return rows

        monkeypatch.setattr(tokenizer.SDTokenizer, "tokenize_with_weights", altered)
    else:
        orig = hdr.apply_hdr_batch
        monkeypatch.setattr(hdr, "apply_hdr_batch",
                            lambda images, **k: (orig(images, **k) + 0.03).clamp(0, 1))


@pytest.mark.parametrize("cell,fault", [
    ("tiny-sd15-txt2img", "step_unchanged"), ("tiny-sd15-txt2img", "middle_step_unchanged"),
    ("tiny-sd15-txt2img", "noise_dropped"), ("tiny-sd15-txt2img", "half_batch"),
    ("tiny-sd15-txt2img", "token"), ("tiny-sd15-txt2img", "image"),
    ("tiny-sd15-hires", "step_unchanged"), ("tiny-sd15-hires", "middle_step_unchanged"),
    ("tiny-sd15-hires", "noise_dropped"),
    ("tiny-flux-txt2img", "step_unchanged"), ("tiny-flux-txt2img", "middle_step_unchanged"),
    ("tiny-flux-txt2img", "token"), ("tiny-flux-txt2img", "image"),
])
def test_a_planted_fault_is_not_correct(root, monkeypatch, cell, fault):
    """Each fault the cell can have, planted in the timed path. (Flux runs
    at CFG 1, one batch half; no cell exchanges data between chips.)"""
    plant(monkeypatch, fault, cell)
    result = run(root, cell)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", ["tiny-sd15-hires", "tiny-flux-txt2img"])
def test_the_control_reads_above_the_program(root, name):
    from benchmark import control

    r = control.readings(tiny.cell(root, name), 5, 0.05, device="cpu")
    assert r["correct"] and r["control_correct"] is False
    for key, value in r["program"].items():
        assert r["control"][key] > 3 * value, (key, r)


def test_window_arithmetic_shows_a_stall():
    """s_per_image is all the window's time over all its images: a stall in
    one image moves it by the stall over the image count."""
    reader = manifest.load_module("metrics", "s_per_image")
    ends = np.cumsum([3.0] * 10)
    images = [{"start": e - 3.0, "end": e} for e in ends]
    steady = reader.read(NS(window_s=float(ends[-1]), images=images))
    stalled = [dict(i) for i in images]
    for i in stalled[4:]:
        i["start"] += 1.5 if i is not stalled[4] else 0.0
        i["end"] += 1.5
    slow = reader.read(NS(window_s=float(ends[-1]) + 1.5, images=stalled))
    assert steady == pytest.approx(3.0) and slow == pytest.approx(3.15)
    p95 = manifest.load_module("metrics", "step_ms.p95")
    gaps = [0.1] * 370 + [0.9] * 30  # a stall in 7.5% of the steps
    assert p95.read(NS(step_gaps=gaps)) == pytest.approx(900.0)
    assert p95.read(NS(step_gaps=[0.1] * 400)) == pytest.approx(100.0)


def test_device_timeline_is_the_union_of_the_device_intervals():
    """busy is the union of the profiler's device intervals, on its own
    clock; host events do not count; each idle gap is named after the
    kernel that ran before it."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(start, dur, name, kind=cuda):
        return NS(start_ns=lambda: start, duration_ns=lambda: dur, name=lambda: name,
                  device_type=lambda: kind)

    events = [ev(40, 10, "c"), ev(0, 10, "a"), ev(5, 10, "b"), ev(30, 5, "a"),
              ev(0, 100, "host", cpu)]
    prof = NS(profiler=NS(kineto_results=NS(events=lambda: events)))
    busy, top, gaps = harness.device_timeline(prof)
    assert busy == pytest.approx(30e-9)  # [0, 15], [30, 35], [40, 50]
    assert [n for n, _ in top] == ["a", "b", "c"] and top[0][1] == pytest.approx(15e-9)
    assert [n for n, _ in gaps] == ["after b", "after a"]
    assert [g for _, g in gaps] == pytest.approx([15e-9, 5e-9])


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in manifest.manifest()["workloads"]])
def test_the_control_fails_a_number_on_the_card(name):
    """The control at the cell's own size on three seeds: the harness's
    own judgement reads it not correct on each (it fails at least one
    compared number), while the program is correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run on the card")
    from benchmark import control

    cell = manifest.Cell(name)
    for seed in (31, 2**31 + 5, 977):
        r = control.readings(cell, seed, 1.0)
        assert r["correct"] and r["control_correct"] is False, r
