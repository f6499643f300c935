"""One run of one cell: set-up, the timed window, the comparison with the
plain reference, and the result line.

The window is one client in a closed loop: ``pipeline()`` for one image,
then the next, until an image would start after ``--seconds``; it ends
with the last image's PNG written. With ``--trace 1`` the same window runs
with the recording this file adds around the program's layers: each
``ksample`` call and sampler step timed with a device synchronisation,
every model call's shapes, CUDA events around each kernel wrapper the
per-layer metrics name (on the window's first image), and
``torch.profiler`` over the window's other images. The
recording lives here, around the program's entry points; nothing is added
inside the program.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import importlib
import json
import math
import os
import random
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "lightdiffusion_next_tpu")


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def derived_seed(seed: int, *parts) -> int:
    """A seed in [1, 2**63 - 1] drawn from the run's seed and ``parts``."""
    text = "/".join(str(p) for p in (int(seed),) + parts)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8], "little") % (2**63 - 1) + 1


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Request:
    index: int
    prompt: int
    text: str
    seed: int


class Traffic:
    """The traffic file's requests: prompt ``i`` of the prompt list and the
    image's seed, both drawn from the run's seed and the image's index."""

    def __init__(self, spec: dict, prompts: dict, seed: int):
        self.spec, self.prompts, self.seed = spec, prompts["prompts"], seed

    def request(self, index: int) -> Request:
        p = derived_seed(self.seed, "prompt", index) % len(self.prompts)
        return Request(index, p, self.prompts[p]["text"], derived_seed(self.seed, "image", index))


@dataclasses.dataclass
class Capture:
    """What the checked image's timed path produced: per ``ksample`` pass
    its arguments, the initial noise and the per-step noises it drew, the
    sampler's state where it starts, its state and denoised latent after
    every step, every model call's input and output by step, and its
    result; and the saved PNG."""

    prompt: int = -1
    passes: List[dict] = dataclasses.field(default_factory=list)
    png: Optional[str] = None


class Recorder:
    """The recording around the program's entry points (see the module's
    docstring)."""

    def __init__(self, family, config: dict, traffic: dict, seed: int, trace: bool,
                 check_index: int):
        import torch

        self.torch = torch
        self.family, self.config, self.traffic = family, config, traffic
        self.seed, self.trace, self.check_index = seed, trace, check_index
        self.recording = False
        self.image: Optional[int] = None
        self.capture = Capture()
        self.images: List[dict] = []
        self.step_gaps: List[float] = []
        self.model_calls: List[tuple] = []
        self.op_calls: List[tuple] = []
        self._patches: List[tuple] = []
        self._pass: Optional[dict] = None
        self._step = 0  # the sampler step the next model call belongs to
        self._step_times: List[float] = []
        self._depth = 0
        # traced runs: kernel calls are timed on the window's first image,
        # model calls counted and the device profiled on the others
        self.op_timing = False
        self.profiled = False

    # -- patching ----------------------------------------------------------
    def patch(self, module, name: str, make: Callable):
        orig = getattr(module, name)
        wrapped = make(orig)
        for attr in ("launches", "launches_interleaved", "launches_bf16"):
            if hasattr(orig, attr):
                setattr(wrapped, attr, getattr(orig, attr))
        setattr(module, name, wrapped)
        self._patches.append((module, name, orig))

    def restore(self):
        for module, name, orig in reversed(self._patches):
            setattr(module, name, orig)
        self._patches.clear()

    def sync(self):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()

    def timed(self) -> bool:
        return self.trace and self.recording

    # -- the sampler -------------------------------------------------------
    def install_sampler(self):
        from lightdiffusion_next_tpu_torch.sampling import ksampler, noise, samplers

        def make(orig):
            def ksample(model, **kw):
                checked = self.recording and self.image == self.check_index
                rec = None
                if checked:
                    n = int(kw["steps"])
                    rng = random.Random(derived_seed(self.seed, "check", len(self.capture.passes)))
                    model_steps = self.family.check_steps(
                        self.config, self.traffic, len(self.capture.passes), n, rng)
                    rec = {"kw": {k: kw.get(k) for k in ("positive", "negative", "latent_image",
                                                          "steps", "cfg_scale", "denoise")},
                           "n": n, "model_steps": model_steps, "steps": {}, "calls": {}}
                    self.capture.passes.append(rec)
                self._pass = rec
                self._step = 0
                self._step_times = []
                if self.timed():
                    self.sync()
                    t0 = time.perf_counter()
                res = orig(model, **kw)
                if self.timed():
                    self.sync()
                    t1 = time.perf_counter()
                    img = self.images[-1]
                    img["sampler_s"] += t1 - t0
                    img["steps"] += len(self._step_times)
                    ts = self._step_times
                    self.step_gaps += [b - a for a, b in zip(ts, ts[1:])]
                if rec is not None:
                    rec["latent"] = res.latent
                self._pass = None
                return res

            return ksample

        self.patch(ksampler, "ksample", make)

        def make_noise(orig):
            def prepare_noise(*args, **kwargs):
                out = orig(*args, **kwargs)
                if self._pass is not None:
                    self._pass["init_noise"] = out
                return out

            return prepare_noise

        def make_sample(orig):
            def sample(denoise_fn, x, sigmas, **kwargs):
                rec = self._pass
                if rec is not None:
                    rec["x0"] = x
                    rec["sde_noise"], rec["step_noise"] = (kwargs.get("sde_noise"),
                                                           kwargs.get("step_noise"))
                return orig(denoise_fn, x, sigmas, **kwargs)

            return sample

        self.patch(noise, "prepare_noise", make_noise)
        self.patch(samplers, "sample", make_sample)

    def on_step(self, info: dict):
        """The pipeline's progress callback: after every sampler step."""
        if self.timed():
            self.sync()
            self._step_times.append(time.perf_counter())
        self._step = info["i"] + 1
        rec = self._pass
        if rec is not None:
            rec["steps"][info["i"]] = (info["x"], info["denoised"], float(info["sigma"]))

    # -- model calls and kernels (traced runs) -----------------------------
    def model_call(self, kind: str, section: str, fn: Callable, info: Callable,
                   capture: bool = False) -> Callable:
        """``fn`` recording ``(kind, section, info(args, kwargs, out))`` per
        call in a traced window: ``benchmark/flops/<kind>.py`` counts its
        operations from the configuration's ``section`` and ``info``. With
        ``capture`` (a denoiser's model), every call of the checked image's
        passes keeps its input (x, t, context) and output, in order, under
        the sampler step it belongs to."""

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.timed() and self.profiled:
                self.model_calls.append((kind, section, info(args, kwargs, out)))
            rec = self._pass
            if capture and rec is not None:
                rec["calls"].setdefault(self._step, []).append((args[1], args[2], args[3], out))
            return out

        return wrapped

    def install_ops(self, ops: List[str], bench_dir: str):
        from benchmark import manifest

        for op in ops:
            mod = manifest.load_module("rooflines", op, bench_dir)
            target = importlib.import_module(mod.TARGET[0])

            def make(orig, op=op, mod=mod):
                def wrapped(*args, **kwargs):
                    if not (self.op_timing and self.recording) or self._depth:
                        self._depth += 1
                        try:
                            return orig(*args, **kwargs)
                        finally:
                            self._depth -= 1
                    Event = self.torch.cuda.Event
                    e0, e1 = Event(enable_timing=True), Event(enable_timing=True)
                    info = mod.shapes(*args, **kwargs)
                    self._depth += 1
                    e0.record()
                    try:
                        out = orig(*args, **kwargs)
                    finally:
                        e1.record()
                        self._depth -= 1
                    self.op_calls.append((op, mod, info, e0, e1))
                    return out

                return wrapped

            self.patch(target, mod.TARGET[1], make)


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read."""

    cell: str
    config: dict
    setup_s: float
    window_s: float
    images: List[dict]
    peak_bytes: int
    step_gaps: List[float]
    model_calls: List[tuple]
    op_calls: List[tuple]  # (op, bound s, device s)
    profiled_s: float  # traced runs: the span of the images after the first
    device: dict
    bench_dir: str


def device_timeline(prof):
    """(busy seconds, [(kernel name, seconds)] top 10, [(name, seconds)]
    top 10 idle gaps) of the device activity the profiler recorded. The
    profiler runs from a synchronised start to a synchronised stop around
    the profiled images, so every interval it holds lies in that span:
    busy is the union of all of them, on the profiler's own clock. An idle
    gap between two intervals is named after the kernel that ran before
    it ("after <name>"), and gaps are summed by that name."""
    import torch

    evs = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                 for e in prof.profiler.kineto_results.events()
                 if e.device_type() == torch.autograd.DeviceType.CUDA)
    by_name: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    busy_ns, end, last = 0, None, None
    for s, e, n in evs:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-9
        if end is None or s > end:
            if end is not None:
                gaps["after " + last] = gaps.get("after " + last, 0.0) + (s - end) * 1e-9
            busy_ns += e - s
            end, last = e, n
        elif e > end:
            busy_ns += e - end
            end, last = e, n
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]
    return busy_ns * 1e-9, top(by_name), top(gaps)


def judge(checks: dict, limits: dict, failed: int = 0) -> bool:
    """``correct``: every image completed, and every compared number is
    finite and within its limit."""
    return failed == 0 and bool(checks) and all(
        name in limits and math.isfinite(v) and v <= limits[name] for name, v in checks.items())


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             control: bool = False) -> int:
    """One run; prints the result line on stdout and returns the exit code.
    ``control``: also read the compared numbers of the control (the
    reference one precision step down) in the program's place, under
    ``"control"`` in the result, and judge them as ``correct`` is judged,
    under ``"control_correct"``; the benchmark's own runs never do."""
    setup_started = time.perf_counter() - process_age_s()
    scratch = tempfile.mkdtemp(prefix="ldt-bench-")
    os.environ["LDT_ASSET_ROOT"] = os.path.join(scratch, "assets")
    os.environ["LDT_OFFLINE"] = "1"
    try:
        return _run(cell, seed, seconds, trace, device, setup_started, scratch, control)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def _run(cell, seed, seconds, trace, device, setup_started, scratch, control) -> int:
    import torch

    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            log(f"benchmark: needs {cell.chips} CUDA device(s), found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        torch.cuda.set_device(0)
    from lightdiffusion_next_tpu_torch.pipelines import pipeline as pl

    fam, cfg = cell.family, cell.config
    fam.configure(cfg)
    models = fam.build(cfg, seed, device)
    traffic = Traffic(cell.traffic, cell.prompts, seed)
    check_rng = random.Random(derived_seed(seed, "checked image"))
    check_index = check_rng.randrange(int(cell.traffic["checked_image_among_first"]))
    rec = Recorder(fam, cfg, cell.traffic, seed, trace, check_index)
    rec.install_sampler()
    if trace and device == "cuda":
        ops = sorted({op for r in cell.readers.values() for op in getattr(r, "OPS", ())})
        rec.install_ops(ops, cell.bench_dir)
    fam.instrument(models, rec)
    out_dir = os.path.join(scratch, "images")

    def generate(req: Request):
        random.seed(req.seed)
        with torch.no_grad():
            paths = pl.pipeline(req.text, cell.traffic["width"], cell.traffic["height"],
                                seed=req.seed, output_dir=out_dir, progress_callback=rec.on_step,
                                **fam.pipeline_kwargs(models, cell.traffic))
        return paths

    try:
        generate(traffic.request(-1))  # warm-up: every shape of the window
        rec.sync()
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - setup_started
        log(f"benchmark: set-up {setup_s:.3f} s; checked image {check_index}")

        profiling = trace and device == "cuda"
        prof = None
        attempted = failed = 0
        rec.recording = True
        t0 = time.perf_counter()
        # every run completes the checked image; a traced run also one
        # profiled image after the first
        while (attempted <= max(check_index, int(trace)) or time.perf_counter() - t0 < seconds):
            if profiling and attempted == 1:
                rec.sync()
                prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
                prof.__enter__()
                p0 = time.perf_counter()
            rec.op_timing = trace and attempted == 0
            rec.profiled = trace and attempted >= 1
            req = traffic.request(attempted)
            rec.image = attempted
            start = time.perf_counter() - t0
            rec.images.append({"start": start, "sampler_s": 0.0, "steps": 0})
            attempted += 1
            try:
                paths = generate(req)
            except Exception:
                failed += 1
                log(f"benchmark: image {req.index} failed:\n{traceback.format_exc()}")
                paths = []
            rec.images[-1]["end"] = time.perf_counter() - t0
            if req.index == check_index and paths:
                rec.capture.prompt, rec.capture.png = req.prompt, paths[0]
        rec.sync()
        window_s = time.perf_counter() - t0
        if prof is not None:
            prof_s = time.perf_counter() - p0
            prof.__exit__(None, None, None)
        rec.recording = False
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        dev = {"platform": "gpu" if device == "cuda" else "cpu",
               "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
               "count": cell.chips if device == "cuda" else 0,
               "memory_peak_bytes": int(peak)}
        breakdown = None
        if prof is not None:
            busy, top, gaps = device_timeline(prof)
            del prof
            if not busy > 0:
                log("benchmark: the profiler recorded no device activity in the traced window")
                return 4
            dev["busy_s"], dev["window_s"] = busy, prof_s
            breakdown = {"device_ops": [[n, s] for n, s in top],
                         "idle_gaps": [[n, s] for n, s in gaps]}
    finally:
        rec.restore()
    bad = forbidden_modules()
    if bad:
        log(f"benchmark: JAX or the JAX package was imported: {', '.join(bad)}")
        return 3

    ops = [(op, mod.bound_s(info), e0.elapsed_time(e1) * 1e-3)
           for op, mod, info, e0, e1 in rec.op_calls]
    imgs = rec.images
    profiled_s = imgs[-1]["end"] - imgs[1]["start"] if trace and len(imgs) > 1 else 0.0
    record = RunRecord(cell.name, cfg, setup_s, window_s, imgs, peak, rec.step_gaps,
                       rec.model_calls, ops, profiled_s, dev, cell.bench_dir)
    capture = rec.capture
    del models, rec, generate
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    checks, control_checks = {}, None
    if capture.png is not None and len(capture.passes):
        t_check = time.perf_counter()
        checks = fam.check(cfg, cell.traffic, cell.prompts, seed, device, capture, control=False)
        log(f"benchmark: reference comparison took {time.perf_counter() - t_check:.1f} s")
        if control:
            control_checks = fam.check(cfg, cell.traffic, cell.prompts, seed, device, capture,
                                       control=True)
    correct = judge(checks, cell.limits, failed)

    metrics = {}
    for m in cell.metrics(trace):
        value = cell.readers[m["name"]].read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control_checks is not None:
        result["control"] = control_checks
        result["control_correct"] = judge(control_checks, cell.limits)
    result["checks"] = {n: {"value": v, "limit": cell.limits.get(n)} for n, v in checks.items()}
    log(f"benchmark: {attempted} images in {window_s:.3f} s, {failed} failed; "
        f"image walls {[round(i['end'] - i['start'], 4) for i in record.images]}")
    for n, v in checks.items():
        log(f"check {n}: {v!r} (limit {cell.limits.get(n)!r})")
    print(json.dumps(result), flush=True)
    return 0
