"""The port's spans (``utils/profiling.py``): off they record nothing, read
no clock and allocate nothing; on they nest per thread with one request id
per ``pipeline()`` call; the span tree of a tiny SD1.5 hires-fix call and a
tiny Flux call on the CPU (the kernels' plain versions); each kernel
wrapper's span per call; ``trace`` writes the span names into its Chrome
trace. Two tests need the card (``cuda``): the span clock against the
profiler's device clock, and every synchronising CUDA call of the two
pipelines inside a ``sync.*`` span. This file imports no JAX:

    python -m pytest tests/test_torch_tracing.py --noconftest -q
"""

import collections
import json
import os
import sys
import threading
import time
import tracemalloc
import warnings

import pytest
import torch

from lightdiffusion_next_tpu_torch import config
from lightdiffusion_next_tpu_torch.ops import flash_attention as fa
from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm
from lightdiffusion_next_tpu_torch.ops import sage_attention as sa
from lightdiffusion_next_tpu_torch.pipelines import pipeline as pl
from lightdiffusion_next_tpu_torch.utils import profiling

# every kernel wrapper: (module, name); each call is the span kernels.<name>
WRAPPERS = [(qm, n) for n in ("quant_matmul", "quant_matmul_stacked", "w8a8_matmul",
                              "w8a8_matmul_stacked", "w8a8_matmul_ep", "w8a8_matmul_ep_stacked",
                              "row_quantize_fused", "row_quantize_concat_gelu")] + [
    (fa, n) for n in ("flash_attention", "packed_flash_attention", "fused_qkv_attention")] + [
    (sa, "sage_attention"), (sa, "prepare_kernel")]
# a wrapper's launch counters on the card
COUNTERS = ("launches", "launches_bf16", "launches_interleaved", *sa.VARIANT_COUNTERS.values())


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny models are thousands of small ops: with one torch thread
    they run as fast as with many, and do not crowd the other test workers'
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tracing():
    """Spans on for the test, cleared before and after."""
    profiling.reset()
    profiling.enable(True)
    try:
        yield
    finally:
        profiling.enable(False)
        profiling.reset()


@pytest.fixture
def flux_runtime():
    """The card's Flux toggles, so that the CPU runs the W8A8 wrappers'
    plain versions, K3's and the stacked layout."""
    saved = config.get_config()
    config.set_config(config.RuntimeConfig(w8a8=True, fused_ew=True, flux_scan=True,
                                           fused_attn=True))
    try:
        yield
    finally:
        config.set_config(saved)


def tiny_sd15(device, unet_kw=None, vae_kw=None):
    from lightdiffusion_next_tpu_torch.models import base, unet
    from lightdiffusion_next_tpu_torch.models import vae as vae_mod
    from lightdiffusion_next_tpu_torch.models.clip import facade
    from lightdiffusion_next_tpu_torch.models.clip import text_encoder as te

    dev = config.resolve_device(device)
    ucfg = unet.UNetConfig(**(unet_kw or dict(
        model_channels=32, channel_mult=(1, 2), num_res_blocks=(1, 1),
        transformer_depth=(1, 1), transformer_depth_middle=1, context_dim=64, num_heads=2)),
        dtype=config.DtypePolicy.for_device(dev).param_dtype)
    vcfg = vae_mod.VAEConfig(**(vae_kw or dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)))
    model = base.sd15_model(unet.init_params(ucfg, seed=0), cfg=ucfg, device=dev)
    vae = vae_mod.VAE(vae_mod.init_params(vcfg, seed=1), vcfg, device=dev)
    clip = facade.sd1_clip_from_params(te.init_params(num_layers=2, width=64, heads=4, seed=2),
                                       device=dev)
    return dict(model=model, clip=clip, vae=vae)


def tiny_flux(device):
    from lightdiffusion_next_tpu_torch.models import base, flux
    from lightdiffusion_next_tpu_torch.models import vae as vae_mod
    from lightdiffusion_next_tpu_torch.models.clip import t5 as t5_mod
    from lightdiffusion_next_tpu_torch.models.clip import text_encoder as te

    dev = config.resolve_device(device)
    dtype = config.DtypePolicy.for_device(dev).compute_dtype
    fcfg = flux.FluxConfig(hidden_size=256, num_heads=2, depth=1, depth_single_blocks=1,
                           context_in_dim=256, vec_in_dim=64, axes_dim=(16, 56, 56))
    tcfg = t5_mod.T5Config(d_model=256, d_ff=512, num_heads=4, num_layers=1)
    model = base.flux_model(flux.random_params(fcfg, seed=3, device=dev, dtype=dtype),
                            cfg=fcfg, device=dev)
    t5 = t5_mod.T5XXLModel(t5_mod.random_params(tcfg, seed=4, device=dev, dtype=dtype),
                           cfg=tcfg, device=dev)
    clip = te.SDClipModel(te.init_params(num_layers=1, width=64, heads=4, seed=5,
                                         with_projection=True),
                          num_layers=1, heads=4, device=dev)
    vcfg = vae_mod.VAEConfig(ch=32, ch_mult=(1, 2), num_res_blocks=1, z_channels=16,
                             has_quant_conv=False)
    vae = vae_mod.VAE(vae_mod.init_params(vcfg, seed=6), vcfg, device=dev)
    return dict(model=model, clip=clip, vae=vae, t5=t5)


def run_pipeline(tmp_path, models, size, **kw):
    os.environ.setdefault("LDT_OFFLINE", "1")
    with torch.no_grad():
        return pl.pipeline("a cat on a mat", size, size, seed=11, output_dir=str(tmp_path),
                           device=models["model"].device,
                           progress_callback=lambda info: None, **models, **kw)


def tree(records):
    """parent id -> its children's records in the order they opened."""
    kids = collections.defaultdict(list)
    for r in sorted(records, key=lambda r: (r[4], r[0])):
        kids[r[1]].append(r)
    return kids


def names(records):
    return [r[3] for r in records]


def counting_wrappers(monkeypatch):
    """Each wrapper's module global replaced by a counter of its calls."""
    calls = collections.Counter()
    for mod, name in WRAPPERS:
        orig = getattr(mod, name)

        def counted(*args, _orig=orig, _name=name, **kwargs):
            calls[_name] += 1
            return _orig(*args, **kwargs)

        monkeypatch.setattr(mod, name, counted)
    return calls


def kernel_span_counts(records):
    return collections.Counter(r[3][len("kernels."):] for r in records
                               if r[3].startswith("kernels."))


# --- the tracer ---------------------------------------------------------------


def test_off_records_nothing_reads_no_clock_and_allocates_nothing(monkeypatch):
    profiling.enable(False)
    profiling.reset()

    def no_clock():
        raise AssertionError("a clock was read with tracing off")

    monkeypatch.setattr(profiling, "_clock", no_clock)
    assert profiling.span("a") is profiling.span("b") is profiling.request("pipeline")

    @profiling.kernel_span("kernels.k")
    def k(x):
        return x + 1

    def work(n):
        for _ in range(n):
            with profiling.span("pipeline.x"):
                with profiling.span("sync.y"):
                    pass
            k(1)

    def peak_bytes(n):
        """The most the host heap grew during n rounds, and what stayed."""
        tracemalloc.start()
        try:
            before = tracemalloc.get_traced_memory()[0]
            tracemalloc.reset_peak()
            work(n)
            current, peak = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
        return peak - before, current - before

    work(100)  # warm: the first calls may fill caches
    device_before = torch.cuda.memory_allocated() if torch.cuda.is_available() else 0
    few, many = peak_bytes(10), peak_bytes(10000)
    # the loop's own few hundred bytes, the same for 10 rounds as for 10000
    assert many[0] <= few[0] + 64 and many[1] <= 0, (few, many)
    assert profiling.spans() == []
    if torch.cuda.is_available():
        assert torch.cuda.memory_allocated() == device_before
    else:
        assert not torch.cuda.is_initialized()


def test_spans_nest_with_parents_requests_and_per_thread_stacks(tracing):
    barrier = threading.Barrier(2, timeout=30)
    idents = {}

    def body(tag):
        idents[tag] = threading.get_ident()
        with profiling.request("pipeline"):
            barrier.wait()
            with profiling.span(f"{tag}.outer"):
                barrier.wait()
                with profiling.span(f"{tag}.inner"):
                    barrier.wait()
        with profiling.span(f"{tag}.after"):
            pass

    threads = [threading.Thread(target=body, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    with profiling.request("pipeline"):
        with profiling.span("main.inner"):
            pass

    records = profiling.spans()
    assert len(records) == 10 and len({r[0] for r in records}) == 10
    requests = set()
    for tag in ("a", "b"):
        mine = {r[3]: r for r in profiling.spans(idents[tag])}
        assert set(mine) == {"pipeline", f"{tag}.outer", f"{tag}.inner", f"{tag}.after"}
        root, outer, inner = mine["pipeline"], mine[f"{tag}.outer"], mine[f"{tag}.inner"]
        assert root[1] is None and outer[1] == root[0] and inner[1] == outer[0]
        assert root[2] == outer[2] == inner[2] is not None
        assert mine[f"{tag}.after"][1:3] == (None, None)  # outside any request
        assert root[4] <= outer[4] <= inner[4] <= inner[5] <= outer[5] <= root[5]
        requests.add(root[2])
    main = {r[3]: r for r in profiling.spans(threading.get_ident())}
    assert main["main.inner"][1] == main["pipeline"][0]
    requests.add(main["pipeline"][2])
    assert len(requests) == 3
    profiling.reset()
    assert profiling.spans() == []


def test_spans_from_many_threads_lose_nothing(tracing):
    """More threads than cores, switching often: every span recorded once,
    with a unique id, under its own thread's parent and request."""
    n_threads, rounds = 2 * (os.cpu_count() or 4), 300
    idents, errors = {}, []
    # every thread stays alive until all are done, so that no two share an
    # ident (an ended thread's ident may be given to a new one)
    done = threading.Barrier(n_threads, timeout=60)

    def body(k):
        idents[k] = threading.get_ident()
        try:
            for _ in range(rounds):
                with profiling.request("pipeline"):
                    with profiling.span(f"t{k}"):
                        pass
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)
        done.wait()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=body, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    records = profiling.spans()
    assert len(records) == 2 * n_threads * rounds == len({r[0] for r in records})
    assert len({r[2] for r in records}) == n_threads * rounds
    for k in range(n_threads):
        mine = profiling.spans(idents[k])
        roots = {r[0]: r for r in mine if r[3] == "pipeline"}
        inner = [r for r in mine if r[3] == f"t{k}"]
        assert len(roots) == len(inner) == rounds
        assert all(roots[r[1]][2] == r[2] for r in inner)


def test_a_tiny_sd15_hires_call_gives_the_span_tree(tmp_path, tracing, monkeypatch):
    monkeypatch.setenv("LDT_ASSET_ROOT", str(tmp_path / "assets"))
    models = tiny_sd15("cpu")
    paths = run_pipeline(tmp_path, models, 64, hires_fix=True)
    assert len(paths) == 1
    records = profiling.spans(threading.get_ident())
    kids = tree(records)
    (root,) = kids[None]
    assert root[3] == "pipeline" and root[2] is not None
    assert all(r[2] == root[2] for r in records)
    top = [n for n in names(kids[root[0]]) if not n.startswith("sync.")]
    assert top == ["pipeline.encode", "sampling.ksample", "pipeline.upscale",
                   "sampling.ksample", "pipeline.decode", "pipeline.hdr", "pipeline.save"]
    by_name = {}
    for r in kids[root[0]]:
        by_name.setdefault(r[3], []).append(r)
    assert names(kids[by_name["pipeline.encode"][0][0]]) == ["models.clip"] * 2
    first, hires = by_name["sampling.ksample"]
    for ks, steps, calls in ((first, 20, 39), (hires, 10, 10)):
        sub = names(kids[ks[0]])
        assert sub[0] == "sampling.noise"
        assert sub.count("models.unet") == calls and sub.count("callback") == steps
    assert names(kids[by_name["pipeline.upscale"][0][0]]) == ["sync.upscale_readback",
                                                              "sync.upscale_upload"]
    assert names(kids[by_name["pipeline.decode"][0][0]]) == ["models.vae"]
    assert names(kids[by_name["pipeline.save"][0][0]]) == ["sync.readback", "pipeline.png"]


def test_a_tiny_flux_call_gives_the_span_tree_and_a_kernel_span_per_call(
        tmp_path, tracing, monkeypatch, flux_runtime):
    monkeypatch.setenv("LDT_ASSET_ROOT", str(tmp_path / "assets"))
    models = tiny_flux("cpu")
    calls = counting_wrappers(monkeypatch)
    paths = run_pipeline(tmp_path, models, 64, flux_enabled=True)
    assert len(paths) == 1
    records = profiling.spans(threading.get_ident())
    kids = tree(records)
    (root,) = kids[None]
    assert root[3] == "pipeline"
    top = names(kids[root[0]])
    assert top == ["pipeline.encode", "sampling.ksample", "pipeline.decode", "pipeline.hdr",
                   "pipeline.save"]
    encode, ks, decode, hdr, save = kids[root[0]]
    assert names(kids[encode[0]]) == ["models.clip", "models.t5"]
    sub = names(kids[ks[0]])
    # 20 steps and the dy steps' two half-resolution calls
    assert sub[0] == "sampling.noise" and sub.count("models.dit") == 22
    assert sub.count("callback") == 20
    dits = [r for r in kids[ks[0]] if r[3] == "models.dit"]
    assert all(any(c[3].startswith("kernels.") for c in kids[d[0]]) for d in dits)
    # FBCache reads its gate on the host in every call with a previous
    # residual: all but the first of the loop's state and the dy calls' two
    gates = sum(names(kids[d[0]]).count("sync.fbcache_gate") for d in dits)
    assert gates == 19
    assert names(kids[decode[0]]) == ["models.vae"]
    assert names(kids[save[0]]) == ["sync.readback", "pipeline.png"]
    spans_by_wrapper = kernel_span_counts(records)
    assert spans_by_wrapper == calls and calls["w8a8_matmul_ep_stacked"] > 0
    assert calls["fused_qkv_attention"] > 0 and calls["row_quantize_fused"] > 0


def test_trace_writes_the_span_names_into_the_chrome_trace(tmp_path):
    profiling.reset()
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.request("pipeline"):
            with profiling.span("pipeline.encode"):
                torch.ones(8, 8) @ torch.ones(8, 8)
    assert not profiling._enabled  # off again after the block
    recorded = names(profiling.spans(threading.get_ident()))
    assert recorded == ["pipeline.encode", "pipeline"]
    (path,) = os.listdir(tmp_path / "trace")
    with open(tmp_path / "trace" / path) as f:
        events = json.load(f)["traceEvents"]
    seen = {e.get("name") for e in events}
    assert {"pipeline", "pipeline.encode"} <= seen
    profiling.reset()


# --- on the card ------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device clock and the device's syncs")
    return config.resolve_device("cuda")


@pytest.mark.cuda
def test_span_clock_contains_the_matmul_kernel(cuda, tracing):
    """A span around a large matmul and a synchronize contains the
    matmul's device interval as the profiler records it (CUDA activity
    alone, as the benchmark's traced run): the two clocks are one."""
    a = torch.randn(8192, 8192, device=cuda, dtype=torch.bfloat16)
    a @ a
    torch.cuda.synchronize()
    offsets = []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with profiling.span("clock"):
                a @ a
                torch.cuda.synchronize()
            time.sleep(0.02)
    clocks = [r for r in profiling.spans(threading.get_ident()) if r[3] == "clock"]
    kernels = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                     for e in prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA
                     and e.duration_ns() > 10**5)
    assert len(clocks) == 3 and len(kernels) >= 3
    for (_, _, _, _, s0, s1), (k0, k1) in zip(sorted(clocks, key=lambda r: r[4]), kernels):
        offsets.append((k0 - s0, s1 - k1))
        assert s0 <= k0 and k1 <= s1, (s0, k0, k1, s1)
    print("kernel start - span start, span end - kernel end (ns):", offsets)


# synchronising calls with no span of their own, (file, function) of the
# innermost frame of the port, each with the reason
UNSPANNED = {
    ("model_sampling.py", "_table"): "the sigma table's one copy to a device, cached for the "
                                     "process: the warm-up image makes it, no timed image does",
}


@pytest.mark.cuda
def test_every_sync_of_the_pipelines_is_a_sync_span(cuda, tracing, tmp_path, monkeypatch):
    """One small SD1.5 hires-fix call and one small Flux call on the card
    under ``torch.cuda.set_sync_debug_mode("warn")``: every synchronising
    CUDA call but those of ``UNSPANNED`` happens inside a ``sync.*`` span,
    and every ``sync.*`` span holds one (the differences are listed with
    their stacks). Each wrapper's span count equals its launch counters'
    move."""
    import traceback

    monkeypatch.setenv("LDT_ASSET_ROOT", str(tmp_path / "assets"))
    sd15 = tiny_sd15(cuda, unet_kw=dict(
        model_channels=160, channel_mult=(1, 2), num_res_blocks=(1, 1),
        transformer_depth=(1, 1), transformer_depth_middle=1, context_dim=64, num_heads=4),
        vae_kw=dict(ch=128, ch_mult=(1, 4), num_res_blocks=1))
    flux_models = tiny_flux(cuda)
    found = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        stack = profiling._local.stack
        frames = [f for f in traceback.extract_stack()[:-1]]
        ours = [f for f in frames if "lightdiffusion_next_tpu_torch" in f.filename] or frames
        site = (os.path.basename(ours[-1].filename), ours[-1].name)
        if site not in UNSPANNED:
            found.append((stack[-1][0] if stack else None,
                          [f"{os.path.basename(f.filename)}:{f.lineno}:{f.name}"
                           for f in ours[-4:]]))

    before = {name: sum(getattr(getattr(mod, name), c, 0) for c in COUNTERS)
              for mod, name in WRAPPERS}
    with warnings.catch_warnings():  # restores showwarning and the filters
        warnings.showwarning = hook
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run_pipeline(tmp_path, sd15, 256, hires_fix=True)
            run_pipeline(tmp_path, flux_models, 256, flux_enabled=True)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    records = profiling.spans(threading.get_ident())
    by_id = {r[0]: r for r in records}
    syncs = {r[0] for r in records if r[3].startswith("sync.")}
    outside = collections.Counter(
        " <- ".join(reversed(frames)) for sid, frames in found if sid not in syncs)
    covered = {sid for sid, _ in found}
    empty = collections.Counter(by_id[s][3] for s in syncs - covered)
    print("sync spans:", collections.Counter(by_id[s][3] for s in syncs))
    assert not outside and not empty, (outside, empty)
    launched = {name: sum(getattr(getattr(mod, name), c, 0) for c in COUNTERS) - before[name]
                for mod, name in WRAPPERS}
    spanned = kernel_span_counts(records)
    # w8a8_matmul_ep hands the scan layout's (q3, idx) operand to
    # w8a8_matmul_ep_stacked, which counts the launch: a span with that
    # child launched nothing of its own
    kids = tree(records)
    spanned["w8a8_matmul_ep"] -= sum(
        1 for r in records if r[3] == "kernels.w8a8_matmul_ep"
        and any(c[3] == "kernels.w8a8_matmul_ep_stacked" for c in kids[r[0]]))
    assert {n: spanned.get(n, 0) for n in launched} == launched
    assert launched["w8a8_matmul_ep_stacked"] > 0 and launched["packed_flash_attention"] > 0
