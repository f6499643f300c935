"""Ranks of the port's tensor-parallel tests: 2 processes with gloo on the
CPU, spawned by ``spawn``. This module imports torch and the port only, so
the children neither collect tests nor import JAX; the tests compute the
JAX references in their own process.

Each worker gets its rank and the arguments it was spawned with and
returns a picklable result (numpy arrays, numbers), which ``spawn`` hands
back per rank.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lightdiffusion_next_tpu_torch import config as tconfig
from lightdiffusion_next_tpu_torch.models import base as tbase
from lightdiffusion_next_tpu_torch.models import flux as tflux
from lightdiffusion_next_tpu_torch.ops import ggml
from lightdiffusion_next_tpu_torch.parallel import layout, sharding, spmd
from lightdiffusion_next_tpu_torch.parallel import mesh as mesh_mod

WORLD = 2
COLLECTIVES = ("broadcast", "all_gather", "all_gather_into_tensor", "reduce_scatter",
               "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "gather",
               "scatter", "reduce", "barrier", "send", "recv")


def _entry(rank, worker, store, out, args, gloo_timeout):
    t0 = time.perf_counter()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD), rank=rank,
                            world_size=WORLD,
                            timeout=datetime.timedelta(seconds=gloo_timeout))
    try:
        result = worker(rank, *args)
        torch.save((result, time.perf_counter() - t0), os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


# seconds each rank's worker took, from its process's start of work to its
# result (imports excluded), per worker name: the last spawn's. The tests
# record them in the JUnit XML as the property "rank_seconds".
SECONDS: dict = {}


class Ranks:
    """Two gloo ranks running ``worker(rank, *args)`` (``start``)."""

    def __init__(self, worker, tmp_path, args, timeout, gloo_timeout):
        self.name, self.out, self.timeout = worker.__name__, str(tmp_path), timeout
        store = os.path.join(self.out, "store")
        self.ctx = mp.start_processes(_entry,
                                      args=(worker, store, self.out, args, gloo_timeout),
                                      nprocs=WORLD, join=False, start_method="spawn")
        self.deadline = time.monotonic() + timeout

    def join(self):
        """The per-rank results (their seconds in ``SECONDS``). Raises if a
        rank fails, or kills both and raises TimeoutError at the deadline,
        so a divergence fails instead of hanging."""
        while not self.ctx.join(timeout=0.2):
            if time.monotonic() > self.deadline:
                self.kill()
                raise TimeoutError(f"{self.name}: ranks still running after {self.timeout} s")
        res = [torch.load(os.path.join(self.out, f"rank{r}.pt"), weights_only=False)
               for r in range(WORLD)]
        SECONDS[self.name] = [s for _, s in res]
        return [r for r, _ in res]

    def kill(self):
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()


def start(worker, tmp_path, *args, timeout=300.0, gloo_timeout=60.0) -> Ranks:
    """Start ``worker(rank, *args)`` on 2 gloo ranks and return at once, so
    the caller can work while they run; ``Ranks.join`` waits. The ranks'
    own seconds are 11-14 alone and 17-26 in the whole suite on six
    workers (``SECONDS``), so the ``timeout`` deadline leaves over ten
    times that."""
    return Ranks(worker, tmp_path, args, timeout, gloo_timeout)


def spawn(worker, tmp_path, *args, **kw):
    """``start`` and ``join``: the per-rank results."""
    return start(worker, tmp_path, *args, **kw).join()


@dataclasses.dataclass
class Counts:
    """Collectives made while it is active: the all-reduce wrapper's calls
    and widths (the forward's; the backward's apart), raw
    ``dist.all_reduce`` calls and every other collective."""

    calls: int = 0
    widths: dict = dataclasses.field(default_factory=dict)
    raw_all_reduce: int = 0
    others: int = 0
    backward_calls: int = 0
    backward_widths: dict = dataclasses.field(default_factory=dict)


class counting:
    """Count the collectives of a block of code (see ``Counts``)."""

    def __enter__(self):
        self.counts = Counts()
        self.saved = {n: getattr(dist, n) for n in ("all_reduce",) + COLLECTIVES}
        counts = self.counts

        def wrap(name, fn):
            def f(*a, **k):
                if name == "all_reduce":
                    counts.raw_all_reduce += 1
                else:
                    counts.others += 1
                return fn(*a, **k)
            return f

        for n, fn in self.saved.items():
            setattr(dist, n, wrap(n, fn))
        mesh_mod.reset_counts()
        return self.counts

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(dist, n, fn)
        self.counts.calls = mesh_mod.all_reduce.calls
        self.counts.widths = dict(mesh_mod.all_reduce.widths)
        self.counts.backward_calls = mesh_mod.all_reduce.backward_calls
        self.counts.backward_widths = dict(mesh_mod.all_reduce.backward_widths)


@dataclasses.dataclass
class Config:
    """Both packages' RuntimeConfig fields for a block of code (restored)."""

    fields: dict

    def __enter__(self):
        self.saved = tconfig.get_config()
        tconfig.set_config(dataclasses.replace(self.saved, **self.fields))

    def __exit__(self, *exc):
        tconfig.set_config(self.saved)


def host_sd(params, q8):
    """Host state dict: numpy leaves, the keys of ``q8`` as ``QTensor8``
    records of the given (codes, scales)."""
    sd = {k: np.asarray(v, np.float32) for k, v in params.items()}
    for k, (q, s) in q8.items():
        sd[k] = ggml.QTensor8(q=torch.from_numpy(np.asarray(q)),
                              scales=torch.from_numpy(np.asarray(s, np.float32)),
                              shape=tuple(params[k].shape))
    return sd


def tp_model(sd, cfg, mesh, fused=False):
    """The loader's flow on a host state dict: the RoPE permute (``fused``),
    the TP layout, this rank's slices in f32 on the CPU, the forward."""
    if fused:
        sd = layout.permute_rope_basis_rows(sd, cfg)
    sd, lcfg = layout.to_tp_layout(dict(sd), cfg)
    lcfg = spmd.tp_config(dataclasses.replace(lcfg, fused_attn=fused), mesh)
    p = sharding.shard_state_dict(sd, mesh, dtype=torch.float32, device="cpu")
    return tbase.flux_bundle(tbase.f32_qk_norms(p), lcfg, torch.device("cpu"))


def _t(x):
    return torch.from_numpy(np.array(x))


def _forward(model, inputs, params=None):
    x, t, ctx, y = (_t(a) for a in inputs)
    with counting() as counts:
        out = model.apply_fn(model.params if params is None else params, x, t, ctx, y)
    return out.numpy(), counts


def spmd_worker(rank, data):
    """Every case of ``test_torch_spmd.py`` on this rank: {case: result}."""
    from lightdiffusion_next_tpu_torch.models import lora as tlora
    from lightdiffusion_next_tpu_torch.models import unet as tunet
    from lightdiffusion_next_tpu_torch.parallel import inference
    from lightdiffusion_next_tpu_torch.sampling import cfg as cfg_mod
    from lightdiffusion_next_tpu_torch.sampling import fbcache as fb_mod
    from lightdiffusion_next_tpu_torch.sampling import ksampler as ks

    data = torch.load(data, weights_only=False)
    cfg = tflux.FluxConfig(**data["cfg"])
    mesh = inference.inference_mesh()
    inputs = data["inputs"]
    res = {}

    model = tp_model(host_sd(data["params"], {}), cfg, mesh)
    res["dense"], res["dense_counts"] = _forward(model, inputs)

    q8 = tp_model(host_sd(data["params"], data["q8"]), cfg, mesh)
    res["q8"], res["q8_counts"] = _forward(q8, inputs)
    res["q8_local_shapes"] = {k: tuple(v.shape) for k, v in q8.params.items()
                              if isinstance(v, ggml.QTensor8T)}

    w8 = dict(q8.params)
    w8 = spmd.to_w8a8(w8, q8.config)
    engaged = [0]
    impl = ggml._modulated_matmul_impl

    def counting_impl(*a, **k):
        r = impl(*a, **k)
        engaged[0] += r is not None
        return r

    ggml._modulated_matmul_impl = counting_impl
    try:
        for on in (False, True):
            with Config(dict(fused_ew=on)):
                engaged[0] = 0
                res[f"w8a8_ew{int(on)}"], res[f"w8a8_ew{int(on)}_counts"] = _forward(
                    q8, inputs, w8)
                res[f"w8a8_ew{int(on)}_engaged"] = engaged[0]
    finally:
        ggml._modulated_matmul_impl = impl
    res["w8a8_leaves"] = {k: (v.q.numpy(), v.col_scales.numpy()) for k, v in w8.items()
                          if isinstance(v, ggml.QTensor8W)}

    fused = tp_model(host_sd(data["params"], {}), cfg, mesh, fused=True)
    res["fused"], res["fused_counts"] = _forward(fused, inputs)

    cfg2 = tflux.FluxConfig(**data["cfg2"])
    unrolled = tp_model(host_sd(data["params2"], {}), cfg2, mesh, fused=True)
    res["scan_unrolled"], _ = _forward(unrolled, inputs)
    stacked = spmd.to_spmd_model(unrolled, mesh, scan_blocks=True)
    assert tflux.is_stacked(stacked.params)
    res["scan"], res["scan_counts"] = _forward(stacked, inputs)

    patches = {k: (_t(u), _t(d), a) for k, (u, d, a) in data["patches"].items()}
    lq = tp_model(host_sd(data["params_lora"], data["q8_lora"]), cfg, mesh)
    lq = dataclasses.replace(lq, params=tlora.apply_lora(lq.params, patches,
                                                         model_cfg=lq.config))
    res["lora_kinds"] = {k: type(v).__name__ for k, v in lq.params.items()
                         if isinstance(v, ggml.QTensorLoRA)}
    res["lora"], res["lora_counts"] = _forward(lq, inputs)
    with logging_records() as records:
        kept = spmd.to_spmd_model(lq, mesh, scan_blocks=True)
    res["lora_scan_fallback"] = (tflux.is_stacked(kept.params), records)

    fb_mod.history.clear()
    pos = cfg_mod.CondInput(cross_attn=_t(data["ks_ctx"]), pooled=_t(data["ks_pooled"]),
                            guidance=3.5)
    ksq = tp_model(host_sd(data["params"], data["q8"]), cfg, mesh)
    res["ksample"] = ks.ksample(
        ksq, seed=7, steps=4, cfg_scale=1.0, sampler_name="euler", scheduler="beta",
        positive=pos, negative=None, latent_image=torch.zeros((1, 8, 8, cfg.in_channels)),
        fbcache=fb_mod.FBCacheConfig(**data["fbcache"])).latent.numpy()
    res["ksample_history"] = list(fb_mod.history)

    try:
        spmd.make_spmd_apply_fn(dataclasses.replace(cfg, num_heads=3, tp_layout=True), mesh)
        res["heads_refusal"] = None
    except ValueError as e:
        res["heads_refusal"] = str(e)

    dp_mesh = inference_mesh_dp()
    ucfg = tunet.UNetConfig(**data["ucfg"], dtype=torch.float32)
    unet = tbase.sd15_model(tunet.init_params(ucfg, seed=0), cfg=ucfg, dtype=torch.float32,
                            device="cpu")
    x = inference.shard_batch(_t(data["dp_x"]), dp_mesh)
    ctx = inference.shard_batch(_t(data["dp_ctx"]), dp_mesh)
    den = cfg_mod.make_cfg_denoiser(unet.apply_fn, unet.params, unet.model_sampling,
                                    cfg_mod.CondInput(cross_attn=ctx), None, 1.0)
    with counting() as counts:
        res["dp"] = den(x, torch.full((x.shape[0],), 5.0))[0].numpy()
    res["dp_counts"] = counts
    with logging_records() as records:
        mesh_mod.make_mesh(1, 1)
    res["small_mesh_warning"] = records
    return res


def inference_mesh_dp():
    from lightdiffusion_next_tpu_torch.parallel import inference

    return inference.inference_mesh(n_model=1, n_data=WORLD)


class logging_records:
    """The messages logged at WARNING and above inside the block."""

    def __enter__(self):
        self.records = []
        records = self.records

        class H(logging.Handler):
            def emit(self, record):
                records.append(record.getMessage())

        self.handler = H(logging.WARNING)
        logging.getLogger().addHandler(self.handler)
        return self.records

    def __exit__(self, *exc):
        logging.getLogger().removeHandler(self.handler)


def diverge_worker(rank, data):
    """A ksample whose FBCache decisions differ between the ranks (rank 1
    always may hit): its collectives no longer pair up."""
    from lightdiffusion_next_tpu_torch.parallel import inference
    from lightdiffusion_next_tpu_torch.sampling import cfg as cfg_mod
    from lightdiffusion_next_tpu_torch.sampling import fbcache as fb_mod
    from lightdiffusion_next_tpu_torch.sampling import ksampler as ks

    data = torch.load(data, weights_only=False)
    cfg = tflux.FluxConfig(**data["cfg"])
    model = tp_model(host_sd(data["params"], {}), cfg, inference.inference_mesh())
    fb = (fb_mod.FBCacheConfig(residual_diff_threshold=0.0) if rank == 0
          else fb_mod.FBCacheConfig(residual_diff_threshold=1e30))
    pos = cfg_mod.CondInput(cross_attn=_t(data["ks_ctx"]), pooled=_t(data["ks_pooled"]),
                            guidance=3.5)
    return ks.ksample(model, seed=7, steps=3, cfg_scale=1.0, sampler_name="euler",
                      scheduler="beta", positive=pos, negative=None,
                      latent_image=torch.zeros((1, 8, 8, cfg.in_channels)),
                      fbcache=fb).latent.numpy()


def pipeline_worker(rank, root, out, draws):
    """``pipeline(flux_enabled=True)`` from the files under ``root`` with
    ``LDT_FLUX_TP`` spmd and off under the card's toggles, and auto with
    ``w8a8``, ``flux_scan`` and ``fused_attn`` off, each rank drawing its
    own seed (``draws[rank]``): per mode the seed ksample got, the final
    latent, the paths returned, the resident DiT's cache variant and
    config, the warnings and the all-reduces."""
    import random

    from lightdiffusion_next_tpu_torch.pipelines import loader
    from lightdiffusion_next_tpu_torch.pipelines import pipeline as tpipe
    from lightdiffusion_next_tpu_torch.sampling import fbcache as fb_mod
    from lightdiffusion_next_tpu_torch.sampling import ksampler as ks

    os.environ["LDT_ASSET_ROOT"] = root
    os.environ["LDT_OFFLINE"] = "1"
    random.randint = lambda a, b: draws[rank]
    seen = {}
    real = ks.ksample

    def recording(model, **kw):
        r = real(model, **kw)
        seen["seed"], seen["latent"] = kw["seed"], r.latent.numpy()
        return r

    tpipe.ks.ksample = recording
    card = dict(w8a8=True, fused_ew=True, flux_scan=True, fused_attn=True)
    toggles = {"spmd": card, "auto": dict(card, w8a8=False, flux_scan=False, fused_attn=False),
               "off": card}
    res = {}
    for mode in ("spmd", "auto", "off"):
        os.environ["LDT_FLUX_TP"] = mode
        fb_mod.history.clear()
        with Config(toggles[mode]), logging_records() as records, counting() as counts:
            paths = tpipe.pipeline("a castle", 64, 64, flux_enabled=True, device="cpu",
                                   output_dir=os.path.join(out, mode))
        (key, model), = [(k, v) for k, v in loader.get_model_cache()._cache.items()
                         if "flux1-dev" in k]
        flux_dir = os.path.join(out, mode, "Flux")
        res[mode] = dict(seed=seen["seed"], latent=seen["latent"], paths=paths,
                         variant=key.split("::")[1], records=records, counts=counts,
                         tp=model.config.tp_axis is not None,
                         fused=model.config.fused_attn, stacked=tflux.is_stacked(model.params),
                         kinds=sorted(_kinds(model.params)), history=list(fb_mod.history),
                         pngs=sorted(os.listdir(flux_dir)) if os.path.isdir(flux_dir) else [])
    return res


def _kinds(params):
    """The leaf types of a param dict, the stacks' included."""
    kinds = set()
    for v in params.values():
        kinds |= _kinds(v) if isinstance(v, dict) else {type(v).__name__}
    return kinds


# the trainer's configurations: unrolled, stacked, stacked with remat
TRAIN_MODES = {"unrolled": {}, "scan": dict(scan_blocks=True),
               "remat": dict(scan_blocks=True, remat=True)}


def _numpy(t):
    return t.detach().numpy().copy()


def train_snapshot(params, opt_state):
    """{name: (param, mu, nu, count)} of a train state, as numpy copies."""
    from lightdiffusion_next_tpu_torch.parallel import trainer

    return {n: tuple(_numpy(x) for x in (t, opt_state.state[t]["exp_avg"],
                                         opt_state.state[t]["exp_avg_sq"],
                                         opt_state.state[t]["step"]))
            for n, t in trainer.leaves(params)}


def _wait_for(path, poll=0.05):
    while not os.path.exists(path):
        time.sleep(poll)
    return torch.load(path, weights_only=False)


def trainer_worker(rank, data, ckpt):
    """Every case of ``test_torch_trainer.py`` on this rank: each mode's
    first step on the (1, 2) and (2, 1) meshes (loss, gradients, the
    collectives, the params after it); the checkpoint round trip on (1, 2)
    under ``ckpt``; the JAX state after its first step, once the test has
    written it, continued by a step."""
    from lightdiffusion_next_tpu_torch.parallel import trainer

    data = torch.load(data, weights_only=False)
    cfg = tflux.FluxConfig(**data["cfg"])
    batch_args = data["batch"]
    res = {}
    for shape in ((1, 2), (2, 1)):
        for mode, kw in TRAIN_MODES.items():
            mesh, p, o, step, make_batch = trainer.build_sharded_trainer(
                *shape, cfg, device="cpu", **kw)
            batch = make_batch(**batch_args)
            with counting() as counts:
                p, o, loss = step(p, o, batch)
            res[shape, mode] = dict(
                loss=float(loss), counts=counts,
                grads={n: _numpy(t.grad) for n, t in trainer.leaves(p)},
                state=train_snapshot(p, o),
                batch={k: v.numpy() for k, v in batch.items()})

    for mode in ("unrolled", "scan"):
        mesh, p, o, step, make_batch = trainer.build_sharded_trainer(
            1, 2, cfg, device="cpu", **TRAIN_MODES[mode])
        batch = make_batch(**batch_args)
        p, o, _ = step(p, o, batch)
        path = os.path.join(ckpt, mode)
        saved = train_snapshot(p, o)
        trainer.save_checkpoint(path, p, o, step=1, mesh=mesh)
        p, o, loss = step(p, o, batch)
        mesh2, p2, o2, step2, _ = trainer.build_sharded_trainer(
            1, 2, cfg, device="cpu", **TRAIN_MODES[mode])
        p2, o2, n = trainer.restore_checkpoint(path, p2, o2, mesh=mesh2)
        restored = train_snapshot(p2, o2)
        p2, o2, loss2 = step2(p2, o2, batch)
        res["checkpoint", mode] = dict(saved=saved, restored=restored, step=n,
                                       loss=float(loss), resumed_loss=float(loss2))

    jax_state = _wait_for(data["jax_state"])
    mesh, _, _, step, make_batch = trainer.build_sharded_trainer(1, 2, cfg, device="cpu")
    p, o, n = trainer.from_jax_state(jax_state["params"], jax_state["opt_state"], 1, cfg,
                                     mesh, device="cpu")
    p, o, loss = step(p, o, make_batch(**batch_args))
    res["from_jax"] = dict(step=n, loss=float(loss), state=train_snapshot(p, o))
    return res


def loader_worker(rank, data):
    """The cases of ``test_torch_data_loader.py`` that need ranks, on a
    (2, 1) mesh: the first batch ``prefetch_to_mesh`` hands this rank, and
    the data-parallel trainer driven by it (each step's loss)."""
    from lightdiffusion_next_tpu_torch.parallel import data as data_mod
    from lightdiffusion_next_tpu_torch.parallel import trainer

    data = torch.load(data, weights_only=False)
    mesh, p, o, step, _ = trainer.build_sharded_trainer(
        2, 1, tflux.FluxConfig(**data["cfg"]), device="cpu")
    loader = data_mod.prefetch_to_mesh(iter(data["placed"]), mesh, device="cpu")
    placed = {k: v.numpy() for k, v in next(iter(loader)).items()}
    loader.close()
    losses = []
    loader = data_mod.prefetch_to_mesh(iter(data["batches"]), mesh, device="cpu")
    for batch in loader:
        p, o, loss = step(p, o, batch)
        losses.append(float(loss))
    return dict(placed=placed, losses=losses, transferred=loader.transferred)
