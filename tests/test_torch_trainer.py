"""The port's flow-matching trainer (``parallel/trainer.py``) against the
JAX package's, and the backward guard on every hand-written kernel.

On JAX ``tests/test_flux.py``'s TINY config (hidden 64, 4 heads of 16, depth
(2, 2)) and its batch (2 x 8 x 8 latents, 6 text tokens, seed 3), from the
same ``init_params(seed=0)`` draw:

- the first step's loss of ``build_sharded_trainer`` at meshes 1x1, 1x2
  and 2x1, unrolled, ``scan_blocks`` and ``scan_blocks`` + ``remat``,
  against the JAX trainer's at the same mesh and mode (rtol 1e-5). JAX's
  reference is ``flow_matching_loss`` jitted on that trainer's params and
  batch (its first step's loss, without compiling the step); the 1x2
  unrolled one is its real step, run twice for the optimizer cases;
- every gradient, ``img_in.weight`` (upstream of the first
  column-parallel matmul: it is wrong without ``copy_to_model``) and the
  QKNorm scales (summed over every rank's heads) included, against
  ``jax.value_and_grad(flow_matching_loss)`` laid out by ``to_tp_layout``
  and cut per rank: within 5e-4 of the leaf's largest |gradient| (f32
  sums in another order: 3.5e-5 at most, but 1.05e-4 for
  ``guidance_in.in_layer.weight``, whose input is the sines and cosines
  of 3500 x the embedding's frequencies, where the two packages' f32
  angles differ by ulps; a rank's partial gradient is off by O(1));
- the optimizer against optax's ``adamw(1e-4)`` (``_state_close`` gives
  the tolerances), and a second step from ``from_jax_state`` against JAX's
  second step;
- the collectives of a step, the checkpoint round trip on two ranks
  whose shards differ, data-parallel ranks staying equal.

One spawn of 2 gloo ranks (``tp_ranks.trainer_worker``) runs every 1x2 and
2x1 case; the JAX references are computed while it runs, in three threads
(the state after JAX's first step goes to the ranks through a file they
wait for).
"""

import concurrent.futures
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import tp_ranks
from lightdiffusion_next_tpu.models import flux as jflux
from lightdiffusion_next_tpu.ops import flash_attention as jfa
from lightdiffusion_next_tpu.parallel import layout as jlayout
from lightdiffusion_next_tpu.parallel import sharding as jsharding
from lightdiffusion_next_tpu.parallel import trainer as jtrainer
from lightdiffusion_next_tpu_torch import config as tconfig
from lightdiffusion_next_tpu_torch.models import flux as tflux
from lightdiffusion_next_tpu_torch.ops import flash_attention as fa
from lightdiffusion_next_tpu_torch.ops import grad_guard
from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm
from lightdiffusion_next_tpu_torch.ops import sage_attention as sa
from lightdiffusion_next_tpu_torch.parallel import mesh as mesh_mod
from lightdiffusion_next_tpu_torch.parallel import trainer

CFG = dict(in_channels=4, hidden_size=64, num_heads=4, depth=2, depth_single_blocks=2,
           axes_dim=(4, 6, 6), context_in_dim=32, vec_in_dim=16)
TINY = jflux.FluxConfig(**CFG)
BATCH = dict(batch_size=2, h=8, w=8, txt_len=6, seed=3)
SHAPES = ((1, 1), (1, 2), (2, 1))
MODES = tuple(tp_ranks.TRAIN_MODES)
# a step's all-reduces over "model" at TP = 2: forward, each double block's
# four row-parallel sums and each single block's one; backward, as many
# column-parallel inputs, and the QKNorm scales (four a double block, two a
# single block); remat runs the forward of the blocks after double block 0
# again in the backward
FORWARD = 4 * CFG["depth"] + CFG["depth_single_blocks"]
SCALES = 4 * CFG["depth"] + 2 * CFG["depth_single_blocks"]
REMAT = 4 * (CFG["depth"] - 1) + CFG["depth_single_blocks"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _jax_losses():
    """JAX's first-step loss at the meshes and modes ``_jax_grads`` and
    ``_jax_steps`` leave: ``flow_matching_loss`` on each trainer's params
    and batch. ``remat`` changes the backward only, so its first loss is
    the scan trainer's (JAX's ``test_flux.py::
    test_trainer_scan_matches_unrolled_and_remat`` holds the two equal)."""
    out = {}
    for shape, kw in (((2, 1), {}), ((1, 1), dict(scan_blocks=True)),
                      ((1, 2), dict(scan_blocks=True)), ((2, 1), dict(scan_blocks=True))):
        mesh, params, _, _, make_batch = jtrainer.build_sharded_trainer(*shape, TINY, **kw)
        with mesh:
            loss = float(jax.jit(jtrainer.flow_matching_loss, static_argnums=2)(
                params, make_batch(**BATCH), TINY))
        for mode in (("scan", "remat") if kw else ("unrolled",)):
            out[shape, mode] = loss
    return out


def _jax_steps():
    """Two steps of JAX's 1x2 unrolled trainer: (loss, state) after each,
    the state as numpy (params, adam's count, mu, nu). The state goes back
    to its first shardings between the steps (the count uncommitted, as
    optax made it), so the second takes the first's compiled step."""
    mesh, params, opt_state, step, make_batch = jtrainer.build_sharded_trainer(1, 2, TINY)
    shardings = jax.tree.map(lambda a: a.sharding, (params, opt_state))
    out = []
    with mesh:
        batch = make_batch(**BATCH)
        for _ in range(2):
            params, opt_state, loss = step(params, opt_state, batch)
            adam = opt_state[0]
            out.append((float(loss), dict(params=_np(params), count=np.array(adam.count),
                                          mu=_np(adam.mu), nu=_np(adam.nu))))
            params, opt_state = jax.tree.map(
                lambda a, sh: (jax.device_put(a, sh) if len(sh.device_set) > 1
                               else jnp.asarray(np.array(a))), (params, opt_state), shardings)
    return out


def _jax_grads():
    """``jax.value_and_grad(flow_matching_loss)`` at the 1x1 trainer's
    params and batch."""
    mesh, params, _, _, make_batch = jtrainer.build_sharded_trainer(1, 1, TINY)
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(jtrainer.flow_matching_loss),
                              static_argnums=2)(params, make_batch(**BATCH), TINY)
    return float(loss), _np(grads)


def _local(tree, shape, rank):
    """A flat checkpoint-layout JAX dict as rank ``rank``'s leaves on the
    port's ``shape`` mesh: laid out and cut over "model" at TP = 2."""
    if shape[1] == 1:
        return tree
    tree, _ = jlayout.to_tp_layout(dict(tree), TINY)
    out = {}
    for k, v in tree.items():
        spec = jsharding.flux_param_spec(k)
        if spec == P():
            out[k] = v
        else:
            dim = list(spec).index("model")
            n = v.shape[dim] // 2
            out[k] = np.take(v, np.arange(rank * n, (rank + 1) * n), axis=dim)
    return out


def _flat(named):
    """The port's leaves by name, a stack's split into its blocks' keys."""
    heads = {tflux.DOUBLE_STACK_KEY: "double_blocks", tflux.SINGLE_STACK_KEY: "single_blocks"}
    out = {}
    for name, v in named.items():
        stack, _, rel = name.partition("/")
        if rel:
            out.update({f"{heads[stack]}.{i}.{rel}": v[i] for i in range(v.shape[0])})
        else:
            out[name] = v
    return out


def _close(got, want, scale=5e-4):
    assert sorted(got) == sorted(want)
    for k in want:
        tol = scale * max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol, err_msg=k)


def _port_single(mode):
    """The port's 1x1 trainer's first step, in this process."""
    assert not dist.is_initialized()
    mesh, p, o, step, make_batch = trainer.build_sharded_trainer(
        1, 1, tflux.FluxConfig(**CFG), device="cpu", **tp_ranks.TRAIN_MODES[mode])
    with tp_ranks.counting() as counts:
        p, o, loss = step(p, o, make_batch(**BATCH))
    return dict(loss=float(loss), counts=counts, mesh=mesh,
                grads={n: tp_ranks._numpy(t.grad) for n, t in trainer.leaves(p)},
                state=tp_ranks.train_snapshot(p, o))


@dataclasses.dataclass
class Case:
    res: list  # each rank's results
    single: dict  # the port's 1x1 runs, by mode
    jax_losses: dict
    jax_steps: list
    jax_grads: tuple
    ckpt: str


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("trainer")
    ckpt = str(tmp / "ckpt")
    os.makedirs(ckpt)
    data = dict(cfg=CFG, batch=BATCH, jax_state=str(tmp / "jax_state.pt"))
    torch.save(data, str(tmp / "data.pt"))
    ranks = tp_ranks.start(tp_ranks.trainer_worker, tmp, str(tmp / "data.pt"), ckpt)
    pool = concurrent.futures.ThreadPoolExecutor(2)  # JAX compiles without the GIL
    try:
        losses, grads = pool.submit(_jax_losses), pool.submit(_jax_grads)
        steps = _jax_steps()
        state = steps[0][1]
        torch.save(dict(params=state["params"], opt_state=(types.SimpleNamespace(
            count=state["count"], mu=state["mu"], nu=state["nu"]), (), ())),
            data["jax_state"] + ".tmp")
        os.replace(data["jax_state"] + ".tmp", data["jax_state"])
        single = {mode: _port_single(mode) for mode in MODES}
        yield Case(ranks.join(), single, losses.result(), steps, grads.result(), ckpt)
    finally:
        pool.shutdown()
        ranks.kill()


def _run(case, shape, mode, rank=0):
    if shape == (1, 1):
        return case.single[mode]
    return case.res[rank][shape, mode]


def _jax_loss(case, shape, mode):
    if (shape, mode) == ((1, 2), "unrolled"):
        return case.jax_steps[0][0]
    if (shape, mode) == ((1, 1), "unrolled"):
        return case.jax_grads[0]
    return case.jax_losses[shape, mode]


# --- the step against JAX's ----------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_first_step_loss_matches_jax(case, record_property, shape, mode):
    record_property("rank_seconds", tp_ranks.SECONDS["trainer_worker"])
    ranks = [0] if shape == (1, 1) else [0, 1]
    for r in ranks:
        got = _run(case, shape, mode, r)["loss"]
        np.testing.assert_allclose(got, _jax_loss(case, shape, mode), rtol=1e-5)
    # the JAX meshes agree among themselves as closely
    np.testing.assert_allclose(_jax_loss(case, shape, mode), case.jax_grads[0], rtol=1e-5)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_gradients_match_jax(case, shape, mode):
    """Every leaf's gradient on every rank, the data-parallel ones being the
    mean over the ranks' rows (the whole batch's gradient)."""
    grads = case.jax_grads[1]
    assert "img_in.weight" in grads and "double_blocks.1.txt_attn.norm.key_norm.scale" in grads
    for r in ([0] if shape == (1, 1) else [0, 1]):
        _close(_flat(_run(case, shape, mode, r)["grads"]), _local(grads, shape, r))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_collectives_of_a_step(case, shape, mode):
    """1x2: the forward's row-parallel sums (and remat's recomputed ones),
    the backward's column-parallel inputs and QKNorm scales, nothing else;
    2x1: a mean all-reduce of each gradient and of the loss over "data",
    no "model" collective; 1x1: none, and no process group."""
    hidden, head_dim = CFG["hidden_size"], CFG["hidden_size"] // CFG["num_heads"]
    for r in ([0] if shape == (1, 1) else [0, 1]):
        run = _run(case, shape, mode, r)
        c = run["counts"]
        if shape == (1, 2):
            fwd = FORWARD + (REMAT if mode == "remat" else 0)
            assert (c.calls, c.widths) == (fwd, {hidden: fwd})
            assert c.backward_calls == FORWARD + SCALES
            assert c.backward_widths == {hidden: FORWARD, head_dim: SCALES}
            assert c.raw_all_reduce == fwd + FORWARD + SCALES and c.others == 0
        else:
            assert c.calls == c.backward_calls == c.others == 0
            leaves = len(run["grads"])
            assert c.raw_all_reduce == (leaves + 1 if shape == (2, 1) else 0)
    if shape == (1, 1):
        assert case.single[mode]["mesh"] is None


def _state_close(snapshot, want, shape, rank, ref_moment):
    """A port state snapshot ({name: (param, mu, nu, count)}) after a step
    against a numpy JAX state, laid out and cut for ``rank``. The moments
    within 5e-4 of their leaf's largest (as the gradients). The params
    within 2.5e-7 where ``ref_moment`` (the step's gradient or first moment,
    JAX's) is at least 1e-3 of its leaf's largest; elsewhere Adam divides
    the moment by its own size, so the update's direction follows the
    rounding of a near-zero gradient, and a weight is held to two steps'
    size (2.2e-4)."""
    got = [_flat({n: v[i] for n, v in snapshot.items()}) for i in range(3)]
    for i, part in ((1, "mu"), (2, "nu")):
        _close(got[i], _local(want[part], shape, rank))
    ref, moment = _local(want["params"], shape, rank), _local(ref_moment, shape, rank)
    assert sorted(got[0]) == sorted(ref)
    for k in ref:
        sure = np.abs(moment[k]) >= 1e-3 * np.abs(moment[k]).max()
        d = np.abs(got[0][k] - ref[k])
        assert d[sure].max(initial=0) <= 2.5e-7 and d.max() <= 2.2e-4, k
    assert {float(v[3]) for v in snapshot.values()} == {float(want["count"])}


@pytest.mark.parametrize("shape", [(1, 1), (1, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_adamw_step_matches_optax(case, shape):
    """The params and moments after the trainer's first step against the
    JAX trainer's (optax ``adamw(1e-4)``)."""
    want = case.jax_steps[0][1]
    for r in ([0] if shape == (1, 1) else [0, 1]):
        _state_close(_run(case, shape, "unrolled", r)["state"], want, shape, r,
                     case.jax_grads[1])


def test_adamw_arithmetic_matches_optax():
    """``trainer.AdamW`` against ``optax.adamw(1e-4)`` on the same params
    and gradients, three steps: within two f32 ulps. A leaf whose gradient
    is zero decays by lr x 1e-4 a step, optax's weight decay on every leaf
    (torch's default of 0.01 would take 100x that)."""
    import optax

    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((16, 8)).astype(np.float32),
              "b": rng.standard_normal((8,)).astype(np.float32),
              "idle": rng.standard_normal((4,)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * (0 if k == "idle" else 1)).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    opt = optax.adamw(1e-4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = opt.init(jp)
    tp = trainer._trainable({k: torch.tensor(v) for k, v in params.items()})
    ts = trainer.AdamW().init(tp)
    for g in grads:
        updates, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, updates)
        for k, t in tp.items():
            t.grad = torch.tensor(g[k])
        ts.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=2.4e-7,
                                       atol=0, err_msg=k)
    idle = params["idle"].astype(np.float64)
    np.testing.assert_allclose(tp["idle"].detach().numpy(), idle * (1 - 1e-8) ** 3,
                               rtol=1.2e-7)
    assert np.abs(idle * (1 - 1e-6) ** 3 - idle * (1 - 1e-8) ** 3).max() > 1e-6


def test_second_step_from_jax_state(case):
    """JAX's state after its first step carried into the port
    (``from_jax_state``: params, mu, nu and count laid out and cut per
    rank) and stepped: the loss is JAX's second step's, the state JAX's
    after it; on 1x2 and on one device."""
    loss2, want = case.jax_steps[1]
    for r in (0, 1):
        run = case.res[r]["from_jax"]
        assert run["step"] == 1
        np.testing.assert_allclose(run["loss"], loss2, rtol=1e-5)
        _state_close(run["state"], want, (1, 2), r, want["mu"])
    state = case.jax_steps[0][1]
    mesh, _, _, step, make_batch = trainer.build_sharded_trainer(
        1, 1, tflux.FluxConfig(**CFG), device="cpu")
    p, o, n = trainer.from_jax_state(
        state["params"], (types.SimpleNamespace(count=state["count"], mu=state["mu"],
                                                nu=state["nu"]), (), ()), 1,
        tflux.FluxConfig(**CFG), mesh, device="cpu")
    p, o, loss = step(p, o, make_batch(**BATCH))
    np.testing.assert_allclose(float(loss), loss2, rtol=1e-5)
    _state_close(tp_ranks.train_snapshot(p, o), want, (1, 1), 0, want["mu"])


# --- checkpoints, data parallelism ---------------------------------------------


@pytest.mark.parametrize("mode", ["unrolled", "scan"])
def test_checkpoint_round_trip_on_two_ranks(case, mode):
    """``save_checkpoint`` after a step on 1x2, ``restore_checkpoint`` into
    a fresh trainer: every param, moment and count bit for bit, the step
    number, and the next step's loss equal to the uninterrupted run's. The
    ranks' slices differ, and the file holds each replicated leaf once and
    each rank's slice under its own key."""
    from torch.distributed.checkpoint import FileSystemReader

    runs = [case.res[r]["checkpoint", mode] for r in (0, 1)]
    for run in runs:
        assert run["step"] == 1
        assert sorted(run["saved"]) == sorted(run["restored"])
        for name, parts in run["saved"].items():
            for a, b in zip(parts, run["restored"][name]):
                np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_allclose(run["resumed_loss"], run["loss"], rtol=1e-6)
    qkv = ("double_blocks.0.img_attn.qkv.weight" if mode == "unrolled"
           else f"{tflux.DOUBLE_STACK_KEY}/img_attn.qkv.weight")
    assert not np.array_equal(runs[0]["saved"][qkv][0], runs[1]["saved"][qkv][0])
    keys = FileSystemReader(os.path.join(case.ckpt, mode)).read_metadata().state_dict_metadata
    params = [k for k in keys if k.startswith("params/")]
    shards = [k for k in params if "@model" in k]
    assert "params/img_in.weight" in keys and not any("img_in" in k for k in shards)
    assert {qkv + "@model0of2", qkv + "@model1of2"} <= {k[len("params/"):] for k in shards}
    assert len(params) == len(runs[0]["saved"]) + len(shards) // 2
    assert {"count", "step", "mesh"} <= set(keys)


def test_data_parallel_ranks_stay_equal(case):
    """2x1: each rank takes its row of the batch, and after the step (the
    gradients mean-reduced over "data") both ranks' params and moments are
    equal bit for bit."""
    runs = [case.res[r][(2, 1), "unrolled"] for r in (0, 1)]
    rng = np.random.default_rng(BATCH["seed"])
    latent = rng.standard_normal((2, 8, 8, CFG["in_channels"])).astype(np.float32)
    for r, run in enumerate(runs):
        np.testing.assert_array_equal(run["batch"]["latent"], latent[r:r + 1])
    for name, parts in runs[0]["state"].items():
        for a, b in zip(parts, runs[1]["state"][name]):
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_remat_requires_scan_blocks():
    with pytest.raises(ValueError, match="requires scan_blocks"):
        trainer.build_sharded_trainer(1, 1, tflux.FluxConfig(**CFG), device="cpu", remat=True)


def test_save_without_the_mesh_is_refused_on_ranks(tmp_path, monkeypatch):
    """Without the mesh a rank's slices would share one key, and the
    checkpoint would keep one rank's: refused where ranks exist."""
    mesh, p, o, _, _ = trainer.build_sharded_trainer(1, 1, tflux.FluxConfig(**CFG),
                                                     device="cpu")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    with pytest.raises(ValueError, match="pass the trainer's mesh"):
        trainer.save_checkpoint(str(tmp_path / "c"), p, o, 1)


# --- the backward guard ----------------------------------------------------------


def test_step_on_the_flash_backend_reaches_the_guard():
    """A loss whose attention takes the kernels (``RuntimeConfig(
    attention_backend="flash")``, 512 joint tokens: 256 image, 256 text)
    reaches K2's wrapper under grad: the forward runs, the backward raises
    the guard's error. The trainer's step runs under "sdpa" whatever the
    caller's config, trains, and leaves that config in place."""
    cfg = tflux.FluxConfig(**dict(CFG, depth=1, depth_single_blocks=0))
    mesh, p, o, step, make_batch = trainer.build_sharded_trainer(1, 1, cfg, device="cpu")
    batch = make_batch(1, 32, 32, 256)
    saved = tconfig.get_config()
    flash = tconfig.set_config(dataclasses.replace(saved, attention_backend="flash"))
    try:
        loss = trainer.flow_matching_loss(p, batch, cfg)
        with pytest.raises(grad_guard.NoBackwardError, match=r"flash_attention \(K2\).*sdpa"):
            loss.backward()
        _, _, loss = step(p, o, batch)
        assert tconfig.get_config() is flash
    finally:
        tconfig.set_config(saved)
    assert np.isfinite(float(loss))


def _wrapper_calls():
    """(name, call(x) with x the input that requires grad, the output to
    differentiate) for every kernel wrapper, at small CPU shapes."""
    g = torch.Generator().manual_seed(0)

    def rnd(*s):
        return torch.randn(s, generator=g)

    q8 = torch.randint(-127, 128, (256, 128), generator=g, dtype=torch.int8)
    sc = rnd(8, 128).abs() * 0.01
    w8 = torch.randint(-127, 128, (128, 256), generator=g, dtype=torch.int8)
    cs = rnd(1, 128).abs() * 0.01
    kv = rnd(1, 2, 600, 40)
    l, h = 24, 2
    cos, sin = rnd(l, 128), rnd(l, 128)
    s128 = torch.ones(128)
    xq = torch.randint(-127, 128, (4, 256), generator=g, dtype=torch.int8)
    bias = rnd(1, 128)
    return [
        ("packed_flash_attention (K1)", rnd(1, 2, 600, 40),
         lambda x: fa.packed_flash_attention(x, kv, kv)),
        ("flash_attention (K2)", rnd(1, 2, 600, 40), lambda x: fa.flash_attention(x, kv, kv)),
        ("fused_qkv_attention (K3)", rnd(1, l, 3 * h * 128),
         lambda x: fa.fused_qkv_attention(x, s128, s128, cos, sin, num_heads=h, txt_len=8)),
        ("fused_qkv_attention (K3)", rnd(1, l, 3 * h * 128),
         lambda x: fa.fused_qkv_attention(x, s128, s128, cos, sin, num_heads=h,
                                          interleaved=True)),
        ("sage_attention (K4)", rnd(1, 2, 600, 40), lambda x: sa.sage_attention(x, kv, kv)),
        ("quant_matmul (K5)", rnd(4, 256), lambda x: qm.quant_matmul(x, q8, sc)),
        ("quant_matmul_stacked (K6)", rnd(4, 256),
         lambda x: qm.quant_matmul_stacked(x, q8[None].repeat(2, 1, 1),
                                           sc[None].repeat(2, 1, 1), 1)),
        ("w8a8_matmul (K7)", rnd(4, 256), lambda x: qm.w8a8_matmul(x, w8, cs)),
        ("w8a8_matmul_stacked (K8)", rnd(4, 256),
         lambda x: qm.w8a8_matmul_stacked(x, w8[None].repeat(2, 1, 1),
                                          cs[None].repeat(2, 1, 1), 0)),
        ("row_quantize_fused (K9)", rnd(4, 256),
         lambda x: qm.row_quantize_fused(x, prologue="gelu")[1]),
        ("row_quantize_concat_gelu (K10)", rnd(4, 128),
         lambda x: qm.row_quantize_concat_gelu(x, kv[0, 0, :4, :], 0, 32)[1]),
        ("w8a8_matmul_ep (K11)", rnd(4, 1).abs(),
         lambda x: qm.w8a8_matmul_ep(xq, x, w8, cs, bias, out_dtype=torch.float32)),
        ("w8a8_matmul_ep_stacked (stacked K11)", rnd(4, 1).abs(),
         lambda x: qm.w8a8_matmul_ep_stacked(xq, x, w8[None].repeat(2, 1, 1), 1, cs, bias,
                                             out_dtype=torch.float32)),
        # the flag variants
        ("sage_attention (K4)", rnd(1, 2, 600, 40),
         lambda x: sa.sage_attention(x, kv, kv, int8_mxu=False)),
        ("sage_attention (K4)", rnd(1, 2, 600, 40),
         lambda x: sa.sage_attention(x, kv, kv, pv_int8=False)),
        ("sage_attention (K4)", rnd(1, 2, 600, 40),
         lambda x: sa.sage_attention(x, kv, kv, int8_mxu=False, pv_int8=False)),
        ("w8a8_matmul (K7)", rnd(4, 256), lambda x: qm.w8a8_matmul(x, w8, cs, int8_mxu=False)),
        ("w8a8_matmul_stacked (K8)", rnd(4, 256),
         lambda x: qm.w8a8_matmul_stacked(x, w8[None].repeat(2, 1, 1),
                                          cs[None].repeat(2, 1, 1), 0, int8_mxu=False)),
        ("w8a8_matmul_ep (K11)", rnd(4, 1).abs(),
         lambda x: qm.w8a8_matmul_ep(xq, x, w8, cs, bias, out_dtype=torch.float32,
                                     int8_mxu=False)),
        ("w8a8_matmul_ep_stacked (stacked K11)", rnd(4, 1).abs(),
         lambda x: qm.w8a8_matmul_ep_stacked(xq, x, w8[None].repeat(2, 1, 1), 1, cs, bias,
                                             out_dtype=torch.float32, int8_mxu=False)),
    ]


@pytest.mark.parametrize("index", range(20))
def test_kernel_wrapper_backward_raises(index):
    """Each wrapper under grad returns its plain result, bit for bit the
    call without grad, and its backward raises naming the kernel and the
    way out; without grad the result has no graph."""
    name, x, call = _wrapper_calls()[index]
    with torch.no_grad():
        want = call(x)
    x.requires_grad_(True)
    out = call(x)
    assert out.requires_grad
    torch.testing.assert_close(out, want, rtol=0, atol=0)
    with pytest.raises(grad_guard.NoBackwardError) as e:
        out.float().sum().backward()
    assert name in str(e.value) and 'attention_backend="sdpa"' in str(e.value)
    assert call(x.detach()).grad_fn is None


def test_jax_grad_through_the_pallas_flash_kernel_fails():
    """The reference side of the guard: ``jax.grad`` through the JAX
    package's Pallas ``flash_attention`` (interpret mode on the CPU) at
    (1, 2, 512, 64), the shape from which its attention takes the kernel,
    raises."""
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.standard_normal((1, 2, 512, 64)), jnp.float32)
               for _ in range(3))
    with pytest.raises(AssertionError):
        jax.grad(lambda q_: jfa.flash_attention(q_, k, v).sum())(q)


def test_conjugate_pair_without_grad_is_the_plain_reduce():
    """``copy_to_model`` returns its input, and ``reduce_from_model`` is the
    counted all-reduce, where no gradient is asked for (inference)."""
    t = torch.ones(3)
    assert mesh_mod.copy_to_model(t, None) is t
    calls = []
    real = dist.all_reduce
    dist.all_reduce = lambda x, group=None: calls.append(x)
    try:
        mesh_mod.reset_counts()
        out = mesh_mod.reduce_from_model(t, None)
    finally:
        dist.all_reduce = real
    assert out is t and calls == [t]
    assert (mesh_mod.all_reduce.calls, mesh_mod.all_reduce.backward_calls) == (1, 0)
