"""The port's tensor-parallel Flux forward on 2 gloo ranks (``parallel/``)
against the JAX package's ``shard_map`` forward (``make_spmd_apply_fn``)
at TP = 2 on the virtual CPU mesh and against the port's single-device
forward, on the same params; SD1.5 data-parallel against its single
forward.

One spawn of 2 ranks (``tp_ranks.spmd_worker``) runs every case, and a
second the diverging ranks; both start before the JAX references are
computed, which they overlap, and each test reads its case. JAX's widths (``tests/test_spmd.py``'s CFG: hidden 512, 4
heads of 128, one double and one single block); its Pallas kernels run in
interpret mode. Tolerances are the JAX tests': atol 3e-4 (dense, Q8_0,
fused attention, the scan layout), 5e-4 (LoRA), 1e-3 (ksample), SD1.5 DP
atol 2e-4 / rtol 1e-4; W8A8 against JAX's W8A8 at relative RMS error
``DIT_REL_RMSE`` (1e-2, the port's W8A8 DiT tolerance: the row
quantizations may differ by one code), each rank's requantized codes and
scales bit for bit the slices of the JAX package's global requant.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import tp_ranks
from lightdiffusion_next_tpu.models import flux as jflux
from lightdiffusion_next_tpu.models import lora as jlora
from lightdiffusion_next_tpu.ops import ggml as jggml
from lightdiffusion_next_tpu.parallel import layout as jlayout
from lightdiffusion_next_tpu.parallel import sharding as jsharding
from lightdiffusion_next_tpu.parallel import spmd as jspmd
from lightdiffusion_next_tpu.parallel.mesh import make_mesh as jmake_mesh
from lightdiffusion_next_tpu_torch.models import base as tbase
from lightdiffusion_next_tpu_torch.models import flux as tflux
from lightdiffusion_next_tpu_torch.models import lora as tlora
from lightdiffusion_next_tpu_torch.models import unet as tunet
from lightdiffusion_next_tpu_torch.ops import ggml as tggml
from lightdiffusion_next_tpu_torch.sampling import cfg as tcfg_mod
from lightdiffusion_next_tpu_torch.sampling import fbcache as tfb
from lightdiffusion_next_tpu_torch.sampling import ksampler as tks
from test_torch_flux import _rel_rmse
from test_torch_w8a8 import DIT_REL_RMSE

CFG = dict(in_channels=4, hidden_size=512, num_heads=4, depth=1, depth_single_blocks=1,
           axes_dim=(16, 56, 56), context_in_dim=32, vec_in_dim=16)
CFG2 = dict(CFG, depth=2, depth_single_blocks=2)
JCFG = jflux.FluxConfig(**CFG)
PER_CALL = 4 * CFG["depth"] + CFG["depth_single_blocks"]
UCFG = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=(1, 1),
            transformer_depth=(1, 1), context_dim=768, num_heads=4)
FBCACHE = dict(residual_diff_threshold=1e30, max_consecutive_cache_hits=2)


def _inputs(rng, b=1, hw=8, txt=6):
    return (rng.standard_normal((b, hw, hw, CFG["in_channels"])).astype(np.float32),
            rng.uniform(0.2, 0.9, (b,)).astype(np.float32),
            (rng.standard_normal((b, txt, CFG["context_in_dim"])) * 0.3).astype(np.float32),
            (rng.standard_normal((b, CFG["vec_in_dim"])) * 0.3).astype(np.float32))


def _q8(params):
    """The JAX test's quantization: the sharded 2-D weights whose input dim
    is whole 32-blocks, as (codes, scales) from the JAX quantizer."""
    out = {}
    for k, v in params.items():
        if v.ndim == 2 and v.shape[1] % 32 == 0 and jsharding.flux_param_spec(k) != P():
            out[k] = tuple(np.asarray(a) for a in jggml.quantize_q8_0(np.asarray(v, np.float32)))
    return out


def _patches(rng):
    h = CFG["hidden_size"]
    return {  # a column-parallel target and a row-parallel one
        "double_blocks.0.img_attn.qkv.weight": (
            rng.standard_normal((3 * h, 4)).astype(np.float32) * 0.05,
            rng.standard_normal((4, h)).astype(np.float32) * 0.05, 4.0),
        "double_blocks.0.img_attn.proj.weight": (
            rng.standard_normal((h, 4)).astype(np.float32) * 0.05,
            rng.standard_normal((4, h)).astype(np.float32) * 0.05, 4.0),
    }


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The references here are tiny models of many small ops: one torch
    thread runs them as fast and leaves the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the JAX references ------------------------------------------------------


def _jmesh():
    return jmake_mesh(1, 2)


def _jshard(sd, cfg, mesh, q8=None):
    """The JAX loader's flow: Q8_0 records of ``q8``, layout, sharded upload."""
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    for k, (q, s) in (q8 or {}).items():
        sd[k] = jggml.QTensor8(q, s, sd[k].shape)
    sd, cfg = jlayout.to_tp_layout(sd, cfg)
    return jsharding.shard_state_dict(sd, mesh), cfg


def _jspmd(params, cfg, mesh, inputs, local=None):
    apply_fn, local_view = jspmd.make_spmd_apply_fn(cfg, mesh)
    p = local_view(params) if local is None else local
    with mesh:
        return np.asarray(jax.jit(lambda pp, *a: apply_fn(pp, *a))(
            p, *(jnp.asarray(a) for a in inputs)))


def _port_single(params, cfg, inputs, q8=None, fused=False, w8a8=False, patches=None):
    """The port's single-device forward on the same values (requantized
    to W8A8, or under the LoRA ``patches``, when asked)."""
    sd = tp_ranks.host_sd(params, q8 or {})
    p = tggml.to_device_quantized(sd, dtype=torch.float32, device="cpu")
    if w8a8:
        p = tggml.to_w8a8(p)
    if patches is not None:
        p = tlora.apply_lora(p, {k: (tp_ranks._t(u), tp_ranks._t(d), a)
                                 for k, (u, d, a) in patches.items()}, model_cfg=cfg)
    if fused:
        p = tflux.permute_rope_basis(p, cfg)
        cfg = dataclasses.replace(cfg, fused_attn=True)
    model = tbase.flux_bundle(tbase.f32_qk_norms(p), cfg, torch.device("cpu"))
    return model.apply_fn(model.params, *(tp_ranks._t(a) for a in inputs)).numpy()


def _check_collectives(counts, hidden=CFG["hidden_size"], per_call=PER_CALL):
    """The explicit all-reduces of one forward and nothing else collective."""
    assert counts.calls == per_call
    assert counts.widths == {hidden: per_call}
    assert counts.raw_all_reduce == per_call and counts.others == 0


def _both_ranks(res, key):
    np.testing.assert_array_equal(res[0][key], res[1][key])
    return res[0][key]


def _jax_refs(data):
    """JAX's ``shard_map`` forwards at TP = 2 for every case that has one:
    dense, Q8_0, fused attention (interleaved K3 in interpret mode), LoRA,
    and W8A8 (its requant of the global shards and its default
    ``fused_ew``, one reference for both of the port's settings)."""
    mesh = _jmesh()
    inputs = data["inputs"]
    refs = {"dense": _jspmd(*_jshard(data["params"], JCFG, mesh), mesh, inputs),
            "q8": _jspmd(*_jshard(data["params"], JCFG, mesh, data["q8"]), mesh, inputs)}
    params, fcfg = _jshard(data["params"], JCFG, mesh, data["q8"])
    local = jggml.to_w8a8(jspmd.make_spmd_apply_fn(fcfg, mesh)[1](params))
    refs["w8a8_local"] = local
    refs["w8a8"] = _jspmd(None, fcfg, mesh, inputs, local=local)
    sd2 = jlayout.permute_rope_basis_rows(dict(data["params"]), JCFG)
    params, fcfg = _jshard(sd2, JCFG, mesh)
    refs["fused"] = _jspmd(params, dataclasses.replace(fcfg, fused_attn=True), mesh, inputs)
    params, fcfg = _jshard(data["params_lora"], JCFG, mesh, data["q8_lora"])
    local = jlora.apply_lora(jspmd.make_spmd_apply_fn(fcfg, mesh)[1](params), data["patches"],
                             strength=1.0, model_cfg=fcfg)
    refs["lora"] = _jspmd(None, fcfg, mesh, inputs, local=local)
    return refs


@dataclasses.dataclass
class Case:
    data: dict  # what both sides take
    res: list  # each rank's results
    jax: dict  # the JAX references (``_jax_refs``)
    diverge: tp_ranks.Ranks  # the diverging ranks, started beside the others


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The data, then both spawns started (every case's ranks, and the
    diverging ranks), the JAX references computed while they run, then
    the ranks' results."""
    rng = np.random.default_rng(0)
    params = jflux.init_params(JCFG, seed=3)
    params_lora = jflux.init_params(JCFG, seed=8)
    data = dict(cfg=CFG, cfg2=CFG2, params=params, q8=_q8(params), inputs=_inputs(rng),
                params2=jflux.init_params(jflux.FluxConfig(**CFG2), seed=23),
                params_lora=params_lora, q8_lora=_q8(params_lora), patches=_patches(rng),
                ks_ctx=(rng.standard_normal((1, 6, CFG["context_in_dim"])) * 0.3
                        ).astype(np.float32),
                ks_pooled=(rng.standard_normal((1, CFG["vec_in_dim"])) * 0.3
                           ).astype(np.float32),
                fbcache=FBCACHE, ucfg=UCFG,
                dp_x=rng.standard_normal((2, 16, 16, 4)).astype(np.float32),
                dp_ctx=rng.standard_normal((2, 77, 768)).astype(np.float32))
    tmp = tmp_path_factory.mktemp("spmd")
    path = str(tmp / "data.pt")
    torch.save(data, path)
    ranks = tp_ranks.start(tp_ranks.spmd_worker, tmp, path)
    diverge = tp_ranks.start(tp_ranks.diverge_worker, tmp_path_factory.mktemp("diverge"), path,
                             gloo_timeout=5.0)
    try:
        refs = _jax_refs(data)
        yield Case(data, ranks.join(), refs, diverge)
    finally:
        ranks.kill()
        diverge.kill()


# --- the cases ---------------------------------------------------------------


def test_dense_matches_jax_spmd_and_single_device(case, record_property):
    data, res = case.data, case.res
    record_property("rank_seconds", tp_ranks.SECONDS["spmd_worker"])
    out = _both_ranks(res, "dense")
    np.testing.assert_allclose(out, case.jax["dense"], atol=3e-4)
    single = _port_single(data["params"], tflux.FluxConfig(**CFG), data["inputs"])
    np.testing.assert_allclose(out, single, atol=3e-4)
    for r in res:
        _check_collectives(r["dense_counts"])


def test_q8_0_matches_jax_spmd_and_single_device(case):
    """Q8_0 shards take K5 at their local shapes (K_local 256 at TP = 2)."""
    data, res = case.data, case.res
    out = _both_ranks(res, "q8")
    h = CFG["hidden_size"]
    shapes = res[0]["q8_local_shapes"]
    assert shapes["double_blocks.0.img_attn.qkv.weight"] == (3 * h // 2, h)
    assert shapes["double_blocks.0.img_attn.proj.weight"] == (h, h // 2)
    assert shapes["single_blocks.0.linear2_mlp.weight"] == (h, 4 * h // 2)
    np.testing.assert_allclose(out, case.jax["q8"], atol=3e-4)
    single = _port_single(data["params"], tflux.FluxConfig(**CFG), data["inputs"], data["q8"])
    np.testing.assert_allclose(out, single, atol=3e-4)
    for r in res:
        _check_collectives(r["q8_counts"])


@pytest.mark.parametrize("fused_ew", [False, True])
def test_w8a8_matches_jax_spmd(case, fused_ew):
    """W8A8 requantized on the shards: each rank's codes and column scales
    are its slices of JAX's requant of the global weights (a row-parallel
    shard's column maxima all-reduced); with fused-EW every quantized
    matmul takes K9 + K11 (the row-parallel ones emitting raw partials),
    without it none; the forward against JAX's spmd W8A8."""
    data, res = case.data, case.res
    key = f"w8a8_ew{int(fused_ew)}"
    out = _both_ranks(res, key)
    local, ref = case.jax["w8a8_local"], case.jax["w8a8"]
    for r in range(2):
        leaves = res[r]["w8a8_leaves"]
        assert sorted(leaves) == sorted(k for k, v in local.items()
                                        if isinstance(v, jggml.QTensor8W))
        for k, (q, cs) in leaves.items():
            jq = np.asarray(local[k].qt.addressable_shards[r].data)
            jcs = np.asarray(local[k].col_scales.addressable_shards[r].data)
            np.testing.assert_array_equal(q.T, jq)
            np.testing.assert_array_equal(cs, jcs)
    assert _rel_rmse(out, ref) <= DIT_REL_RMSE
    with tp_ranks.Config(dict(fused_ew=fused_ew)):
        single = _port_single(data["params"], tflux.FluxConfig(**CFG), data["inputs"],
                              data["q8"], w8a8=True)
    assert _rel_rmse(out, single) <= DIT_REL_RMSE
    expected = CFG["depth"] * 8 + CFG["depth_single_blocks"] * 4 if fused_ew else 0
    for r in res:
        assert r[f"{key}_engaged"] == expected
        _check_collectives(r[f"{key}_counts"])


def test_fused_attention_matches_jax_spmd(case):
    """K3 interleaved per rank on its 2 of 4 heads, the RoPE basis permuted
    before the interleave."""
    data, res = case.data, case.res
    out = _both_ranks(res, "fused")
    np.testing.assert_allclose(out, case.jax["fused"], atol=3e-4)
    single = _port_single(data["params"], tflux.FluxConfig(**CFG), data["inputs"], fused=True)
    np.testing.assert_allclose(out, single, atol=3e-4)
    for r in res:
        _check_collectives(r["fused_counts"])


def test_scan_layout_matches_unrolled(case):
    """The rank's shards stacked (``to_spmd_model(scan_blocks=True)``)
    against the unrolled TP forward and the port's single-device fused
    forward, at depth (2, 2)."""
    data, res = case.data, case.res
    out, unrolled = _both_ranks(res, "scan"), _both_ranks(res, "scan_unrolled")
    np.testing.assert_allclose(out, unrolled, atol=3e-4)
    single = _port_single(data["params2"], tflux.FluxConfig(**CFG2), data["inputs"],
                          fused=True)
    np.testing.assert_allclose(unrolled, single, atol=3e-4)
    for r in res:
        _check_collectives(r["scan_counts"], per_call=4 * 2 + 2)


def test_lora_matches_jax_spmd(case):
    """LoRA factors cut with their base (``up`` rows of the column-parallel
    qkv in the interleaved keyspace, ``down`` columns of the row-parallel
    proj); to_spmd_model keeps LoRA-patched shards unrolled, with the JAX
    warning."""
    data, res = case.data, case.res
    out = _both_ranks(res, "lora")
    assert set(res[0]["lora_kinds"]) == {"double_blocks.0.img_attn.qkv.weight",
                                         "double_blocks.0.img_attn.proj.weight"}
    np.testing.assert_allclose(out, case.jax["lora"], atol=5e-4)
    single = _port_single(data["params_lora"], tflux.FluxConfig(**CFG), data["inputs"],
                          data["q8_lora"], patches=data["patches"])
    np.testing.assert_allclose(out, single, atol=5e-4)
    for r in res:
        _check_collectives(r["lora_counts"])
        stacked, records = r["lora_scan_fallback"]
        assert not stacked
        assert any("flux_scan unavailable under spmd" in m for m in records)


def test_ksample_fbcache_same_decisions_on_both_ranks(case):
    """A Q8_0 euler ksample with FBCache forced to hit (at most two in a
    row) on 2 ranks: both ranks take the same hits, the single device's
    hits, and reach its latent."""
    data, res = case.data, case.res
    out = _both_ranks(res, "ksample")
    assert res[0]["ksample_history"] == res[1]["ksample_history"]
    assert True in res[0]["ksample_history"] and False in res[0]["ksample_history"]
    sd = tp_ranks.host_sd(data["params"], data["q8"])
    p = tbase.f32_qk_norms(tggml.to_device_quantized(sd, dtype=torch.float32, device="cpu"))
    model = tbase.flux_bundle(p, tflux.FluxConfig(**CFG), torch.device("cpu"))
    tfb.history.clear()
    pos = tcfg_mod.CondInput(cross_attn=tp_ranks._t(data["ks_ctx"]),
                             pooled=tp_ranks._t(data["ks_pooled"]), guidance=3.5)
    ref = tks.ksample(model, seed=7, steps=4, cfg_scale=1.0, sampler_name="euler",
                      scheduler="beta", positive=pos, negative=None,
                      latent_image=torch.zeros((1, 8, 8, CFG["in_channels"])),
                      fbcache=tfb.FBCacheConfig(**FBCACHE)).latent.numpy()
    assert res[0]["ksample_history"] == tfb.history
    tfb.history.clear()
    np.testing.assert_allclose(out, ref, atol=1e-3)


def test_diverging_ranks_fail_within_the_timeout(case):
    """Ranks whose FBCache decisions differ stop pairing their all-reduces:
    a rank fails (a collective of the wrong size, a peer gone, or gloo's
    5 s timeout), not the spawn's deadline (TimeoutError), so the
    divergence fails instead of hanging."""
    import torch.multiprocessing as mp

    with pytest.raises((mp.ProcessRaisedException, mp.ProcessExitedException)):
        case.diverge.join()


def test_heads_not_divisible_refused(case):
    res = case.res
    assert res[0]["heads_refusal"] == "num_heads 3 not divisible by tp=2"


def test_sd15_data_parallel_batch_matches_single(case):
    """``shard_batch`` on a (2, 1) mesh: each rank, holding the whole
    model, takes its row of a batch of 2, denoised as the single forward
    denoises it, with no collective."""
    data, res = case.data, case.res
    ucfg = tunet.UNetConfig(**UCFG, dtype=torch.float32)
    model = tbase.sd15_model(tunet.init_params(ucfg, seed=0), cfg=ucfg, dtype=torch.float32,
                             device="cpu")
    den = tcfg_mod.make_cfg_denoiser(
        model.apply_fn, model.params, model.model_sampling,
        tcfg_mod.CondInput(cross_attn=tp_ranks._t(data["dp_ctx"])), None, 1.0)
    ref = den(tp_ranks._t(data["dp_x"]), torch.full((2,), 5.0))[0].numpy()
    for r in range(2):
        np.testing.assert_allclose(res[r]["dp"], ref[r:r + 1], atol=2e-4, rtol=1e-4)
        c = res[r]["dp_counts"]
        assert c.calls == c.raw_all_reduce == c.others == 0


def test_mesh_smaller_than_the_world_warns(case):
    for r in case.res:
        assert "mesh 1x1 uses 1 of 2 devices" in r["small_mesh_warning"]
