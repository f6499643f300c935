"""The port's TP layout and rank slices (``parallel/layout.py``,
``parallel/sharding.py``, ``pipelines.weights.from_jax(shard=)``) against
the JAX package's, bit for bit, for every leaf form: dense, ``QTensor8``
(the GGUF host records), ``QTensor8T``, ``QTensor8W`` and ``QTensorLoRA``;
the RoPE permute before the interleave and its refusal after it; LoRA
patches; ``make_mesh``'s checks.

The JAX shards are the ``addressable_shards`` of arrays placed by the JAX
rules on a (1, 2) mesh of the virtual CPU devices; a LoRA's factors are
cut by the JAX spmd rule (``_leaf_specs``), which GSPMD leaves whole.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from lightdiffusion_next_tpu.models import flux as jflux
from lightdiffusion_next_tpu.models import lora as jlora
from lightdiffusion_next_tpu.ops import ggml as jggml
from lightdiffusion_next_tpu.parallel import layout as jlayout
from lightdiffusion_next_tpu.parallel import sharding as jsharding
from lightdiffusion_next_tpu.parallel import spmd as jspmd
from lightdiffusion_next_tpu.parallel.mesh import make_mesh as jmake_mesh
from lightdiffusion_next_tpu_torch.models import flux as tflux
from lightdiffusion_next_tpu_torch.parallel import layout as tlayout
from lightdiffusion_next_tpu_torch.parallel import mesh as tmesh
from lightdiffusion_next_tpu_torch.parallel import sharding as tsharding
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax

CFG = dict(in_channels=4, hidden_size=256, num_heads=2, depth=1, depth_single_blocks=1,
           axes_dim=(16, 56, 56), context_in_dim=32, vec_in_dim=16)
JCFG, TCFG = jflux.FluxConfig(**CFG), tflux.FluxConfig(**CFG)
FORMS = ("dense", "q8", "q8t", "w8", "lora")
Q8 = tflux.Q8_0_SUFFIXES


def _same(x, y, path):
    """Two leaves equal bit for bit: type, dtype, values, nested records."""
    assert type(x) is type(y), path
    if isinstance(x, torch.Tensor):
        assert x.dtype == y.dtype and torch.equal(x, y), path
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            _same(getattr(x, f.name), getattr(y, f.name), f"{path}.{f.name}")
    else:
        assert x == y, path


def assert_same_leaves(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        _same(a[k], b[k], k)


def _patches(seed=1, rank=4):
    """LoRA patches in the checkpoint's keys on every kind of target: qkv
    (column-parallel, interleaved), linear1 (split), linear2 (input-split),
    proj (row-parallel)."""
    rng = np.random.default_rng(seed)
    h = CFG["hidden_size"]

    def pair(out_d, in_d):
        return (rng.standard_normal((out_d, rank)).astype(np.float32) * 0.05,
                rng.standard_normal((rank, in_d)).astype(np.float32) * 0.05, 8.0)

    return {"double_blocks.0.img_attn.qkv.weight": pair(3 * h, h),
            "double_blocks.0.txt_attn.proj.weight": pair(h, h),
            "single_blocks.0.linear1.weight": pair(7 * h, h),
            "single_blocks.0.linear2.weight": pair(h, 5 * h)}


def _jax_sd(form, seed=2):
    """A Flux state dict of one leaf form, in the JAX package's records."""
    sd = jflux.init_params(JCFG, seed=seed)
    rng = np.random.default_rng(seed)
    for k in sd:
        if k.endswith(".bias"):  # non-zero, so a wrong row shows
            sd[k] = (0.1 * rng.standard_normal(sd[k].shape)).astype(np.float32)
    if form == "dense":
        return sd
    for k in [k for k in sd if k.endswith(Q8)]:
        q, s = jggml.quantize_q8_0(sd[k])
        sd[k] = jggml.QTensor8(q, s, sd[k].shape)
        if form != "q8":
            sd[k] = jggml.transpose_for_matmul(
                jggml.QTensor8(jnp.asarray(q), jnp.asarray(s), sd[k].shape))
    if form == "w8":
        return jggml.to_w8a8(sd)
    if form == "lora":
        return jlora.apply_lora(sd, _patches())
    return sd


@pytest.mark.parametrize("form", FORMS)
def test_to_tp_layout_matches_jax(form):
    sd = _jax_sd(form)
    jl, jcfg = jlayout.to_tp_layout(dict(sd), JCFG)
    tl, tcfg = tlayout.to_tp_layout(from_jax(sd), TCFG)
    assert tcfg.tp_layout and jcfg.tp_layout
    assert_same_leaves(tl, from_jax(jl))
    assert tlayout.to_tp_layout(tl, tcfg)[0] is tl  # idempotent
    np.testing.assert_array_equal(tlayout.qkv_interleave_perm(3, 128),
                                  jlayout.qkv_interleave_perm(3, 128))


def _shard_of(arr, mesh, r):
    """The JAX array's shard on the mesh's "model" coordinate r."""
    dev = mesh.devices[0, r]
    return np.asarray(next(s.data for s in arr.addressable_shards if s.device == dev))


def _spec_slice(x, spec, r, tp=2):
    """numpy slice r of x along the "model" dim of a PartitionSpec."""
    x = np.asarray(x)
    for d, name in enumerate(tuple(spec)):
        if name == "model":
            n = x.shape[d] // tp
            x = np.take(x, np.arange(r * n, (r + 1) * n), axis=d)
    return x


@pytest.mark.parametrize("form", FORMS)
def test_rank_slices_match_jax_shards(form):
    """Each rank's slice of the laid-out dict (``shard_leaf``, and
    ``from_jax(shard=)`` of the JAX dict) equals the JAX shard at its mesh
    coordinate; the host GGUF records go through ``shard_state_dict`` as
    the loader's do."""
    mesh = jmake_mesh(1, 2)
    jl, _ = jlayout.to_tp_layout(_jax_sd(form), JCFG)
    if form == "q8":
        jsh = jsharding.shard_state_dict(dict(jl), mesh)
    else:
        jsh = jsharding.shard_params(jl, jsharding.flux_param_shardings(jl, mesh))
    for r in range(2):
        if form == "q8":
            stub = type("Mesh", (), {"get_local_rank": lambda self, d, r=r: r,
                                     "size": lambda self, d: 2})()
            tl = tsharding.shard_state_dict(from_jax(jl), stub, dtype=torch.float32,
                                            device="cpu")
        else:
            tl = from_jax(jl, shard=(r, 2))
            assert_same_leaves(tl, {k: tsharding.shard_leaf(v, tsharding.flux_param_spec(k),
                                                            r, 2)
                                    for k, v in tlayout.to_tp_layout(from_jax(_jax_sd(form)),
                                                                     TCFG)[0].items()})
        for key, leaf in jsh.items():
            got = tl[key]
            if isinstance(leaf, jggml.QTensorLoRA):
                specs = jspmd._leaf_specs(key, jl[key])
                np.testing.assert_array_equal(got.up.numpy(), _spec_slice(jl[key].up, specs.up, r))
                np.testing.assert_array_equal(got.down.numpy(),
                                              _spec_slice(jl[key].down, specs.down, r))
                leaf, got = leaf.base, got.base
            if isinstance(leaf, jggml.QTensor8W):
                np.testing.assert_array_equal(got.q.numpy().T, _shard_of(leaf.qt, mesh, r))
                np.testing.assert_array_equal(got.col_scales.numpy(),
                                              _shard_of(leaf.col_scales, mesh, r))
            elif isinstance(leaf, jggml.QTensor8T):
                np.testing.assert_array_equal(got.qt.numpy(), _shard_of(leaf.qt, mesh, r))
                np.testing.assert_array_equal(got.scales_t.numpy(),
                                              _shard_of(leaf.scales_t, mesh, r))
                assert got.shape == tuple(np.asarray(got.qt.shape)[::-1])
            else:
                np.testing.assert_array_equal(got.numpy(), _shard_of(leaf, mesh, r))


def test_param_specs_match_jax():
    sd = _jax_sd("dense")
    keys = list(sd) + list(jlayout.to_tp_layout(dict(sd), JCFG)[0])
    for k in keys:
        assert tsharding.flux_param_spec(k) == tuple(jsharding.flux_param_spec(k)), k
    assert tsharding.COLUMN == tuple(P("model", None))
    assert tsharding.ROW == tuple(P(None, "model"))


@pytest.mark.parametrize("form", ("dense", "q8", "q8t", "w8"))
def test_permute_rope_basis_rows_then_interleave(form):
    """The RoPE permute of the checkpoint's layout, then the interleave,
    bit for bit JAX's; the port refuses the permute of an interleaved
    layout (it would rope the wrong basis), as the JAX function does, and
    its single-device permute refuses TP layouts."""
    sd = _jax_sd(form)
    jp = jlayout.permute_rope_basis_rows(dict(sd), JCFG)
    tp = tlayout.permute_rope_basis_rows(from_jax(sd), TCFG)
    assert_same_leaves(tp, from_jax(jp))
    tl, tcfg = tlayout.to_tp_layout(tp, TCFG)
    assert_same_leaves(tl, from_jax(jlayout.to_tp_layout(jp, JCFG)[0]))
    with pytest.raises(ValueError, match="BEFORE to_tp_layout"):
        tlayout.permute_rope_basis_rows(tl, tcfg)
    with pytest.raises(ValueError, match="permute_rope_basis_rows"):
        tflux.permute_rope_basis(tl, tcfg)


def test_permute_refuses_lora_leaves():
    with pytest.raises(ValueError, match="LoRA"):
        tlayout.permute_rope_basis_rows(from_jax(_jax_sd("lora")), TCFG)


def test_lora_patches_to_tp_layout_match_jax():
    patches = _patches(seed=3)
    _, jcfg = jlayout.to_tp_layout({}, JCFG)
    _, tcfg = tlayout.to_tp_layout({}, TCFG)
    jp = jlayout.to_tp_layout_patches(patches, jcfg)
    tp = tlayout.to_tp_layout_patches(patches, tcfg)
    assert sorted(tp) == sorted(jp) and "single_blocks.0.linear1_qkv.weight" in tp
    for k in jp:
        for a, b in zip(tp[k][:2], jp[k][:2]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert tp[k][2] == jp[k][2]
    assert tlayout.to_tp_layout_patches(patches, TCFG) is patches  # not laid out


def test_stacked_params_refuse_the_layout():
    p = tflux.stack_block_params(from_jax(_jax_sd("dense")), TCFG)
    with pytest.raises(ValueError, match="before stacking"):
        tlayout.to_tp_layout(p, TCFG)
    with pytest.raises(ValueError, match="cut them into shards first"):
        tflux.stack_block_params({}, dataclasses.replace(TCFG, tp_layout=True))


def test_make_mesh_checks(tmp_path):
    """make_mesh needs a process group and keeps the JAX checks: one -1
    axis absorbs the rest, two are refused, a mesh larger than the world
    is refused (a smaller one warns: ``test_torch_spmd.py``)."""
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh(1, 1)
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        assert tuple(tmesh.make_mesh(1, -1).shape) == (1, 1)
        assert tmesh.make_mesh().mesh_dim_names == ("data", "model")
        with pytest.raises(ValueError, match="only one mesh axis"):
            tmesh.make_mesh(-1, -1)
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            tmesh.make_mesh(1, 2)
        with pytest.raises(ValueError, match="invalid mesh"):
            tmesh.make_mesh(0, 1)
    finally:
        dist.destroy_process_group()
