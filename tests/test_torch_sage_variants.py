"""K4's flag variants (``int8_mxu=False``, ``pv_int8=False`` and both)
against the JAX package: the port's plain ``sage_attention`` with each flag
pair against JAX ``sage_attention`` with the same flags (its Pallas kernel
in interpret mode on the CPU), the images of every flag pair (the bf16 V
and the codes widened to bf16 for int8_mxu=False), and the wrapper's
refusals.

Inputs come from a numpy seed and go through both packages. Tolerances, as
``tests/test_torch_sage.py`` states them for K4: SAGE_REL_RMSE relative RMS
error and max |error| within 1e-2 of max |ref| (a last-bit difference of a
mean or a sum can move a p or a code across a rounding edge; with
``pv_int8=False`` P's bf16 rounding instead of its code). ``int8_mxu=False``
multiplies the same integers, whose sums stay below 2^24, so its output is
the default's bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu.ops import sage_attention as jsa
from lightdiffusion_next_tpu_torch.ops import sage_attention as tsa
from test_torch_flux import _rel_rmse, _t
from test_torch_sage import SAGE_REL_RMSE, _qkv

FLAG_PAIRS = [(False, True), (True, False), (False, False)]  # (int8_mxu, pv_int8)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small tensor ops: one torch thread is as fast and leaves the other
    test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(q, k, v, dtype, **flags):
    """(port plain, JAX kernel) on the same inputs in ``dtype``, as f32."""
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    ref = jsa.sage_attention(*(jnp.asarray(a, jd) for a in (q, k, v)), **flags)
    out = tsa.sage_attention(*(_t(a).to(td) for a in (q, k, v)), **flags)
    assert out.dtype == td and out.shape == q.shape
    return out.float().numpy(), np.asarray(ref.astype(jnp.float32))


@pytest.mark.parametrize("int8_mxu,pv_int8", FLAG_PAIRS)
@pytest.mark.parametrize("b,h,lq,lk,d,dtype", [
    (1, 2, 300, 300, 40, "f32"),     # SD1.5 level 0's head dim, ragged L
    (1, 1, 200, 700, 160, "bf16"),   # ragged kv in one block of 768
    (1, 1, 96, 1300, 80, "bf16"),    # two blocks, the second partial and masked
])
def test_variant_plain_matches_jax(b, h, lq, lk, d, dtype, int8_mxu, pv_int8):
    rng = np.random.default_rng(lq + lk + d)
    q, k, v = _qkv(rng, b, h, lq, lk, d)
    flags = dict(int8_mxu=int8_mxu, pv_int8=pv_int8)
    out, ref = _both(q, k, v, dtype, **flags)
    assert _rel_rmse(out, ref) <= SAGE_REL_RMSE
    assert np.abs(out - ref).max() <= 1e-2 * np.abs(ref).max()
    # int8_mxu=False multiplies the same integers exactly: the default's output
    same_pv = tsa.sage_attention(*(_t(a) for a in (q, k, v)), pv_int8=pv_int8)
    if not int8_mxu:
        np.testing.assert_array_equal(
            tsa.sage_attention(*(_t(a) for a in (q, k, v)), **flags).numpy(), same_pv.numpy())


def test_quality_variant_is_closer_to_exact_attention():
    """pv_int8=False drops P's and V's int8 rounding: its error against
    exact attention is below the default's, and V + c still moves the output
    by c."""
    rng = np.random.default_rng(11)
    q, k, v = (_t(a) for a in _qkv(rng, 1, 2, 256, 512, 64))
    exact = torch.nn.functional.scaled_dot_product_attention(
        q.double(), k.double(), v.double()).float().numpy()
    err_int8 = _rel_rmse(tsa.sage_attention(q, k, v).numpy(), exact)
    err_bf16 = _rel_rmse(tsa.sage_attention(q, k, v, pv_int8=False).numpy(), exact)
    assert err_bf16 < err_int8 < 5e-2
    base = tsa.sage_attention(q, k, v, pv_int8=False).numpy()
    shifted = tsa.sage_attention(q, k, v + 100.0, pv_int8=False).numpy()
    np.testing.assert_allclose(shifted - base, 100.0, rtol=0, atol=5e-3)


def test_quality_preparation_matches_jax():
    """pv_int8=False's V: the centred V rounded to bf16 (the JAX wrapper's
    ``vf.astype(bfloat16)``) and svs ones; Q's and K's codes and scales are
    the default's."""
    rng = np.random.default_rng(12)
    q, k, v = (_t(a) for a in _qkv(rng, 1, 2, 130, 150, 40, scale=2.0))
    qq, sq, kq, sk, vq, svs, vmu = tsa.prepare(q, k, v, pv_int8=False)
    default = tsa.prepare(q, k, v)
    for got, want in zip((qq, sq, kq, sk, vmu), default[:4] + default[6:]):
        assert torch.equal(got, want)
    vf = jnp.asarray(v.numpy())
    jv = (vf - jnp.mean(vf, axis=2, keepdims=True)).astype(jnp.bfloat16)
    assert vq.dtype == torch.bfloat16 and torch.equal(svs, torch.ones_like(vmu))
    diff = np.abs(vq.float().numpy() - np.asarray(jv.astype(jnp.float32)))
    assert diff.max() <= 2.0 ** -7 * np.abs(np.asarray(jv.astype(jnp.float32))).max()
    assert (diff > 0).mean() <= 1e-3


def _unswizzle_rows(block, rows):
    """One 32-byte-swizzled slice of ``rows`` rows, unswizzled by hand:
    (rows, 32) bytes, the two 16-byte halves swapped back in rows 4-7 of
    each 8."""
    t = block.reshape(rows, 2, 16)
    swap = torch.tensor([(r >> 2) & 1 for r in range(rows)]).bool().view(rows, 1, 1)
    return torch.where(swap, t.flip(1), t).reshape(rows, 32)


@pytest.mark.parametrize("b,h,lq,lk,d", [(2, 3, 70, 100, 40), (1, 1, 130, 200, 160)])
def test_bf16_v_images_layout(b, h, lq, lk, d):
    """The pv_int8=False kv images (``pack_operands`` of a bf16 V): K's codes
    and sk as the default's, then V in bf16, [BN / 16][d][32 bytes] per
    image, the 16 tokens of each k16 slice in their natural order,
    32-byte-swizzled; read back, zero past Lk."""
    rng = np.random.default_rng(13 + d)
    q, k, v = (_t(a) for a in _qkv(rng, b, h, lq, lk, d))
    ops = tsa.prepare_plain(q, k, v, pv_int8=False)
    ref = tsa.prepare_plain(q, k, v)
    dp, dv, bn = tsa.geometry(d)
    assert ops.kvimg.shape[-1] == tsa.kv_image_bytes(d, False) == bn * (dp + 4) + 2 * d * bn
    assert (ops.int8_mxu, ops.pv_int8) == (True, False) and (ref.int8_mxu, ref.pv_int8) == (True, True)
    assert torch.equal(ops.qimg, ref.qimg)
    assert torch.equal(ops.kvimg[..., :bn * (dp + 4)], ref.kvimg[..., :bn * (dp + 4)])
    vc = tsa.unpack_operands(ops, d)[4]
    vq = tsa.prepare(q, k, v, pv_int8=False)[4].reshape(b * h, lk, d)
    assert torch.equal(vc[:, :lk], vq) and not vc[:, lk:].float().any()
    # the first k16 slice of the first image, by hand: channel row c holds
    # tokens 0..15 in order
    off = bn * (dp + 4)
    first = _unswizzle_rows(ops.kvimg[0, 0, off:off + 32 * d], d).view(torch.bfloat16)
    assert torch.equal(first, vq[0, :16].T)
    assert tsa.prep_agreement(ops, ops, d)["ok"]


@pytest.mark.parametrize("d", tsa.HEAD_DIMS)
def test_widened_images_round_trip(d):
    """int8_mxu=False's images at every head dim, a ragged length: Q's and
    K's codes widened to bf16 in k16 slices of KP = d padded to 16, V bf16
    in natural order (its codes widened, or the centred values); read back
    bit for bit ``prepare``'s codes and the int8 layout's, zero padding, and
    the raw bytes of a slice are the codes' bf16."""
    rng = np.random.default_rng(31 + d)
    lq, lk = 70, 150
    q, k, v = (_t(a) for a in _qkv(rng, 1, 1, lq, lk, d))
    _, dv, bn = tsa.geometry(d)
    kp = -(-d // 16) * 16
    int8 = tsa.unpack_operands(tsa.prepare_plain(q, k, v), d)
    for pv_int8 in (True, False):
        qq, sq, kq, sk, vq, svs, vmu = tsa.prepare(q, k, v, pv_int8)
        ops = tsa.prepare_plain(q, k, v, pv_int8=pv_int8, int8_mxu=False)
        assert (ops.int8_mxu, ops.pv_int8) == (False, pv_int8)
        assert tsa.row_elems(d, False) == kp and tsa.row_bytes(d, False) == 2 * kp
        assert ops.qimg.shape[-1] == tsa.q_image_bytes(d, False) == 64 * (2 * kp + 4)
        assert ops.kvimg.shape[-1] == tsa.kv_image_bytes(d, pv_int8, False) \
            == bn * (2 * kp + 4) + 2 * d * bn
        qc, qs, kc, ks, vc = tsa.unpack_operands(ops, d)
        assert qc.dtype == kc.dtype == torch.int8 and qc.shape[-1] == kp
        assert torch.equal(qc[0, :lq, :d], qq.reshape(lq, d))
        assert torch.equal(kc[0, :lk, :d], kq.reshape(lk, d))
        assert torch.equal(qc, int8[0][..., :kp]) and torch.equal(kc, int8[2][..., :kp])
        assert torch.equal(qs, int8[1]) and torch.equal(ks, int8[3])
        assert not qc[:, lq:].any() and not qc[..., d:].any() and not kc[:, lk:].any()
        assert vc.shape == (1, -(-lk // bn) * bn, d) and not vc[:, lk:].float().any()
        assert torch.equal(vc[0, :lk], vq.reshape(lk, d))
        # K's first k16 slice of the first image, by hand: row r's 16 codes
        first = _unswizzle_rows(ops.kvimg[0, 0, :32 * bn], bn).view(torch.bfloat16)
        want = torch.nn.functional.pad(kq.reshape(lk, d), (0, kp - d))[:bn, :16]
        assert torch.equal(first, want.to(torch.bfloat16))
        # V's: channel row c holds tokens 0..15, as codes widened or values
        off = bn * (2 * kp + 4)
        first = _unswizzle_rows(ops.kvimg[0, 0, off:off + 32 * d], d).view(torch.bfloat16)
        assert torch.equal(first, vq.reshape(lk, d)[:16].T.to(torch.bfloat16))
        assert tsa.prep_agreement(ops, ops, d)["ok"]


def test_variant_launch_refuses_what_it_does_not_take():
    q = torch.zeros((1, 1, 512, 40))
    ops = tsa.prepare_plain(q, q, q, pv_int8=False)
    with pytest.raises(ValueError):
        tsa._launch_variant(q, ops, True, False)        # CPU tensors
    with pytest.raises(ValueError):
        tsa._launch_variant(q, ops, True, True)         # that is K4
    with pytest.raises(ValueError):
        tsa.prepare_kernel(q, q, q, pv_int8=False)
    assert set(tsa.VARIANT_COUNTERS) == set(FLAG_PAIRS)
