"""The W8A8 kernels' tile tables (``ops.quant_matmul.w8a8_tile`` and, for
the bf16-rate variant, ``w8a8_bf16_tile``), on the CPU.

The kernel (``csrc/w8a8_matmul.cu``) takes its tile as an id that Python
chooses; these tests hold the choice to what the kernel can run: a tile
for every shape the Flux W8A8 path gives it, whose width divides N, whose
shared-memory ring fits one H100 block, and the C dispatch table equal to
the Python one. The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import os
import re
import sys

import pytest

from lightdiffusion_next_tpu_torch.ops import cuda_build
from lightdiffusion_next_tpu_torch.ops import quant_matmul as qm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = (cuda_build.CSRC / "w8a8_matmul.cu").read_text()
SMEM_PER_BLOCK = 232448  # the shared memory one H100 block can use, bytes
W8A8_KERNELS = ("w8a8_matmul", "w8a8_matmul_ep", "w8a8_matmul_stacked", "w8a8_matmul_ep_stacked")


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


def _main_path_shapes():
    """(M, K, N) of every W8A8 matmul of the Flux 1024^2 path: unrolled and
    scan, FBCache hits, and the missed DiT call with ``fused_ew`` off."""
    cs = _chip_smoke()
    plans = (cs.flux_calls(hits=3, misses=17, w8a8=True),
             cs.flux_calls(hits=3, misses=17, w8a8=True, scan=True),
             cs.unfused_dit_calls(), cs.unfused_dit_calls(scan=True))
    return sorted({tuple(key[1:4]) for plan in plans for key in plan if key[0] in W8A8_KERNELS})


def _valid(tile, n):
    return 0 <= tile < len(qm.W8A8_TILES) and n % qm.W8A8_TILES[tile][1] == 0


def test_every_main_path_shape_gets_a_tile():
    shapes = _main_path_shapes()
    assert len(shapes) >= 10  # linear1, linear2, the double blocks' four, each at 4096/1024/256
    for m, k, n in shapes:
        assert qm.supported_w8a8(m, k, n)
        assert _valid(qm.w8a8_tile(m, n, k), n), (m, k, n)


@pytest.mark.parametrize("m", [1, 63, 64, 65, 300, 1000, 1024, 1281, 4353, 16384])
@pytest.mark.parametrize("n", [128, 384, 3072, 9216, 21504])
def test_ragged_shapes_get_a_tile(m, n):
    assert _valid(qm.w8a8_tile(m, n, 3072), n)


@pytest.mark.parametrize("tile", range(len(qm.W8A8_TILES)))
def test_every_tile_fits_one_block(tile):
    bm, bn, wgs = qm.W8A8_TILES[tile]
    assert qm.w8a8_smem_bytes(tile) <= SMEM_PER_BLOCK
    assert bm % (64 * wgs) == 0 and bn % 64 == 0 and bn <= 256  # m64 tiles, wgmma's N
    # the epilogue's f32 tile (rows padded by 8 floats) fits the ring, and
    # every thread stores the same number of its 16-byte output chunks
    assert bm * (bn + 8) * 4 <= qm.W8A8_STAGES * (bm + bn) * qm.W8A8_BK
    assert bm * bn // 8 % (128 * wgs) == 0


def test_c_dispatch_states_the_python_table():
    cases = re.findall(r"case (\d+): return run<(\d+), (\d+), (\d+), MODE>", SOURCE)
    table = {int(i): (int(w) * int(mt) * 64, int(bn), int(w)) for i, w, mt, bn in cases}
    assert table == dict(enumerate(qm.W8A8_TILES))
    assert f"constexpr int kBK = {qm.W8A8_BK};" in SOURCE
    assert f"constexpr int kStages = {qm.W8A8_STAGES};" in SOURCE


def test_stacked_entry_points_launch_the_unstacked_kernel():
    """One kernel template, with no stacked parameter: the stacked entry
    points offset the block on the host and call the same launch."""
    assert "STACKED" not in SOURCE
    assert len(re.findall(r"__global__", SOURCE)) == 1
    for entry in ("ldt_w8a8_matmul_stacked_fwd", "ldt_w8a8_matmul_ep_stacked_fwd"):
        body = SOURCE.split(f'extern "C" int {entry}(')[1].split("\n}\n")[0]
        assert "block_offset(depth, idx, n, ldb)" in body and "return launch(" in body


def test_tile_choice_fills_the_card_at_the_large_shapes():
    """At M >= 4096 the chosen tile's grid covers every SM at least once."""
    for m, k, n in _main_path_shapes():
        if m >= 4096:
            bm, bn, _ = qm.W8A8_TILES[qm.w8a8_tile(m, n, k)]
            assert -(-m // bm) * (n // bn) >= qm.SMS, (m, k, n)


def test_ablations_find_the_lines_they_replace():
    """``ablate_w8a8.py`` edits the kernel's source text: every line it
    replaces is in the source, and its tile list holds the production
    tiles."""
    sys.path.insert(0, REPO)
    try:
        import ablate_w8a8
    finally:
        sys.path.pop(0)
    for name, edits in ablate_w8a8.ABLATIONS.items():
        for line, _ in edits:
            assert line in SOURCE, name
    tiles = {(w * mt * 64, bn, w) for w, mt, bn in ablate_w8a8.TILES.values()}
    assert set(qm.W8A8_TILES) <= tiles


# --- the bf16-rate variant (int8_mxu=False, csrc/w8a8_matmul_bf16.cu) --------

BF16_SOURCE = (cuda_build.CSRC / "w8a8_matmul_bf16.cu").read_text()


def _valid_bf16(tile, n):
    return 0 <= tile < len(qm.W8A8_BF16_TILES) and n % qm.W8A8_BF16_TILES[tile][1] == 0


@pytest.mark.parametrize("m", [1, 65, 256, 300, 1000, 4353])
@pytest.mark.parametrize("n", [128, 384, 3072, 12288])
def test_bf16_rate_shapes_get_a_tile(m, n):
    assert _valid_bf16(qm.w8a8_bf16_tile(m, n, 3072), n)


@pytest.mark.parametrize("tile", range(len(qm.W8A8_BF16_TILES)))
def test_every_bf16_rate_tile_fits_one_block(tile):
    """Each tile's plan fits one H100 block; its warpgroups hold 64 rows
    each, one m64nBNk16 wgmma with both operands in shared memory (a form
    the generated header has); the epilogue's f32 tile fits the plan, and
    the A and B tiles' 16-byte chunks and the output chunks split evenly
    over the threads."""
    bm, bn, wgs = qm.W8A8_BF16_TILES[tile]
    smem = qm.w8a8_bf16_smem_bytes(tile)
    assert smem <= SMEM_PER_BLOCK
    assert bm == 64 * wgs and bn % 64 == 0 and bn <= 256
    assert ("ss", bn, 0) in _forms()
    assert bm * (bn + 8) * 4 <= smem - 1024
    chunks = (bm * qm.W8A8_BF16_BK // 16, bn * qm.W8A8_BF16_BK // 16, bm * bn // 8)
    assert all(c % (128 * wgs) == 0 for c in chunks)  # A and B a step, the output


def _forms():
    import importlib.util

    spec = importlib.util.spec_from_file_location("wgmma_forms", cuda_build.CSRC / "wgmma_forms.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return [(kind, n, tnsp) for kind, n, tnsp in gen.FORMS]


def test_bf16_rate_c_dispatch_states_the_python_table():
    cases = re.findall(r"case (\d+): return run<(\d+), (\d+), MODE>", BF16_SOURCE)
    table = {int(i): (int(w) * 64, int(bn), int(w)) for i, w, bn in cases}
    assert table == dict(enumerate(qm.W8A8_BF16_TILES))
    assert f"constexpr int kBK = {qm.W8A8_BF16_BK};" in BF16_SOURCE
    assert f"constexpr int kStages = {qm.W8A8_BF16_STAGES};" in BF16_SOURCE
    assert f"constexpr int kWBufs = {qm.W8A8_BF16_BUFS};" in BF16_SOURCE


def test_bf16_rate_tiles_by_shape():
    """128 x 256 where the grid runs waves, 128 x 128 where N is not a
    multiple of 256, 64 x 64 at the text stream's M = 256."""
    assert qm.w8a8_bf16_tile(4352, 12288, 3072) == 0
    assert qm.w8a8_bf16_tile(4352, 3072, 3072) == 0
    assert qm.w8a8_bf16_tile(4352, 384, 3072) == 1
    assert qm.w8a8_bf16_tile(256, 3072, 12288) == 2
    for m, k, n in [(4352, 3072, 3072), (4352, 3072, 12288), (4352, 12288, 3072),
                    (4352, 3072, 9216), (256, 12288, 3072)]:
        bm, bn, _ = qm.W8A8_BF16_TILES[qm.w8a8_bf16_tile(m, n, k)]
        assert 3 * -(-m // bm) * (n // bn) >= 2 * qm.SMS, (m, k, n)
