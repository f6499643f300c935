"""``pipeline(..., flux_enabled=True)`` across 2 gloo ranks from tiny GGUF
files (``LDT_FLUX_TP`` spmd and off under the card's toggles, auto with
``w8a8``, ``flux_scan`` and ``fused_attn`` off; ``tp_ranks.pipeline_worker``)
against the single-rank run of the same files, seed and toggles. "auto"
and "spmd" are one tensor-parallel load whose configuration the toggles
choose.

Each rank draws its own seed; both run rank 0's, rank 0 alone writes the
PNG, and the final latents are the same on both ranks. Tolerances on the
final latent after 20 steps, against the single-device run: "auto" and
"off" (Q8_0, or the single-device path itself) relative RMS error 1e-4;
"spmd" (W8A8 with fused-EW) ``DIT_REL_RMSE`` (1e-2, the port's W8A8 DiT
tolerance; 1.7e-3 here): a row-parallel shard row-quantizes its half of
each activation row with its own scale, where one device quantizes the
whole row with one.
"""

import os

import numpy as np
import pytest
import torch

import tp_ranks
from lightdiffusion_next_tpu_torch.app import cli as tcli
from lightdiffusion_next_tpu_torch.pipelines import loader as tloader
from lightdiffusion_next_tpu_torch.pipelines import pipeline as tpipe
from test_torch_flux import _rel_rmse
from test_torch_flux_gguf import _write_flux_assets
from test_torch_w8a8 import DIT_REL_RMSE

CARD = dict(w8a8=True, fused_ew=True, flux_scan=True, fused_attn=True)
SEED, OTHER_DRAW = 777, 999
DEPTH, SINGLE = 1, 1  # the tiny DiT's (test_torch_flux.TINY)


Q8 = dict(w8a8=False, flux_scan=False, fused_attn=False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the DiT's config, each rank's results, the single-device final
    latents under the card's toggles and under ``Q8``, computed while the
    ranks run)."""
    tmp = tmp_path_factory.mktemp("flux_tp")
    root = str(tmp / "assets")
    cfg = _write_flux_assets(root)
    ranks = tp_ranks.start(tp_ranks.pipeline_worker, tmp, root, str(tmp / "out"),
                           (SEED, OTHER_DRAW))
    try:
        with pytest.MonkeyPatch.context() as mp:
            single = {name: _single_latent(root, mp, tmp_path_factory.mktemp(name), **fields)
                      for name, fields in (("card", CARD), ("q8", Q8))}
        yield cfg, ranks.join(), single
    finally:
        ranks.kill()


def _single_latent(root, monkeypatch, tmp_path, **fields):
    """The final latent of the single-device pipeline on the same files,
    with one thread as each rank has."""
    monkeypatch.setenv("LDT_ASSET_ROOT", root)
    monkeypatch.setenv("LDT_OFFLINE", "1")
    monkeypatch.setenv("LDT_FLUX_TP", "off")
    seen = {}
    real = tpipe.ks.ksample

    def recording(model, **kw):
        r = real(model, **kw)
        seen["latent"] = r.latent.numpy()
        return r

    monkeypatch.setattr(tpipe.ks, "ksample", recording)
    tloader.get_model_cache().clear()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with tp_ranks.Config(fields):
            tpipe.pipeline("a castle", 64, 64, flux_enabled=True, device="cpu", seed=SEED,
                           output_dir=str(tmp_path))
    finally:
        torch.set_num_threads(threads)
        tloader.get_model_cache().clear()
    return seen["latent"]


@pytest.mark.parametrize("mode", ["spmd", "auto", "off"])
def test_ranks_agree_and_rank0_writes(runs, mode, record_property):
    _, res, _ = runs
    record_property("rank_seconds", tp_ranks.SECONDS["pipeline_worker"])
    r0, r1 = res[0][mode], res[1][mode]
    assert r0["seed"] == r1["seed"] == SEED  # rank 1 drew OTHER_DRAW
    np.testing.assert_array_equal(r0["latent"], r1["latent"])
    assert r0["history"] == r1["history"] and len(r0["history"]) >= 20
    assert len(r0["paths"]) == 1 and r1["paths"] == []
    assert r0["paths"][0].endswith(".png") and os.path.exists(r0["paths"][0])
    assert r0["pngs"] == r1["pngs"] and len(r0["pngs"]) == 1


@pytest.mark.parametrize("mode", ["spmd", "auto"])
def test_all_reduces_per_dit_call(runs, mode):
    """4 per double block and 1 per single block on a miss, double block
    0's 4 on an FBCache hit, each (B, L, hidden) wide; besides them only
    the seed's and the stop flag's broadcasts, and under spmd the load's
    column maxima of the W8A8 requant, one per row-parallel weight (4 a
    double block, 2 a single block)."""
    cfg, res, _ = runs
    for r in res:
        run = r[mode]
        hits = sum(run["history"])
        misses = len(run["history"]) - hits
        n = (4 * DEPTH + SINGLE) * misses + 4 * hits
        load = 4 * DEPTH + 2 * SINGLE if mode == "spmd" else 0
        assert run["counts"].calls == n and run["counts"].raw_all_reduce == n + load
        assert run["counts"].widths == {cfg.hidden_size: n}
        # the seed, the stop flag, the next image's seed: broadcasts of rank 0's
        assert run["counts"].others == 3


def _toggle_warnings(records):
    return [m for m in records if "w8a8" in m or "flux_scan" in m or "fused_attn" in m]


def test_spmd_model_and_latent(runs):
    """spmd: the card's configuration per shard (W8A8 stacked, K3 on
    interleaved heads), the cache variant keyed on the mesh, no warning
    on a toggle; the latent against the single device's."""
    _, res, single = runs
    run = res[0]["spmd"]
    assert run["variant"] == "dev=cpu:mesh(1, 2):w8a8:scan:fusedattn"
    assert run["tp"] and run["fused"] and run["stacked"]
    assert "StackedQTensor8W" in run["kinds"] and "QTensor8T" not in run["kinds"]
    assert not _toggle_warnings(run["records"])
    assert _rel_rmse(run["latent"], single["card"]) <= DIT_REL_RMSE


def test_auto_model_warnings_and_latent(runs):
    """auto, the same tensor-parallel load as spmd: with ``w8a8``,
    ``flux_scan`` and ``fused_attn`` off it keeps Q8_0, unrolled and
    unfused, keyed so, with no warning; the latent against the single
    device's run under the same toggles."""
    _, res, single = runs
    run = res[0]["auto"]
    assert run["variant"] == "dev=cpu:mesh(1, 2)"
    assert run["tp"] and not run["fused"] and not run["stacked"]
    assert "QTensor8T" in run["kinds"] and "QTensor8W" not in run["kinds"]
    assert not _toggle_warnings(run["records"])
    assert _rel_rmse(run["latent"], single["q8"]) <= 1e-4


def test_off_takes_the_single_device_path(runs):
    _, res, single = runs
    run = res[0]["off"]
    assert run["variant"] == "dev=cpu:w8a8:scan:fusedattn" and not run["tp"]
    assert run["counts"].calls == 0
    assert _rel_rmse(run["latent"], single["card"]) <= 1e-4


def test_flux_mesh_without_a_process_group(monkeypatch):
    """One process (world size 1): no mesh, whatever LDT_FLUX_TP says; a
    value other than auto, spmd and off is refused, as in the JAX
    pipeline; the CLI initialises no group outside torchrun."""
    for mode in ("auto", "spmd", "off"):
        monkeypatch.setenv("LDT_FLUX_TP", mode)
        assert tpipe._flux_mesh() is None
    monkeypatch.setenv("LDT_FLUX_TP", "gspmd")
    with pytest.raises(ValueError, match="LDT_FLUX_TP='gspmd'"):
        tpipe._flux_mesh()
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tcli.init_distributed() is False
    assert not torch.distributed.is_initialized()
