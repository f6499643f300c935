"""The port's ``PrefetchLoader`` (``parallel/data.py``) case for case
against JAX ``tests/test_data_loader.py``: order, placement over the
"data" axis, prefetching ahead, a source's error at its batch, ``close``,
single pass, and driving the sharded train step.

Placement and the train step run on 2 gloo ranks (one spawn,
``tp_ranks.loader_worker``) on a (2, 1) mesh, against JAX's
``prefetch_to_mesh`` on a (2, 1) mesh of the virtual CPU devices: each
rank's rows bit for bit JAX's shard on that device, and the two steps'
losses within 1e-5 of JAX's trainer fed by its loader (JAX's test's config
and batches; its mesh is (2, 4), here "model" is 1). The rest runs here on
the CPU; ``tests/test_torch_cuda.py`` holds the card's side stream and
pinned copies.
"""

import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

import tp_ranks
from lightdiffusion_next_tpu.models import flux as jflux
from lightdiffusion_next_tpu.parallel import data as jdata
from lightdiffusion_next_tpu.parallel import trainer as jtrainer
from lightdiffusion_next_tpu.parallel.mesh import make_mesh as jmake_mesh
from lightdiffusion_next_tpu_torch.parallel import data as data_mod

CFG = dict(in_channels=4, hidden_size=128, num_heads=4, depth=1, depth_single_blocks=1,
           axes_dim=(8, 12, 12), context_in_dim=32, vec_in_dim=16)


def _batches(n, start=0, rows=4):
    for i in range(start, start + n):
        yield {"x": np.full((rows, 2), i, np.float32) + np.arange(rows)[:, None],
               "i": np.int32(i)}


def _train_batches():
    """JAX's test's source, drawn once."""
    rng = np.random.default_rng(0)
    return [{
        "latent": rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
        "noise": rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
        "t": rng.uniform(0, 1, (2,)).astype(np.float32),
        "context": rng.standard_normal((2, 4, 32)).astype(np.float32),
        "y": rng.standard_normal((2, 16)).astype(np.float32),
        "guidance": np.full((2,), 3.5, np.float32),
    } for _ in range(2)]


@dataclasses.dataclass
class Case:
    res: list  # each rank's results
    jax_placed: list  # JAX's shards of the first batch, by device
    jax_losses: list


def _jax_refs(batches):
    mesh = jmake_mesh(2, 1)
    loader = jdata.prefetch_to_mesh(_batches(2), mesh)
    b = next(iter(loader))
    placed = [np.asarray(s.data) for s in sorted(b["x"].addressable_shards,
                                                  key=lambda s: s.device.id)]
    loader.close()
    mesh, params, opt_state, step, _ = jtrainer.build_sharded_trainer(
        2, 1, jflux.FluxConfig(**CFG))
    losses = []
    with mesh:
        for batch in jdata.prefetch_to_mesh(iter(batches), mesh):
            params, opt_state, loss = step(params, opt_state, batch)
            losses.append(float(loss))
    return placed, losses


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("loader")
    batches = _train_batches()
    torch.save(dict(cfg=CFG, placed=list(_batches(2)), batches=batches), str(tmp / "data.pt"))
    ranks = tp_ranks.start(tp_ranks.loader_worker, tmp, str(tmp / "data.pt"))
    try:
        placed, losses = _jax_refs(batches)
        yield Case(ranks.join(), placed, losses)
    finally:
        ranks.kill()


def test_order_and_values_preserved():
    loader = data_mod.PrefetchLoader(_batches(5), device="cpu")
    seen = [int(b["i"]) for b in loader]
    assert seen == [0, 1, 2, 3, 4]


def test_batches_are_device_resident():
    loader = data_mod.PrefetchLoader(_batches(1), device="cpu")
    b = next(iter(loader))
    assert isinstance(b["x"], torch.Tensor) and b["x"].device == torch.device("cpu")
    np.testing.assert_array_equal(b["x"].numpy(), next(_batches(1))["x"])
    loader.close()


def test_numpy_leaves_take_jax_dtypes():
    """Numpy's 64-bit defaults (a float64 draw, an int64 arange, a Python
    float) arrive with the dtypes and values JAX's loader gives them,
    float32 and int32, so a float64 source trains against f32 weights; a
    tensor keeps its dtype."""
    rng = np.random.default_rng(0)
    batch = {"x": rng.standard_normal((4, 2)), "i": np.arange(4), "s": 0.5}
    loader = jdata.PrefetchLoader(iter([batch]))
    want = next(iter(loader))
    loader.close()
    got = next(iter(data_mod.PrefetchLoader(
        iter([dict(batch, t=torch.zeros(2, dtype=torch.float64))]), device="cpu")))
    for k in batch:
        assert str(got[k].dtype) == "torch." + str(want[k].dtype), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["t"].dtype == torch.float64


def test_sharded_over_data_axis(case, record_property):
    """Each rank's rows of a batch of 4 on (2, 1) are JAX's shard on that
    device; the rank-0 leaf (the batch index) stays whole."""
    record_property("rank_seconds", tp_ranks.SECONDS["loader_worker"])
    for r in range(2):
        placed = case.res[r]["placed"]
        np.testing.assert_array_equal(placed["x"], case.jax_placed[r])
        assert placed["x"].shape == (2, 2) and placed["i"].shape == () and placed["i"] == 0


def test_prefetches_ahead_of_consumer():
    """With depth=2 the producer runs ahead: after the consumer takes batch
    0, the loader has copied more than one batch with no further pull."""
    produced = []

    def source():
        for i in range(4):
            produced.append(i)
            yield {"x": np.full((2,), i, np.float32)}

    loader = data_mod.PrefetchLoader(source(), depth=2, device="cpu")
    it = iter(loader)
    next(it)
    deadline = time.time() + 5.0
    while loader.transferred < 3 and time.time() < deadline:
        time.sleep(0.01)
    assert loader.transferred >= 3  # 1 consumed + 2 queued ahead
    loader.close()


def test_source_error_propagates_at_failing_batch():
    def source():
        yield {"x": np.zeros((2,), np.float32)}
        raise RuntimeError("decode failed")

    loader = data_mod.PrefetchLoader(source(), device="cpu")
    it = iter(loader)
    next(it)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)


def test_close_stops_thread_midstream():
    def source():
        i = 0
        while True:  # infinite source
            yield {"x": np.full((2,), i, np.float32)}
            i += 1

    loader = data_mod.PrefetchLoader(source(), depth=1, device="cpu")
    it = iter(loader)
    next(it)
    t0 = time.monotonic()
    loader.close()
    assert time.monotonic() - t0 < 5.0
    alive = [t for t in threading.enumerate() if t.name == "ldt-prefetch"]
    assert not alive


def test_single_pass_guard():
    loader = data_mod.PrefetchLoader(_batches(1), device="cpu")
    list(loader)
    with pytest.raises(RuntimeError, match="single-pass"):
        iter(loader)


def test_depth_must_be_positive():
    with pytest.raises(ValueError, match="depth must be >= 1"):
        data_mod.PrefetchLoader(_batches(1), depth=0, device="cpu")


def test_drives_the_sharded_train_step(case):
    """The data-parallel trainer on 2 ranks fed by ``prefetch_to_mesh``:
    both batches taken, each step's loss (the mean over "data") JAX's
    trainer's fed by its loader, the same on both ranks."""
    for r in range(2):
        assert case.res[r]["transferred"] == 2
        np.testing.assert_allclose(case.res[r]["losses"], case.jax_losses, rtol=1e-5)
    assert case.res[0]["losses"] == case.res[1]["losses"]
