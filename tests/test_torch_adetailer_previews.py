"""The whole ADetailer and preview flows, in the port against the JAX
package, from the tiny checkpoint of scripts/make_tiny_assets.py under a
temporary asset root shared by every test here.

- ``pipeline(prompt, 128, 128, adetailer=True, progress_callback=
  PreviewHook(...))`` without ``yolos/`` files and with a tiny TAESD
  decoder file: the PNG is bit for bit the plain run's (no detection, and
  previews change nothing), saved under "Adetailer/LD-head", within one
  uint8 level of the JAX one; the TAESD previews at the same steps with
  the same progress, within one level of the JAX package's.
- The same with placeholder YOLO files and a stand-in detector patched
  into both packages' ``detailer`` module (fixed person and face masks;
  the buckets cut to 64-128 pixels in both: at the default 512-768 the
  JAX UNet's attention takes minutes on the CPU) and no TAESD file: both
  passes run, the PNG is within two uint8 levels of the JAX one and bit
  for bit the port's run without previews; the linear RGB previews of
  the first pass and of each segment at the same steps with the same
  progress, within one level (first pass) and two (segments) of the JAX
  package's.
- The CLI's ``--adetailer --preview --autohdr --reuse-seed`` (the
  pipeline's defaults) then gives that PNG bit for bit, with the
  detectors from the model cache.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_previews import JRec, TRec, _write_taesd

from lightdiffusion_next_tpu.app import instance as jinst
from lightdiffusion_next_tpu.pipelines import detailer as jdet
from lightdiffusion_next_tpu.pipelines import pipeline as jpipe
from lightdiffusion_next_tpu_torch.app import cli as tcli
from lightdiffusion_next_tpu_torch.app import instance as tinst
from lightdiffusion_next_tpu_torch.pipelines import detailer as tdet
from lightdiffusion_next_tpu_torch.pipelines import loader as tloader
from lightdiffusion_next_tpu_torch.pipelines import pipeline as tpipe
from lightdiffusion_next_tpu_torch.utils import image as timage

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = "a (cute:1.2) cat on a mat"
SEED = 13
YOLOS = ("person_yolov8m-seg.pt", "face_yolov9c.pt")
# the previews of the first pass: every=5 under the default multi-scale
# plan (samplers.chunk_marks)
FIRST_PASS_PREVIEWS = 6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stand_in(mod, calls, inits):
    """An ``UltralyticsDetector`` stand-in: the person file finds a
    person-sized mask, the face file a face-sized one (128^2 image)."""

    class Detector:
        def __init__(self, path):
            inits.append(os.path.basename(path))
            self.person = os.path.basename(path) == YOLOS[0]

        def detect(self, image, threshold=0.5):
            calls.append(os.path.basename(YOLOS[0] if self.person else YOLOS[1]))
            h, w = image.shape[1:3]
            m = np.zeros((h, w), np.float32)
            if self.person:
                m[20:120, 40:90] = 1.0
            else:
                m[28:52, 54:74] = 1.0
            return mod.StaticMaskDetector([m]).detect(image, threshold)

    return Detector


def _write_checkpoint(root):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import make_tiny_assets
    finally:
        sys.path.pop(0)
    return make_tiny_assets.main(str(root))


def _png(path):
    return np.asarray(Image.open(path).convert("RGB")).astype(np.int32)


@pytest.fixture(scope="module")
def flow(tmp_path_factory):
    """The port's plain run, then ``adetailer=True`` with a PreviewHook
    (every=5) in both packages: with a TAESD file and no detector files
    (``flow[True]``), then with the stand-in detectors and no TAESD file
    (``flow[False]``, and the port's run without the hook)."""
    root = tmp_path_factory.mktemp("assets")
    _write_checkpoint(root)
    mp = pytest.MonkeyPatch()
    mp.setenv("LDT_ASSET_ROOT", str(root))
    mp.setenv("LDT_OFFLINE", "1")
    mp.setattr(tpipe, "_TAESD_CACHE", {})
    mp.setattr(jpipe, "_TAESD_CACHE", {})
    kw = dict(prio_speed=True, seed=SEED, device="cpu")
    jkw = dict(prio_speed=True, reuse_seed=True)
    runs = {"root": root, "calls": {"torch": [], "jax": []}, "inits": []}

    def both_packages(label):
        t, j = TRec(str(root / f"tprev_{label}")), JRec(str(root / f"jprev_{label}"))
        paths = tpipe.pipeline(PROMPT, 128, 128, adetailer=True, **kw,
                               output_dir=str(root / f"t_{label}"),
                               progress_callback=tinst.PreviewHook(t, every=5))
        (root / "last_seed.txt").write_text(str(SEED))
        jpaths = jpipe.pipeline(PROMPT, 128, 128, adetailer=True, **jkw,
                                output_dir=str(root / f"j_{label}"),
                                progress_callback=jinst.PreviewHook(j, every=5))
        return paths, t, jpaths, j

    try:
        runs["plain"] = tpipe.pipeline(PROMPT, 128, 128, output_dir=str(root / "plain"), **kw)
        taesd_path, _ = _write_taesd(str(root))
        runs[True] = both_packages("through")

        os.remove(taesd_path)
        os.makedirs(root / "yolos")
        for name in YOLOS:
            (root / "yolos" / name).write_bytes(b"")
        mp.setattr(tdet, "UltralyticsDetector",
                   _stand_in(tdet, runs["calls"]["torch"], runs["inits"]))
        mp.setattr(jdet, "UltralyticsDetector", _stand_in(jdet, runs["calls"]["jax"], []))
        for mod in (tdet, jdet):
            mp.setattr(mod, "DetailerConfig",
                       functools.partial(mod.DetailerConfig, guide_size=64, max_size=128))
        runs[False] = both_packages("both")
        runs["both_plain"] = tpipe.pipeline(PROMPT, 128, 128, adetailer=True,
                                            output_dir=str(root / "both_plain"), **kw)
        yield runs
    finally:
        mp.undo()
        tloader.get_model_cache().clear()


@pytest.mark.parametrize("taesd", [False, True])
def test_pipeline_previews_match_jax(flow, taesd):
    """The previews' steps, progress and images against the JAX package's;
    the final PNG bit for bit the port's run without previews."""
    paths, t, jpaths, j = flow[taesd]
    assert t.progress_at == j.progress_at and len(t.images) == len(j.images)
    # the first pass, then (without TAESD) 4 previews of each segment's 20
    # steps at every=5
    assert len(t.images) == FIRST_PASS_PREVIEWS + (0 if taesd else 2 * 4)
    assert t.progress.get() == j.progress.get() == 1.0
    for k, (a, b) in enumerate(zip(t.images, j.images)):
        assert a.shape == b.shape
        if k < FIRST_PASS_PREVIEWS:
            assert a.shape == ((1, 128, 128, 3) if taesd else (1, 16, 16, 3))
        tol = 1 if k < FIRST_PASS_PREVIEWS else 2
        assert np.abs(timage.to_uint8(a).astype(int) - timage.to_uint8(b)).max() <= tol
    assert len(t.get_latest_previews(8)) == tinst.KEEP_PREVIEWS
    assert all(_png(p).shape == t.images[-1].shape[1:] for p in t.get_latest_previews(8))
    without = flow["plain"] if taesd else flow["both_plain"]
    np.testing.assert_array_equal(_png(paths[0]), _png(without[0]))


def test_adetailer_without_detector_files_passes_through(flow):
    (path,), _, jpaths, _ = flow[True]
    assert path.endswith(os.path.join("Adetailer", "LD-head_00001_.png"))
    np.testing.assert_array_equal(_png(path), _png(flow["plain"][0]))
    assert np.abs(_png(path) - _png(jpaths[0])).max() <= 1


def test_adetailer_both_passes_match_jax(flow):
    # the run with previews, then the one without
    assert flow["calls"]["torch"] == list(YOLOS) * 2
    assert flow["calls"]["jax"] == list(YOLOS)
    paths, _, jpaths, _ = flow[False]
    ours, theirs = _png(paths[0]), _png(jpaths[0])
    assert ours.shape == (128, 128, 3)
    assert np.abs(ours - theirs).max() <= 2
    plain = _png(flow["plain"][0])
    assert not np.array_equal(ours[20:120, 40:90], plain[20:120, 40:90])


def test_cli_adetailer_preview(flow, capsys):
    out_dir = str(flow["root"] / "cli")
    n = len(flow["calls"]["torch"])
    (flow["root"] / "last_seed.txt").write_text(str(SEED))
    assert tcli.main([PROMPT, "128", "128", "--adetailer", "--preview", "--prio-speed",
                      "--autohdr", "--reuse-seed", "--output-dir", out_dir], device="cpu") == 0
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed == [os.path.join(out_dir, "Adetailer", "LD-head_00001_.png")]
    np.testing.assert_array_equal(_png(printed[0]), _png(flow[False][0][0]))
    assert flow["calls"]["torch"][n:] == list(YOLOS)
    assert flow["inits"] == list(YOLOS)  # the detectors came from the model cache
    previews = sorted(os.listdir(os.path.join(out_dir, "preview")))
    assert len(previews) == 4 and all(p.endswith(".png") for p in previews)
