"""The port's host C++ under the GGUF reader (``utils/native.py``,
``csrc/ldt_native.cpp``): the Q8_0 block split against its plain version
(torch's copies) and the JAX package's ``utils.native.split_q8_0``, bit for
bit, on the blocks of a GGUF file written by the port's ``ggml.write_gguf``;
the reader's records through it; and a build that fails raising, with no
fallback.
"""

import numpy as np
import pytest
import torch

from lightdiffusion_next_tpu.ops import ggml as jggml
from lightdiffusion_next_tpu.utils import native as jnative
from lightdiffusion_next_tpu_torch.ops import ggml as tggml
from lightdiffusion_next_tpu_torch.utils import native


@pytest.fixture(scope="module")
def gguf_file(tmp_path_factory):
    """A GGUF file with Q8_0 weights of a few shapes (one large enough to
    be split by several threads), f16-representable scales of every size
    and an F32 leaf."""
    rng = np.random.default_rng(0)
    tensors = {
        "a.weight": rng.standard_normal((64, 96)).astype(np.float32),
        "b.weight": (rng.standard_normal((16, 64)) * 1e-6).astype(np.float32),  # f16 subnormals
        "c.weight": rng.standard_normal((4096, 1024)).astype(np.float32),  # two threads of blocks
        "c.bias": rng.standard_normal((1024,)).astype(np.float32),
    }
    path = tmp_path_factory.mktemp("gguf") / "w.gguf"
    tggml.write_gguf(str(path), tensors, arch="flux", quantize=("weight",))
    return str(path)


def _q8_blocks(path):
    """{name: its (n, 34) uint8 Q8_0 blocks} read from the file."""
    _, infos, data_start, buf = tggml.parse_gguf(path)
    buf.close()
    out = {}
    with open(path, "rb") as f:
        for info in infos:
            if info.ggml_type != tggml.GGML_Q8_0:
                continue
            n = int(np.prod(info.shape)) // 32
            f.seek(data_start + info.offset)
            out[info.name] = torch.frombuffer(bytearray(f.read(n * 34)),
                                              dtype=torch.uint8).reshape(n, 34)
    return out


def test_split_matches_plain_and_jax(gguf_file, tmp_path, monkeypatch):
    monkeypatch.setenv("LDT_NATIVE_CACHE", str(tmp_path))  # the JAX library's build
    blocks = _q8_blocks(gguf_file)
    assert set(blocks) == {"a.weight", "b.weight", "c.weight"}
    for name, b in blocks.items():
        q, s = native.split_q8_0(b)
        pq, ps = native.split_q8_0_plain(b)
        jq, js = jnative.split_q8_0(b.numpy())
        assert q.dtype == torch.int8 and q.shape == (b.shape[0], 32) and s.dtype == torch.float32
        assert torch.equal(q, pq) and torch.equal(s.view(torch.int32), ps.view(torch.int32)), name
        np.testing.assert_array_equal(q.numpy(), jq)
        np.testing.assert_array_equal(s.numpy().view(np.int32), js.view(np.int32))


def test_reader_records_are_the_plain_splits(gguf_file, monkeypatch):
    """``gguf_sd_loader`` through the C++ split gives the ``QTensor8`` records
    the torch split gives, and the JAX reader's codes and scales."""
    sd = tggml.gguf_sd_loader(gguf_file)
    with monkeypatch.context() as m:
        m.setattr(native, "split_q8_0", native.split_q8_0_plain)
        plain = tggml.gguf_sd_loader(gguf_file)
    ref = jggml.gguf_sd_loader(gguf_file)
    assert set(sd) == set(plain) == set(ref)
    for key, t in sd.items():
        if isinstance(t, tggml.QTensor8):
            assert t.shape == plain[key].shape == tuple(ref[key].shape)
            assert torch.equal(t.q, plain[key].q) and torch.equal(t.scales, plain[key].scales)
            np.testing.assert_array_equal(t.q.numpy(), np.asarray(ref[key].q))
            np.testing.assert_array_equal(t.scales.numpy(), np.asarray(ref[key].scales))
        else:
            assert torch.equal(t, plain[key])


def test_broken_source_raises_without_fallback(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text('extern "C" void ldt_split_q8_0( { }\n')
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load_library(broken)
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ at all
    fresh = tmp_path / "fresh.cpp"
    fresh.write_text(native.SOURCE.read_text() + "\n// another hash\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load_library(fresh)
    with pytest.raises(ValueError):
        native.split_q8_0(torch.zeros((4, 33), dtype=torch.uint8))


def test_library_name_follows_the_toolchain(monkeypatch):
    """A library built by another toolchain (machine, g++ or glibc) has
    another name, so it is rebuilt rather than loaded."""
    here = native.library_path()
    assert native.toolchain() and here == native.library_path()
    monkeypatch.setattr(native, "toolchain", lambda: "aarch64 13.2.0 glibc 2.39")
    assert native.library_path() != here
