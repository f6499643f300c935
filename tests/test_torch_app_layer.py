"""The app layer's host modules against the JAX package: prompt enhancement,
the ``LDT_*`` overrides of ``RuntimeConfig``, profiling, the compile shim,
and the CLI's ``--enhance-prompt`` and ``--no-qkv-fuse``.

The enhancer is held to the JAX function on the same replies from a local
``http.server`` stub on 127.0.0.1 (equal strings); the overrides to the JAX
``RuntimeConfig`` resolved on the CPU under the same environment (equal
values). ``pipeline(enhance_prompt=True)`` runs both packages' enhancer
against the stub and the port's pipeline on a tiny model: the prompt saved
in the PNG is the enhanced one.
"""

import functools
import http.server
import json
import logging
import os
import socket
import threading

import pytest
import torch

from lightdiffusion_next_tpu import config as jconfig
from lightdiffusion_next_tpu.models import unet as junet
from lightdiffusion_next_tpu.models import vae as jvae
from lightdiffusion_next_tpu.models.clip import text_encoder as jte
from lightdiffusion_next_tpu.pipelines import compile as jcompile
from lightdiffusion_next_tpu.pipelines import enhancer as jenh
from lightdiffusion_next_tpu_torch import config as tconfig
from lightdiffusion_next_tpu_torch.app import cli as tcli
from lightdiffusion_next_tpu_torch.models import base as tbase
from lightdiffusion_next_tpu_torch.models import unet as tunet
from lightdiffusion_next_tpu_torch.models import vae as tvae
from lightdiffusion_next_tpu_torch.models.clip import facade as tfacade
from lightdiffusion_next_tpu_torch.ops import cuda_build
from lightdiffusion_next_tpu_torch.pipelines import compile as tcompile
from lightdiffusion_next_tpu_torch.pipelines import enhancer as tenh
from lightdiffusion_next_tpu_torch.pipelines import pipeline as tpipe
from lightdiffusion_next_tpu_torch.pipelines.weights import from_jax
from lightdiffusion_next_tpu_torch.utils import profiling

# --- prompt enhancement ------------------------------------------------------

REPLIES = {
    "plain": (200, {"message": {"content": "a cat, on a mat, soft light"}}),
    "think": (200, {"message": {"content": "<think>plan\nthe\nreply</think>\n  a cat, 8k  "}}),
    "empty": (200, {"message": {"content": "<think>only thoughts</think>  "}}),
    "http_error": (500, {"error": "model not found"}),
    "malformed": (200, {"msg": "no message key"}),
}


@pytest.fixture(scope="module")
def ollama_stub():
    """A stand-in for Ollama's /api/chat on 127.0.0.1: replies by the name
    in the request's model field, and keeps each request's body."""
    requests = []

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
            requests.append((self.path, body))
            status, reply = REPLIES[body["model"]]
            data = json.dumps(reply).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *args):
            pass

    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", requests
    server.shutdown()
    server.server_close()


def _closed_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("reply", sorted(REPLIES))
def test_enhancer_matches_jax(reply, ollama_stub):
    host, requests = ollama_stub
    got = tenh.enhance_prompt("a cat", model=reply, host=host)
    want = jenh.enhance_prompt("a cat", model=reply, host=host)
    assert got == want
    expected = {"plain": "masterpiece, best quality, a cat, on a mat, soft light",
                "think": "masterpiece, best quality, a cat, 8k"}.get(reply, "a cat")
    assert got == expected
    path, body = requests[-1]
    assert path == "/api/chat" and body["stream"] is False
    assert body["messages"] == [{"role": "system", "content": tenh.SYSTEM_PROMPT},
                                {"role": "user", "content": "a cat"}]
    assert tenh.SYSTEM_PROMPT == jenh.SYSTEM_PROMPT
    assert tenh.QUALITY_PREFIX == jenh.QUALITY_PREFIX


def test_enhancer_refused_port_keeps_prompt():
    host = f"http://127.0.0.1:{_closed_port()}"
    assert tenh.enhance_prompt("a dog", host=host, timeout=5) == "a dog"
    assert jenh.enhance_prompt("a dog", host=host, timeout=5) == "a dog"


def _tiny_models():
    tiny = dict(model_channels=32, channel_mult=(1, 2), num_res_blocks=(1, 1),
                transformer_depth=(1, 1), transformer_depth_middle=1, context_dim=64,
                num_heads=2)
    tiny_vae = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
    model = tbase.sd15_model(from_jax(junet.init_params(junet.UNetConfig(**tiny), seed=0)),
                             cfg=tunet.UNetConfig(**tiny), device="cpu")
    vae = tvae.VAE(from_jax(jvae.init_params(jvae.VAEConfig(**tiny_vae), seed=1)),
                   tvae.VAEConfig(**tiny_vae), device="cpu")
    clip = tfacade.sd1_clip_from_params(
        from_jax(jte.init_params(num_layers=2, width=64, heads=4, seed=2)), device="cpu")
    return model, clip, vae


def _png_text(path) -> dict:
    """The tEXt entries of a PNG written by the port."""
    with open(path, "rb") as f:
        data = f.read()
    out, pos = {}, 8
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"tEXt":
            key, _, value = body.partition(b"\x00")
            out[key.decode("latin-1")] = value.decode("latin-1")
        pos += 12 + n
    return out


@pytest.mark.parametrize("reply", ["plain", "http_error"])
def test_pipeline_enhance_prompt(reply, ollama_stub, tmp_path, monkeypatch):
    """``pipeline(enhance_prompt=True)``: the prompt that reaches CLIP and
    the PNG is the JAX enhancer's answer to the same reply (the original
    prompt when the server fails)."""
    host, _ = ollama_stub
    monkeypatch.setenv("LDT_ASSET_ROOT", str(tmp_path))
    monkeypatch.setattr(tenh, "enhance_prompt",
                        functools.partial(tenh.enhance_prompt, model=reply, host=host))
    encoded = []
    real_encode = tfacade.CLIPTextEncode.encode

    def spy(self, clip, text):
        encoded.append(text)
        return real_encode(self, clip, text)

    monkeypatch.setattr(tfacade.CLIPTextEncode, "encode", spy)
    model, clip, vae = _tiny_models()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        paths = tpipe.pipeline("a cat", 64, 64, enhance_prompt=True, prio_speed=True,
                               autohdr=False, enable_multiscale=False, hidiffusion=False,
                               model=model, clip=clip, vae=vae, seed=3,
                               output_dir=str(tmp_path / "out"), device="cpu")
    finally:
        torch.set_num_threads(threads)
    want = jenh.enhance_prompt("a cat", model=reply, host=host)
    assert encoded[0] == want and _png_text(paths[0])["prompt"] == want
    assert (want != "a cat") == (reply == "plain")


def test_cli_enhance_prompt_and_no_qkv_fuse(monkeypatch, tmp_path):
    """``--enhance-prompt`` reaches ``pipeline(enhance_prompt=True)`` and
    ``--no-qkv-fuse`` sets ``RuntimeConfig.qkv_fuse``, as in the JAX CLI."""
    from lightdiffusion_next_tpu.app import cli as jcli

    captured = {}
    monkeypatch.setattr(tpipe, "pipeline",
                        lambda *a, **kw: captured.update(kw) or [str(tmp_path / "x.png")])
    saved = tconfig.get_config()
    try:
        assert tcli.main(["a cat", "64", "64", "--enhance-prompt", "--no-qkv-fuse"],
                         device="cpu") == 0
        assert captured["enhance_prompt"] is True
        assert tconfig.get_config().qkv_fuse is False
        assert not tconfig.get_config().resolve_qkv_fuse()
        tcli.main(["a cat", "64", "64", "--qkv-fuse"], device="cpu")
        assert tconfig.get_config().qkv_fuse is True and captured["enhance_prompt"] is False
    finally:
        tconfig.set_config(saved)
    j = jcli.build_parser().parse_args(["a", "64", "64", "--enhance-prompt", "--no-qkv-fuse"])
    t = tcli.build_parser().parse_args(["a", "64", "64", "--enhance-prompt", "--no-qkv-fuse"])
    assert (t.enhance_prompt, t.no_qkv_fuse) == (j.enhance_prompt, j.no_qkv_fuse) == (True,
                                                                                      True)


# --- the LDT_* overrides -------------------------------------------------------

OVERRIDES = ("LDT_W8A8", "LDT_SAGE_ATTN", "LDT_PACKED_ATTN", "LDT_FLUX_SCAN",
             "LDT_FUSED_ATTN", "LDT_QKV_FUSE", "LDT_FUSED_EW")
FIELDS = ("w8a8", "sage_attention", "packed_attn", "flux_scan", "fused_attn", "qkv_fuse",
          "fused_ew")


@pytest.mark.parametrize("value", ["1", "0", "auto", None])
def test_ldt_overrides_match_jax(value, monkeypatch):
    """Each of the seven variables set to ``value`` (None: unset): the
    fields and every resolve_* on the CPU equal the JAX config's there, and
    the variables are read when a config is made."""
    for name in OVERRIDES:
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    t, j = tconfig.RuntimeConfig(), jconfig.RuntimeConfig()
    for field in FIELDS:
        assert getattr(t, field) == getattr(j, field), field
    for name in ("w8a8", "packed_attn", "flux_scan", "fused_attn", "fused_ew"):
        assert getattr(t, f"resolve_{name}")("cpu") == getattr(j, f"resolve_{name}")(), name
    assert t.resolve_qkv_fuse() == j.resolve_qkv_fuse()
    assert t.sage_attention == j.sage_attention == (value == "1")
    if value in ("1", "0"):  # forced: the same on the GPU
        for name in ("w8a8", "packed_attn", "flux_scan", "fused_attn", "fused_ew"):
            assert getattr(t, f"resolve_{name}")("cuda") == (value == "1")
    else:  # "auto": on for the GPU, as the JAX package's is for the TPU
        for name in ("w8a8", "packed_attn", "flux_scan", "fused_attn", "fused_ew"):
            assert getattr(t, f"resolve_{name}")("cuda") and getattr(t, f"resolve_{name}")()
    monkeypatch.setenv("LDT_W8A8", "1")
    assert tconfig.RuntimeConfig().w8a8 is True and t.w8a8 == j.w8a8


def test_invalid_tri_states_raise():
    for field in ("packed_attn", "qkv_fuse"):
        with pytest.raises(ValueError, match=field):
            tconfig.RuntimeConfig(**{field: "on"})


# --- profiling -------------------------------------------------------------------


def test_timed_trace_and_memory_stats(tmp_path, caplog):
    with caplog.at_level(logging.INFO, logger=profiling.logger.name):
        with profiling.trace(str(tmp_path / "trace")):
            torch.ones(8, 8) @ torch.ones(8, 8)
        with profiling.trace(None):
            pass
    assert any(r.getMessage().startswith("profiler trace written to ") for r in caplog.records)
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as f:
        assert "traceEvents" in json.load(f)
    assert profiling.device_memory_stats() == {}  # no GPU here


def test_compile_log_switches_the_build_log(caplog):
    try:
        profiling.compile_log(True)
        assert cuda_build.logger.isEnabledFor(logging.DEBUG)
        with caplog.at_level(logging.DEBUG):
            cuda_build.logger.debug("kernel library loaded: x")
        assert "kernel library loaded: x" in caplog.text
    finally:
        profiling.compile_log(False)
    assert not cuda_build.logger.isEnabledFor(logging.DEBUG)
    assert cuda_build.logger.handlers == []


# --- the compile shim ------------------------------------------------------------


def test_compile_shim_returns_the_model(monkeypatch):
    """Both nodes return ``(model,)`` as the JAX ones do, build the kernels
    for a model on the GPU, and do nothing on the CPU."""
    builds = []
    monkeypatch.setattr(cuda_build, "build", lambda names=None: builds.append(names))
    model, _, _ = _tiny_models()
    jmodel = object()
    for node, call in ((tcompile.ApplyStableFastUnet(), "apply_stable_fast"),
                       (tcompile.EnhancedCompileModel(), "patch")):
        out = getattr(node, call)(model)
        assert out == (model,) and out[0] is model
        jnode = getattr(jcompile, type(node).__name__)()
        assert getattr(jnode, call)(jmodel)[0] is jmodel
    assert builds == []

    class OnGpu:
        device = torch.device("cuda")

    gpu_model = OnGpu()
    assert tcompile.ApplyStableFastUnet().apply_stable_fast(gpu_model, True) == (gpu_model,)
    assert tcompile.EnhancedCompileModel().patch(gpu_model) == (gpu_model,)
    assert builds == [None, None]
