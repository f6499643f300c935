"""Prompt enhancement through a local Ollama.

Counterpart of lightdiffusion_next_tpu/pipelines/enhancer.py: one chat
request to Ollama's ``/api/chat`` over raw HTTP (no ``ollama`` package),
the reply's ``<think>`` blocks stripped, ``QUALITY_PREFIX`` put before it;
the original prompt on any failure (no server, an HTTP error, a malformed
or empty reply), as in the JAX package and the reference. Host only.
"""

from __future__ import annotations

import json
import logging
import re
import urllib.request

logger = logging.getLogger(__name__)

SYSTEM_PROMPT = (
    "You are a prompt maker for Stable Diffusion. Expand the user's idea "
    "into a single detailed, comma-separated prompt describing subject, "
    "environment, lighting, style and quality tags. Reply with the prompt "
    "only."
)

QUALITY_PREFIX = "masterpiece, best quality, "


def enhance_prompt(prompt: str, model: str = "deepseek-r1",
                   host: str = "http://127.0.0.1:11434", timeout: float = 30.0) -> str:
    """The enhanced prompt, or ``prompt`` itself on any failure."""
    body = {"model": model, "stream": False,
            "messages": [{"role": "system", "content": SYSTEM_PROMPT},
                         {"role": "user", "content": prompt}]}
    try:
        req = urllib.request.Request(f"{host}/api/chat", data=json.dumps(body).encode("utf-8"),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            text = json.loads(resp.read().decode("utf-8"))["message"]["content"]
        text = re.sub(r"<think>.*?</think>", "", text, flags=re.DOTALL).strip()
    except Exception as e:  # no server, an HTTP error, a reply without the message
        logger.warning("prompt enhancement failed (%s); keeping the prompt", e)
        return prompt
    return QUALITY_PREFIX + text if text else prompt
