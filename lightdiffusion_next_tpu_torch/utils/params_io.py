"""The parameter file: the last prompt, negative prompt, size and CFG,
under the asset root as ``prompt.txt``.

Counterpart of lightdiffusion_next_tpu/utils/params_io.py: one
``key: value`` line per key (newlines inside the prompts flattened to
spaces); the reader also takes the legacy single-line form
("prompt: Xneg: Yw: 512h: 512cfg: 7") by slicing between the keys in
their write order.
"""

from __future__ import annotations

import os
from typing import Tuple

from lightdiffusion_next_tpu_torch import config as _config

_KEYS = ("prompt", "neg", "w", "h", "cfg")


def _params_file() -> str:
    return os.path.join(_config.asset_root(), "prompt.txt")


def _flat(text: str) -> str:
    return " ".join(str(text).splitlines())


def write_parameters_to_file(prompt_entry: str, neg: str, width: int, height: int,
                             cfg: int) -> None:
    os.makedirs(os.path.dirname(_params_file()), exist_ok=True)
    with open(_params_file(), "w") as f:
        f.write(f"prompt: {_flat(prompt_entry)}\n")
        f.write(f"neg: {_flat(neg)}\n")
        f.write(f"w: {int(width)}\n")
        f.write(f"h: {int(height)}\n")
        f.write(f"cfg: {int(cfg)}\n")


def _scan_legacy(text: str) -> dict:
    out = {}
    marks = []
    pos = 0
    for key in _KEYS:
        token = f"{key}: "
        i = text.find(token, pos)
        if i < 0:
            continue
        marks.append((key, i, i + len(token)))
        pos = i + len(token)
    for n, (key, _start, vstart) in enumerate(marks):
        vend = marks[n + 1][1] if n + 1 < len(marks) else len(text)
        out[key] = text[vstart:vend].strip()
    return out


def load_parameters_from_file() -> Tuple[str, str, int, int, int]:
    with open(_params_file()) as f:
        text = f.read()
    parameters = {}
    for line in text.splitlines():
        key, sep, value = line.partition(": ")
        if line.strip() and sep:
            parameters[key.strip()] = value.strip()
    if not all(k in parameters for k in _KEYS):
        parameters = _scan_legacy(text)
    return (parameters["prompt"], parameters["neg"], int(parameters["w"]),
            int(parameters["h"]), int(parameters["cfg"]))
