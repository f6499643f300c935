"""Write ``benchmark/prompts.json``: the benchmark's prompts with the token
rows the plain reference encodes, made by tokenizers independent of the
program.

Run from the repository root on a machine with ``transformers`` and
``tokenizers`` (the GPU machine has neither; the file is committed):

    python3 benchmark/tools/make_prompts.py

CLIP-L: Hugging Face's ``CLIPTokenizer`` over the vocabulary vendored in
``assets/tokenizer/clip``, word by word, after SD's prompt-weight syntax is
resolved here: ``(text)`` multiplies the weight by 1.1, ``(text:w)`` sets
it to w, nesting compounds. A row is [start] tokens [end], padded with the
end token to 77. T5: the ``tokenizers`` model in ``assets/tokenizer/t5``,
its ids, one ``</s>``, zero padding to 256, as the Flux flow encodes them.
Every prompt must fit one row of each.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROMPTS = [
    "a photograph of an astronaut riding a horse on the moon",
    "a cozy cabin in a snowy pine forest at dusk, warm light in the windows",
    "portrait of an old fisherman with a grey beard, dramatic lighting",
    "a red fox sleeping in autumn leaves, shallow depth of field",
    "a futuristic city skyline at night with flying cars and neon signs",
    "a bowl of ramen with a soft boiled egg on a wooden table",
    "an ancient stone bridge over a misty river in the mountains",
    "a watercolor painting of a lighthouse on a rocky coast",
    "a cat wearing a tiny wizard hat reading a spell book",
    "a field of sunflowers under a stormy sky",
    "a steampunk airship above the clouds at sunrise",
    "a close up of a hummingbird drinking from a purple flower",
    "an astronaut floating inside a space station full of plants",
    "a medieval market square crowded with merchants and horses",
    "a glass of iced coffee on a cafe terrace in paris",
    "a dragon perched on a castle tower breathing fire",
    "a quiet japanese garden with a koi pond and a red bridge",
    "a vintage car parked on a desert highway at golden hour",
    "an underwater coral reef with colorful fish and sunbeams",
    "a snowy owl flying over a frozen lake",
    "a bustling street food stall at a night market in taipei",
    "a knight in shining armor standing in a field of poppies",
    "a small robot watering plants in a greenhouse",
    "a hot air balloon festival over green rolling hills",
]

# pipeline()'s default negative prompt (pipelines/pipeline.py DEFAULT_NEGATIVE)
DEFAULT_NEGATIVE = (
    "(worst quality, low quality:1.4), (zombie, sketch, interlocked fingers, "
    "comic), (embedding:EasyNegative), (embedding:badhandv4), (embedding:lr), "
    "(embedding:ng_deepnegative_v1_75t)"
)


def weighted_runs(text: str, weight: float = 1.0):
    """[(text, weight)] of SD's prompt syntax (no escapes in these prompts)."""
    out, i, run = [], 0, ""
    while i < len(text):
        ch = text[i]
        if ch == "(":
            depth, j = 1, i + 1
            while depth:
                depth += {"(": 1, ")": -1}.get(text[j], 0)
                j += 1
            if run:
                out.append((run, weight))
                run = ""
            inner = text[i + 1:j - 1]
            head, colon, tail = inner.rpartition(":")
            try:
                w, inner = float(tail), head
                if not colon:
                    raise ValueError
            except ValueError:
                w = weight * 1.1
            out += weighted_runs(inner, w)
            i = j
            continue
        run += ch
        i += 1
    if run:
        out.append((run, weight))
    return out


def clip_row(tok, text: str):
    ids, weights = [49406], [1.0]
    for run, w in weighted_runs(text):
        for word in filter(None, run.replace("\n", " ").split(" ")):
            for t in tok.encode(word, add_special_tokens=False):
                ids.append(t)
                weights.append(w)
    ids.append(49407)
    weights.append(1.0)
    if len(ids) > 77:
        raise ValueError(f"prompt longer than one CLIP row: {text!r}")
    return ids + [49407] * (77 - len(ids)), weights + [1.0] * (77 - len(weights))


def t5_row(tok, text: str):
    ids = tok.encode(text).ids
    if ids and ids[-1] == 1:
        ids = ids[:-1]
    ids = ids + [1]
    if len(ids) > 256:
        raise ValueError(f"prompt longer than 256 T5 tokens: {text!r}")
    return ids + [0] * (256 - len(ids))


def main() -> int:
    from tokenizers import Tokenizer
    from transformers import CLIPTokenizer

    clip = CLIPTokenizer(os.path.join(ROOT, "assets/tokenizer/clip/vocab.json"),
                         os.path.join(ROOT, "assets/tokenizer/clip/merges.txt"))
    t5 = Tokenizer.from_file(os.path.join(ROOT, "assets/tokenizer/t5/tokenizer.json"))
    entries = []
    for text in PROMPTS:
        ids, weights = clip_row(clip, text)
        entries.append({"text": text, "clip": [ids], "clip_weights": [weights],
                        "t5": [t5_row(t5, text)]})
    ids, weights = clip_row(clip, DEFAULT_NEGATIVE)
    negative = {"text": DEFAULT_NEGATIVE, "clip": [ids], "clip_weights": [weights]}
    path = os.path.join(ROOT, "benchmark", "prompts.json")
    with open(path, "w") as f:
        json.dump({"prompts": entries, "default_negative": negative}, f, separators=(",", ":"))
        f.write("\n")
    print(f"wrote {len(entries)} prompts to {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
