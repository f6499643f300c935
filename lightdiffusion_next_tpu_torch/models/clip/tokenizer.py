"""CLIP BPE tokenizer and SD prompt syntax.

Counterpart of lightdiffusion_next_tpu/models/clip/tokenizer.py, kept as a
copy of its own (the JAX module imports the JAX package's config):

- ``(text)`` weight x1.1, nested multiplies; ``(text:1.3)`` explicit weight;
- ``\\(`` / ``\\)`` escapes;
- 77-token rows with start/end/pad, long words (>= 8 tokens) spanning rows.

The byte-pair encoder reads the vocabulary vendored in
``assets/tokenizer/clip``. Textual inversion: ``embedding:name`` splices
the named embedding's vectors into the row (``load_embed``); a name that
resolves to no file is skipped with a warning, as the JAX package skips
it.
"""

from __future__ import annotations

import functools
import gzip
import html
import json
import logging
import os
import re
import unicodedata
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from lightdiffusion_next_tpu_torch import config as _config


# ---------------------------------------------------------------------------
# Prompt weight parsing.
#
# Syntax (same surface as SDToken.py:13-103, re-derived): ``(x)`` multiplies
# the ambient weight by 1.1, nesting compounds, and a ``:N`` suffix inside a
# group REPLACES the group's weight with N (inner groups still multiply off
# it). ``\(`` / ``\)`` are literal parentheses. The parse is a single pass
# building a group tree; weights resolve on the way back out.
# ---------------------------------------------------------------------------

# Private-use sentinels standing in for escaped parens during the parse.
_LPAREN_SENTINEL = ""
_RPAREN_SENTINEL = ""


def protect_escaped_parens(text: str) -> str:
    """Hide ``\\(`` / ``\\)`` from the group parser."""
    return text.replace("\\(", _LPAREN_SENTINEL).replace(
        "\\)", _RPAREN_SENTINEL
    )


def restore_escaped_parens(text: str) -> str:
    return text.replace(_LPAREN_SENTINEL, "(").replace(_RPAREN_SENTINEL, ")")


class _WeightGroup:
    """One parenthesized group: an ordered mix of text runs and subgroups."""

    __slots__ = ("parts", "closed")

    def __init__(self):
        self.parts: List = []
        self.closed = False

    def add_text(self, s: str) -> None:
        if s:
            self.parts.append(s)


def _build_group_tree(text: str) -> _WeightGroup:
    """Parse into a group tree. Unbalanced input degrades like the
    reference: an unclosed ``(`` group is flattened back into literal text
    (including its paren), and a stray ``)`` at depth 0 is literal."""
    root = _WeightGroup()
    root.closed = True
    stack = [root]
    run: List[str] = []

    def flush():
        stack[-1].add_text("".join(run))
        run.clear()

    for ch in text:
        if ch == "(":
            flush()
            child = _WeightGroup()
            stack[-1].parts.append(child)
            stack.append(child)
        elif ch == ")" and len(stack) > 1:
            flush()
            stack[-1].closed = True
            stack.pop()
        else:
            run.append(ch)
    flush()
    return root


def _flatten_literal(group: _WeightGroup) -> str:
    """Render an unclosed group back to its source text."""
    out = "("
    for p in group.parts:
        out += p if isinstance(p, str) else _render_group(p)
    return out


def _render_group(group: _WeightGroup) -> str:
    inner = "".join(
        p if isinstance(p, str) else _render_group(p) for p in group.parts
    )
    return "(" + inner + ")" if group.closed else "(" + inner


def _explicit_weight(group: _WeightGroup) -> Optional[Tuple[float, str]]:
    """``:N`` suffix detection. The reference scans the group's full inner
    text for its LAST colon and float()s everything after it; any nested
    group after the colon makes that text unparseable, so equivalently: the
    suffix must live in the group's final text run."""
    if not group.parts or not isinstance(group.parts[-1], str):
        return None
    tail = group.parts[-1]
    cut = tail.rfind(":")
    if cut < 0:
        return None
    if len(group.parts) == 1 and cut == 0:
        return None  # ":N" alone is not a weight suffix
    try:
        return float(tail[cut + 1 :]), tail[:cut]
    except ValueError:
        return None


def _emit_weighted(group: _WeightGroup, weight: float, out: List) -> None:
    for part in group.parts:
        if isinstance(part, str):
            out.append((part, weight))
        elif not part.closed:
            # unclosed group: literal text at the AMBIENT weight
            out.append((_flatten_literal(part), weight))
        else:
            sub_weight = weight * 1.1
            sub = part
            explicit = _explicit_weight(part)
            if explicit is not None:
                sub_weight, kept_tail = explicit
                sub = _WeightGroup()
                sub.parts = part.parts[:-1]
                sub.add_text(kept_tail)
                sub.closed = True
            _emit_weighted(sub, sub_weight, out)


def parse_prompt_weights(text: str, base_weight: float = 1.0) -> List[Tuple[str, float]]:
    """Prompt -> ordered [(text_run, weight)] (token_weights-equivalent
    surface, SDToken.py:50-77)."""
    out: List[Tuple[str, float]] = []
    _emit_weighted(_build_group_tree(text), base_weight, out)
    return out


# ---------------------------------------------------------------------------
# Byte-pair encoding (OpenAI CLIP tokenizer algorithm)
# ---------------------------------------------------------------------------


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")


def _char_kind(ch: str) -> str:
    """"L" letter, "N" number (Unicode categories), " " space, "P" other."""
    if ch.isspace():
        return " "
    cat = unicodedata.category(ch)[0]
    return cat if cat in ("L", "N") else "P"


def split_words(text: str) -> List[str]:
    """CLIP's word split: the matches of
    ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
    in order, written as a scanner over Unicode categories because the
    standard library's ``re`` has no ``\\p`` classes (the ``regex`` module
    is not installed everywhere the port runs)."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        head = next((t for t in _SPECIALS + _CONTRACTIONS if text.startswith(t, i)), None)
        if head is not None:
            out.append(head)
            i += len(head)
            continue
        kind = _char_kind(text[i])
        if kind == " ":
            i += 1
            continue
        j = i + 1
        if kind != "N":  # numbers are single characters, the rest runs
            while j < n and _char_kind(text[j]) == kind:
                j += 1
        out.append(text[i:j])
        i = j
    return out


class ClipBPE:
    """CLIP byte-pair encoder over the vendored vocab.json/merges.txt."""

    def __init__(self, vocab_path: Optional[str] = None, merges_path: Optional[str] = None):
        vocab_path = vocab_path or _config.repo_asset("tokenizer", "clip", "vocab.json")
        merges_path = merges_path or _config.repo_asset(
            "tokenizer", "clip", "merges.txt"
        )
        opener = gzip.open if vocab_path.endswith(".gz") else open
        with opener(vocab_path, "rt", encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(merges_path, encoding="utf-8") as f:
            merges = f.read().split("\n")
        # first line is the version header
        merges = [tuple(m.split()) for m in merges[1:] if m and len(m.split()) == 2]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.cache: Dict[str, str] = {}
        self.start_token = self.encoder["<|startoftext|>"]
        self.end_token = self.encoder["<|endoftext|>"]

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (
                    word[i] == first
                    and i < len(word) - 1
                    and word[i + 1] == second
                ):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        result = " ".join(word)
        self.cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        """Text -> BPE ids (no special tokens)."""
        text = _whitespace_clean(text).lower()
        bpe_tokens: List[int] = []
        for token in split_words(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self._bpe(token).split(" ")
            )
        return bpe_tokens


def _whitespace_clean(text: str) -> str:
    text = re.sub(r"\s+", " ", html.unescape(html.unescape(text)))
    return text.strip()


def load_embed(embedding_name: str, embedding_directories,
               embedding_size: int, embed_key: Optional[str] = None) -> Optional[np.ndarray]:
    """The textual-inversion vectors ``embedding_name`` resolves to, as an
    (n, embedding_size) f32 array, or None. Searched in the directories and
    their subdirectories, the name as given or with .safetensors, .pt or
    .bin; a name that escapes its directory is skipped. ``.safetensors``
    through the port's reader; ``.pt``/``.bin`` through ``torch.load`` (A1111
    files pickle more than tensors, so not weights-only, as in the JAX
    package)."""
    if not embedding_directories:
        return None
    if isinstance(embedding_directories, str):
        embedding_directories = [embedding_directories]
    expanded: List[str] = []
    seen = set()
    for d in embedding_directories:
        for root in [d] + [r for r, _, _ in os.walk(d, followlinks=True)]:
            if root not in seen:
                seen.add(root)
                expanded.append(root)
    valid_file = None
    for embed_dir in expanded:
        embed_path = os.path.abspath(os.path.join(embed_dir, embedding_name))
        embed_dir_abs = os.path.abspath(embed_dir)
        try:
            if os.path.commonpath((embed_dir_abs, embed_path)) != embed_dir_abs:
                continue
        except ValueError:
            continue
        if not os.path.isfile(embed_path):
            for ext in (".safetensors", ".pt", ".bin"):
                if os.path.isfile(embed_path + ext):
                    valid_file = embed_path + ext
                    break
        else:
            valid_file = embed_path
        if valid_file is not None:
            break
    if valid_file is None:
        return None

    if valid_file.endswith(".safetensors"):
        from lightdiffusion_next_tpu_torch.utils import state_dict as sd_utils

        embed = sd_utils.read_safetensors(valid_file)
    else:
        data = torch.load(valid_file, map_location="cpu", weights_only=False)
        embed = _flatten_embed_dict(data)
    embed = {k: (v.float().numpy() if isinstance(v, torch.Tensor) else v)
             for k, v in embed.items()}

    values = list(embed.values())
    if embed_key is not None and embed_key in embed:
        out = embed[embed_key]
    elif len(values) == 1:
        out = values[0]
    else:
        out = next((np.asarray(v) for v in values
                    if np.asarray(v).ndim and np.asarray(v).shape[-1] == embedding_size),
                   values[0])
    out = np.asarray(out, dtype=np.float32)
    if out.ndim == 1:
        out = out[None]
    if out.shape[-1] != embedding_size:
        return None
    return out


def _flatten_embed_dict(data):
    """A1111 .pt embeddings nest their tensors under "string_to_param"."""
    if isinstance(data, dict):
        if "string_to_param" in data:
            return dict(data["string_to_param"].items())
        if "emb_params" in data:
            return {"emb_params": data["emb_params"]}
        return {k: v for k, v in data.items() if hasattr(v, "shape")}
    return {"embed": data}


# ---------------------------------------------------------------------------
# SD tokenizer facade
# ---------------------------------------------------------------------------


class SDTokenizer:
    """Weighted tokenizer with textual inversion: an ``embedding:name`` word
    becomes that embedding's vectors, one (f32 numpy vector, weight) entry
    per vector, in place of BPE ids."""

    def __init__(
        self,
        max_length: int = 77,
        pad_with_end: bool = True,
        embedding_directory=None,
        embedding_size: int = 768,
        embedding_key: str = "clip_l",
        has_start_token: bool = True,
        pad_to_max_length: bool = True,
        min_length: Optional[int] = None,
        bpe: Optional[ClipBPE] = None,
    ):
        self.bpe = bpe or ClipBPE()
        self.max_length = max_length
        self.min_length = min_length
        self.start_token = self.bpe.start_token if has_start_token else None
        self.end_token = self.bpe.end_token
        self.pad_with_end = pad_with_end
        self.pad_to_max_length = pad_to_max_length
        self.embedding_directory = embedding_directory
        self.max_word_length = 8
        self.embedding_identifier = "embedding:"
        self.embedding_size = embedding_size
        self.embedding_key = embedding_key

    def _lookup_embedding(self, name: str):
        """(vectors, suffix) for a textual-inversion name. A name with
        trailing commas glued to it ("embedding:foo,") that misses is
        retried without them, and the commas come back as the suffix to
        tokenize normally."""
        hit = load_embed(name, self.embedding_directory, self.embedding_size,
                         self.embedding_key)
        if hit is not None:
            return hit, ""
        bare = name.rstrip(",")
        if bare != name:
            hit = load_embed(bare, self.embedding_directory, self.embedding_size,
                             self.embedding_key)
            if hit is not None:
                return hit, name[len(bare):]
        return None, ""

    def _word_groups(self, text: str) -> List[List[Tuple]]:
        """Prompt -> per-word token groups [[(token or vector, weight)]].
        Words split on spaces within each weighted run."""
        groups: List[List[Tuple]] = []
        for run, weight in parse_prompt_weights(protect_escaped_parens(text)):
            run = restore_escaped_parens(run).replace("\n", " ")
            for word in filter(None, run.split(" ")):
                if (
                    self.embedding_directory is not None
                    and word.startswith(self.embedding_identifier)
                ):
                    name = word[len(self.embedding_identifier):].strip("\n")
                    embed, suffix = self._lookup_embedding(name)
                    if embed is None:
                        logging.warning(
                            "warning, embedding:%s does not exist, ignoring", name
                        )
                        continue
                    groups.append([(row, weight) for row in embed])
                    if not suffix:
                        continue
                    word = suffix
                groups.append([(t, weight) for t in self.bpe.encode(word)])
        return groups

    def tokenize_with_weights(self, text: str, return_word_ids: bool = False):
        """Tokenize and pack into max_length rows: every row is [start] ...
        [end] (+pad); a word group that does not fit moves wholesale to the
        next row, unless it has >= max_word_length tokens, in which case it
        fills the remainder and continues on the next row. Entries are
        (token, weight, word_id) with word_id 0 for specials."""
        pad_token = self.end_token if self.pad_with_end else 0
        groups = self._word_groups(text)

        body_room = self.max_length - 1  # one slot always reserved for <end>
        rows: List[List[Tuple]] = []

        def new_row() -> List[Tuple]:
            r = [(self.start_token, 1.0, 0)] if self.start_token is not None else []
            rows.append(r)
            return r

        row = new_row()
        for word_id, group in enumerate(groups, start=1):
            pending = [(t, w, word_id) for t, w in group]
            spans_rows = len(pending) >= self.max_word_length
            while pending:
                space = body_room - len(row)
                if len(pending) <= space:
                    row += pending
                    break
                if spans_rows:
                    row += pending[:space]
                    pending = pending[space:]
                    row.append((self.end_token, 1.0, 0))
                else:
                    row.append((self.end_token, 1.0, 0))
                    if self.pad_to_max_length:
                        row += [(pad_token, 1.0, 0)] * space
                row = new_row()

        row.append((self.end_token, 1.0, 0))
        fill = 0
        if self.pad_to_max_length:
            fill = self.max_length - len(row)
        if self.min_length is not None:
            fill = max(fill, self.min_length - len(row))
        row += [(pad_token, 1.0, 0)] * fill

        if return_word_ids:
            return rows
        return [[(t, w) for t, w, _ in r] for r in rows]


class SD1Tokenizer:
    """Keyed wrapper ({"l": rows})."""

    def __init__(self, embedding_directory=None, clip_name: str = "l", **kwargs):
        self.clip_name = clip_name
        self.clip = f"clip_{clip_name}"
        setattr(self, self.clip,
                SDTokenizer(embedding_directory=embedding_directory, **kwargs))

    def tokenize_with_weights(self, text: str, return_word_ids: bool = False):
        return {
            self.clip_name: getattr(self, self.clip).tokenize_with_weights(
                text, return_word_ids
            )
        }
