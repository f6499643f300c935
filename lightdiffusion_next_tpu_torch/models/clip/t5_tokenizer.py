"""T5 tokenizer for the Flux path, in the standard library and numpy.

Counterpart of ``flux_t5_tokenize`` and ``_t5_encode_ids`` of
lightdiffusion_next_tpu/pipelines/pipeline.py, which call the ``tokenizers``
package on the vendored ``assets/tokenizer/t5/tokenizer.json``. This module
implements the pipeline that file declares, so the port needs no tokenizer
package:

1. added tokens (``<pad>``, ``</s>``, ``<unk>``, ``<extra_id_N>``) are split
   out of the raw text first, leftmost-longest;
2. each other piece is normalized: the ``Precompiled`` normalizer
   (sentencepiece's charsmap: a Darts double-array trie over UTF-8 bytes
   plus a blob of NUL-terminated replacement strings, applied per grapheme
   cluster as sentencepiece and ``tokenizers`` apply it), then ``Strip``
   on the right, then ``Replace`` of every run of two or more spaces with
   one "▁";
3. ``Metaspace``: spaces become "▁", a "▁" is prepended to the piece that
   starts the text (``prepend_scheme: first``), and the piece is split
   before every "▁";
4. Unigram: Viterbi over the scored pieces, an unknown character costs the
   lowest score minus 10 and maps to unk id 2, consecutive unknowns fuse;
5. ``</s>`` (id 1) is appended; ``flux_t5_tokenize`` pads with id 0 to 256.

Grapheme clusters are found by the rules of UAX #29 that matter here
(combining marks, ZWJ, variation selectors, emoji modifiers, regional
indicator pairs, Hangul syllables, CR LF); the normalizer only treats a
cluster as one unit when it is shorter than 6 bytes.
"""

from __future__ import annotations

import base64
import functools
import json
import re
import struct
import unicodedata
from typing import Dict, List, Optional, Tuple

from lightdiffusion_next_tpu_torch import config as _config

META = "▁"  # "▁"
UNK_PENALTY = 10.0


class Precompiled:
    """sentencepiece's precompiled charsmap normalizer."""

    def __init__(self, blob: bytes):
        (trie_size,) = struct.unpack_from("<I", blob, 0)
        trie = blob[4:4 + trie_size]
        self.array = struct.unpack("<%dI" % (trie_size // 4), trie)
        self.normalized = blob[4 + trie_size:]

    def _prefix_values(self, key: bytes) -> List[int]:
        """Darts-clone common prefix search: the values of every key that
        is a prefix of ``key``, shortest first."""
        array = self.array
        unit = array[0]
        node = (unit >> 10) << ((unit & (1 << 9)) >> 6)
        out = []
        for c in key:
            if c == 0:
                break
            node ^= c
            unit = array[node]
            if (unit & ((1 << 31) | 0xFF)) != c:
                return out
            node ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                out.append(array[node] & ((1 << 31) - 1))
        return out

    def transform(self, chunk: str) -> Optional[str]:
        values = self._prefix_values(chunk.encode("utf-8"))
        if not values:
            return None
        start = values[0]
        end = self.normalized.index(b"\0", start)
        return self.normalized[start:end].decode("utf-8")

    def normalize(self, text: str) -> str:
        out = []
        for cluster in graphemes(text):
            if len(cluster.encode("utf-8")) < 6:
                norm = self.transform(cluster)
                if norm is not None:
                    out.append(norm)
                    continue
            for ch in cluster:
                norm = self.transform(ch)
                out.append(ch if norm is None else norm)
        return "".join(out)


# --- grapheme clusters -----------------------------------------------------

_PICTO = (
    (0x00A9, 0x00A9), (0x00AE, 0x00AE), (0x203C, 0x203C), (0x2049, 0x2049),
    (0x2122, 0x2122), (0x2139, 0x2139), (0x2194, 0x21AA), (0x231A, 0x23FF),
    (0x24C2, 0x24C2), (0x25AA, 0x25FE), (0x2600, 0x27BF), (0x2934, 0x2935),
    (0x2B05, 0x2B55), (0x3030, 0x3030), (0x303D, 0x303D), (0x3297, 0x3299),
    (0x1F000, 0x1FAFF), (0x1FC00, 0x1FFFD),
)


def _kind(ch: str) -> str:
    cp = ord(ch)
    if ch == "\r":
        return "CR"
    if ch == "\n":
        return "LF"
    if ch == "‍":
        return "ZWJ"
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return "RI"
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    cat = unicodedata.category(ch)
    if (cat in ("Mn", "Me") or cp == 0x200C or 0x1F3FB <= cp <= 0x1F3FF
            or 0xE0020 <= cp <= 0xE007F or cp in (0xFF9E, 0xFF9F)):
        return "Extend"
    if cat == "Mc":
        return "SpacingMark"
    if cat in ("Cc", "Zl", "Zp") or (cat == "Cf" and cp != 0x200C):
        return "Control"
    if any(lo <= cp <= hi for lo, hi in _PICTO):
        return "Pict"
    return "Other"


def _joins(prev: str, cur: str, pict_zwj: bool, ri_odd: bool) -> bool:
    if prev == "CR" and cur == "LF":
        return True
    if prev in ("Control", "CR", "LF") or cur in ("Control", "CR", "LF"):
        return False
    if prev == "L" and cur in ("L", "V", "LV", "LVT"):
        return True
    if prev in ("LV", "V") and cur in ("V", "T"):
        return True
    if prev in ("LVT", "T") and cur == "T":
        return True
    if cur in ("Extend", "ZWJ", "SpacingMark"):
        return True
    if prev == "ZWJ" and cur == "Pict" and pict_zwj:
        return True
    if prev == "RI" and cur == "RI":
        return ri_odd
    return False


def graphemes(text: str) -> List[str]:
    """Extended grapheme clusters (the UAX #29 rules listed above)."""
    out: List[str] = []
    prev = None
    pict_seq = False  # inside Pict Extend* (ZWJ)?
    pict_zwj = False  # the previous char is a ZWJ ending a Pict Extend* run
    ri_count = 0
    for ch in text:
        cur = _kind(ch)
        if prev is not None and _joins(prev, cur, pict_zwj, ri_count % 2 == 1):
            out[-1] += ch
        else:
            out.append(ch)
        pict_zwj = cur == "ZWJ" and pict_seq
        pict_seq = cur == "Pict" or (pict_seq and cur == "Extend")
        ri_count = ri_count + 1 if cur == "RI" else 0
        prev = cur
    return out


# --- the tokenizer ---------------------------------------------------------


class T5Tokenizer:
    """``encode(text)`` -> ids as ``tokenizers.Tokenizer.from_file(path)
    .encode(text).ids`` gives them for the vendored T5 tokenizer.json."""

    def __init__(self, path: Optional[str] = None):
        path = path or _config.repo_asset("tokenizer", "t5", "tokenizer.json")
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        norms = spec["normalizer"]["normalizers"]
        kinds = [n["type"] for n in norms]
        if kinds != ["Precompiled", "Strip", "Replace"]:
            raise ValueError(f"unexpected T5 normalizer sequence {kinds}")
        self.precompiled = Precompiled(base64.b64decode(norms[0]["precompiled_charsmap"]))
        self.strip_left = norms[1]["strip_left"]
        self.strip_right = norms[1]["strip_right"]
        self.replace_re = re.compile(norms[2]["pattern"]["Regex"])
        self.replace_with = norms[2]["content"]
        model = spec["model"]
        if model["type"] != "Unigram":
            raise ValueError(f"unexpected T5 model {model['type']}")
        self.unk_id = model["unk_id"]
        self.vocab: Dict[str, Tuple[int, float]] = {}
        for i, (piece, score) in enumerate(model["vocab"]):
            self.vocab.setdefault(piece, (i, float(score)))
        self.max_piece = max(len(p) for p in self.vocab)
        self.unk_score = min(s for _, s in model["vocab"]) - UNK_PENALTY
        added = [t["content"] for t in spec["added_tokens"]]
        self.added = {t["content"]: t["id"] for t in spec["added_tokens"]}
        self.added_re = re.compile(
            "|".join(re.escape(t) for t in sorted(added, key=len, reverse=True)))
        pre = spec["pre_tokenizer"]
        self.prepend_first = pre.get("prepend_scheme") == "first"
        self.eos_id = self.added["</s>"]

    def _normalize(self, text: str) -> str:
        text = self.precompiled.normalize(text)
        if self.strip_right:
            text = text.rstrip()
        if self.strip_left:
            text = text.lstrip()
        return self.replace_re.sub(self.replace_with, text)

    def _viterbi(self, piece: str) -> List[int]:
        n = len(piece)
        best = [None] * (n + 1)  # (score, start, id)
        best[0] = (0.0, -1, -1)
        for i in range(n):
            if best[i] is None:
                continue
            base = best[i][0]
            single = False
            for j in range(i + 1, min(n, i + self.max_piece) + 1):
                hit = self.vocab.get(piece[i:j])
                if hit is None:
                    continue
                score = base + hit[1]
                if best[j] is None or score > best[j][0]:
                    best[j] = (score, i, hit[0])
                single = single or j == i + 1
            if not single:
                score = base + self.unk_score
                if best[i + 1] is None or score > best[i + 1][0]:
                    best[i + 1] = (score, i, self.unk_id)
        ids: List[int] = []
        end = n
        while end > 0:
            _, start, tid = best[end]
            if tid == self.unk_id and ids and ids[-1] == self.unk_id:
                pass  # consecutive unknowns fuse into one
            else:
                ids.append(tid)
            end = start
        return ids[::-1]

    def _encode_piece(self, text: str, first: bool) -> List[int]:
        text = self._normalize(text).replace(" ", META)
        if not text:
            return []
        if self.prepend_first and first and not text.startswith(META):
            text = META + text
        ids: List[int] = []
        for word in re.split("(?=" + META + ")", text):
            if word:
                ids += self._viterbi(word)
        return ids

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        pos = 0
        for m in self.added_re.finditer(text):
            if m.start() > pos:
                ids += self._encode_piece(text[pos:m.start()], first=pos == 0)
            ids.append(self.added[m.group(0)])
            pos = m.end()
        if pos < len(text):
            ids += self._encode_piece(text[pos:], first=pos == 0)
        return ids + [self.eos_id]


@functools.lru_cache(maxsize=1)
def default_tokenizer() -> T5Tokenizer:
    return T5Tokenizer()


def flux_t5_tokenize(text: str, min_length: int = 256):
    """(token, weight) rows for T5: the ids, ``</s>`` once at the end, zero
    padding to ``min_length``, no maximum."""
    ids = default_tokenizer().encode(text)
    if ids and ids[-1] == 1:
        ids = ids[:-1]
    row = [(t, 1.0) for t in ids + [1]]
    return row + [(0, 1.0)] * (min_length - len(row))
