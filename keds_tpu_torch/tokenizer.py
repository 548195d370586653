"""CLIP byte-level BPE tokenizer and the token-id logic of the text paths
(counterpart of ``keds_tpu/tokenizer.py``, a copy of it, not an import).

The ids equal the JAX package's tokenizer's: 49408-entry vocab,
``<|startoftext|>``/``<|endoftext|>`` = 49406/49407, context length 77,
zero padding, truncation with a forced EOT.  The merges file
(``bpe_simple_vocab_16e6.txt.gz``) is not bundled: :func:`find_vocab_file`
takes an explicit path, else ``KEDS_TPU_BPE_VOCAB``, else the usual cache
locations.  The image stream needs no vocab (its prompt and ``*`` id are
arguments); the text stream tokenizes its templates and needs the file.

Two differences of means, none of result:

* No ``regex`` module: the JAX package's pretokenizer is a ``regex``
  pattern over ``\\p{L}`` and ``\\p{N}``, which stdlib ``re`` lacks (and its
  ``\\w``/``\\d`` are other classes: ``\\w`` takes "²", "½" and "Ⅻ" as word
  characters, ``\\d`` misses them where ``\\p{N}`` takes them).
  :func:`pretokenize` is a scanner over ``unicodedata.category`` that gives
  the pattern's pieces, quirks included: the pattern is case-insensitive,
  so ``'ſ`` is the contraction ``'s``, and U+0345 matches none of its
  alternatives and is dropped.  Code points that Unicode assigned after the
  version of Python's ``unicodedata`` may be classed differently by the
  two.
* No ``ftfy``: text is cleaned as the JAX package cleans it without
  ``ftfy`` (NFC, HTML unescape twice, whitespace runs to one space), and
  its optional native BPE core is left out (the Python merge loop gives
  the same ids).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
import unicodedata
from typing import Iterable, List, Sequence, Union

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
SOT_TOKEN = 49406
EOT_TOKEN = 49407

_VOCAB_BASENAME = "bpe_simple_vocab_16e6.txt.gz"
_VOCAB_SEARCH_PATHS = (
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets", _VOCAB_BASENAME),
    os.path.expanduser(os.path.join("~", ".cache", "clip", _VOCAB_BASENAME)),
    os.path.expanduser(os.path.join("~", ".cache", "keds_tpu", _VOCAB_BASENAME)),
)

# Unicode's White_Space property: the ``regex`` module's ``\s`` (str.isspace
# also takes U+001C-U+001F, which ``\s`` does not)
_WHITESPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004"
                        "\u2005\u2006\u2007\u2008\u2009\u200a\u2028\u2029\u202f"
                        "\u205f\u3000")
_WHITESPACE_RUN = re.compile("[" + "".join(sorted(_WHITESPACE)) + "]+")
_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
_FOLD = {"\u017f": "s"}        # case-insensitive matching takes long s for s
_UNMATCHED = frozenset("\u0345")   # in no class of the case-insensitive pattern


def find_vocab_file(path: str | None = None) -> str:
    """The CLIP BPE merges file: ``path`` if given (it must exist), else
    ``KEDS_TPU_BPE_VOCAB``, else the cache locations.  Raises
    FileNotFoundError when there is none."""
    if path:
        if os.path.isfile(path):
            return path
        raise FileNotFoundError(f"BPE vocab not found at explicit path: {path}")
    env = os.environ.get("KEDS_TPU_BPE_VOCAB")
    for c in ((env,) if env else ()) + _VOCAB_SEARCH_PATHS:
        if os.path.isfile(c):
            return c
    raise FileNotFoundError(
        "CLIP BPE vocab (bpe_simple_vocab_16e6.txt.gz) not found. Provide it via "
        "KEDS_TPU_BPE_VOCAB, an explicit path, or ~/.cache/clip/.")


@functools.lru_cache()
def _byte_unicode_table() -> dict:
    """GPT-2 byte -> unicode map: printable latin-1 bytes keep their code
    point, the other 68 bytes map to 256 + i, in this order (the vocab's)."""
    keep = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    table = {b: chr(b) for b in keep}
    shifted = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + shifted)
            shifted += 1
    return table


def _clean_text(text: str) -> str:
    text = unicodedata.normalize("NFC", text)
    text = html.unescape(html.unescape(text))
    return _WHITESPACE_RUN.sub(" ", text).strip()


def _class(ch: str) -> str:
    """'L' letter, 'N' number, 'S' white space, '-' matched by nothing, 'P'
    anything else (the pattern's punctuation run)."""
    if ch in _WHITESPACE:
        return "S"
    if ch in _UNMATCHED:
        return "-"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "P"


def _starts_with(text: str, i: int, literal: str) -> bool:
    """Case-insensitive ``text[i:].startswith(literal)`` for a lower-case
    ASCII ``literal``, as the pattern's IGNORECASE matches it."""
    if i + len(literal) > len(text):
        return False
    return all(_FOLD.get(c, c.lower()) == want for c, want in zip(text[i:], literal))


def pretokenize(text: str) -> List[str]:
    """The pieces of the CLIP pretokenizer pattern
    ``<|startoftext|>|<|endoftext|>|'s|'t|'re|'ve|'m|'ll|'d|\\p{L}+|\\p{N}|[^\\s\\p{L}\\p{N}]+``
    (case-insensitive), left to right, skipping what no alternative matches."""
    pieces: List[str] = []
    classes = [_class(c) for c in text]
    i, n = 0, len(text)
    while i < n:
        lit = next((s for s in _SPECIALS + _CONTRACTIONS if _starts_with(text, i, s)), None)
        if lit is not None:
            pieces.append(text[i:i + len(lit)])
            i += len(lit)
            continue
        c = classes[i]
        if c == "N":
            pieces.append(text[i])
            i += 1
        elif c in "LP":
            j = i + 1
            while j < n and classes[j] == c:
                j += 1
            pieces.append(text[i:j])
            i = j
        else:
            i += 1
    return pieces


class ClipBPE:
    """Byte-level BPE encoder over the CLIP merges table."""

    def __init__(self, vocab_path: str | None = None):
        vocab_path = find_vocab_file(vocab_path)
        with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # line 0 is a header; 48894 merges make the 49408-entry vocab
        merges = [tuple(line.split()) for line in lines[1:1 + 49152 - 256 - 2]]
        self._b2u = _byte_unicode_table()
        tokens: List[str] = list(self._b2u.values())
        tokens += [t + "</w>" for t in self._b2u.values()]
        tokens += ["".join(m) for m in merges]
        tokens += list(_SPECIALS)
        self.encoder = {tok: i for i, tok in enumerate(tokens)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self._u2b = {u: b for b, u in self._b2u.items()}
        self._rank = {m: i for i, m in enumerate(merges)}
        self._cache: dict = {s: (s,) for s in _SPECIALS}

    def _merge_word(self, token: str) -> tuple:
        """BPE merges of one pre-token, lowest rank first, every occurrence
        of the chosen pair left to right."""
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        parts: List[str] = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            ranked = [(self._rank.get(p), i) for i, p in enumerate(zip(parts, parts[1:]))]
            ranked = [(r, i) for r, i in ranked if r is not None]
            if not ranked:
                break
            _, best = min(ranked)
            pair = (parts[best], parts[best + 1])
            out: List[str] = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and (parts[i], parts[i + 1]) == pair:
                    out.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    out.append(parts[i])
                    i += 1
            parts = out
        self._cache[token] = tuple(parts)
        return self._cache[token]

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for tok in pretokenize(_clean_text(text).lower()):
            mapped = "".join(self._b2u[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[sub] for sub in self._merge_word(mapped))
        return ids

    def encode_batch(self, texts: Sequence[str]) -> List[List[int]]:
        """:meth:`encode` of each text (the JAX package's native core is
        left out, so every text takes the Python path)."""
        return [self.encode(t) for t in texts]

    def decode(self, ids: Iterable[int]) -> str:
        """Token ids back to text: bytes that do not form UTF-8 are
        replaced, and each word end ``</w>`` becomes a space."""
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self._u2b[c] for c in text if c in self._u2b)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def _tokenizer(path: str) -> ClipBPE:
    return ClipBPE(path)


def get_tokenizer(vocab_path: str | None = None) -> ClipBPE:
    """The tokenizer of :func:`find_vocab_file`'s file, one per file."""
    return _tokenizer(find_vocab_file(vocab_path))


def tokenize(texts: Union[str, Sequence[str]], vocab_path: str | None = None) -> np.ndarray:
    """Text(s) -> (N, 77) int32: SOT + ids + EOT, zero-padded; longer
    sequences are cut with the last token forced to EOT."""
    if isinstance(texts, str):
        texts = [texts]
    bpe = get_tokenizer(vocab_path)
    out = np.zeros((len(texts), CONTEXT_LENGTH), dtype=np.int32)
    for row, text in enumerate(texts):
        ids = ([SOT_TOKEN] + bpe.encode(text))[:CONTEXT_LENGTH - 1] + [EOT_TOKEN]
        out[row, :len(ids)] = ids
    return out


def star_token_id(vocab_path: str | None = None) -> int:
    """Token id of the ``*`` placeholder (``tokenize(["*"])[0][1]``)."""
    return int(tokenize(["*"], vocab_path=vocab_path)[0][1])


# Causal-prefix text buckets: a causal tower's output at a row's pool index
# does not depend on positions after it, so a batch can be trimmed to the
# shortest width covering every row's post-splice pool index.
TEXT_BUCKETS = (16, 32, 77)


def token_needs(tx, n_pseudo: int = 3) -> np.ndarray:
    """Per-row EOT index plus the splice shift ``n_pseudo``: a bucket at
    least this wide computes the row's pooled output exactly."""
    tx = np.asarray(tx)
    return (np.argmax(tx == EOT_TOKEN, axis=-1) + n_pseudo).astype(np.int32)


def bucket_for(need: int, buckets=TEXT_BUCKETS, full: int = CONTEXT_LENGTH) -> int:
    """Smallest bucket width covering ``need``; the full width otherwise."""
    for b in buckets:
        if need <= b:
            return min(b, full)
    return full


def bucket_text(tx, buckets=TEXT_BUCKETS, n_pseudo: int = 3) -> np.ndarray:
    """Trim a (B, 77) token batch to the shortest bucket covering every row's
    post-splice pool index (``n_pseudo``: K of a retrieval splice, which
    pools at EOT + K - 1; 1 for the in-place train splice, which pools at
    EOT)."""
    tx = np.asarray(tx)
    if tx.shape[1] <= buckets[0]:
        return tx
    b = bucket_for(int(token_needs(tx, n_pseudo).max()), buckets, tx.shape[1])
    return tx[:, :b] if b < tx.shape[1] else tx
