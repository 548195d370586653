"""The port's BPE tokenizer (a copy without regex or ftfy) against
keds_tpu.tokenizer on a synthetic merges file: exact ids."""

import pathlib
import subprocess
import sys
import unicodedata

import numpy as np
import pytest
import torch

from keds_tpu import tokenizer as jtok

from keds_tpu_torch import tokenizer as ttok

from torch_port_helpers import write_synthetic_vocab

torch.set_num_threads(1)

# tests/test_tokenizer.py's texts
TEXTS = [
    "a photo of",
    "a photo of * , a dog chasing a ball",
    "*",
    "a photo of * * * wearing a red hat",
    "This is a photo of a CAT!!!",
    "hello   world\twith   spaces",
    "don't stop; it's 2024's best-seller (really?)",
    "a cartoon of *",
    "1 2 33 456 numbers",
    "émigré café naïve — unicode façade",
    "",
    "x" * 400,
]
# numerics of categories No, Nl and Nd outside ASCII (stdlib \w and \d class
# them otherwise than \p{N}), a decomposed accent, the templates, the
# pattern's case-insensitive and unmatched corners, and a cut string
EXTRA = [
    "\u00b2", "\u00bd", "\u216b", "\u0663", "x\u00b2+y\u00bd \u216b\u06634", "cafe\u0301",
    "e\u0301migre\u0301",
    "a photo of * * * ", "a photo of * * a dog", "a photo of * * *  wearing  a hat",
    "it'\u017f Ok'S 'LL 'Re", "a\u0345b !\u0345!", "<|startoftext|> <|ENDOFTEXT|>x",
    "tab\tnbsp\xa0em\u2003fs\x1csep\u3000end ", "&amp;amp; &lt;b&gt;",
    "\uff21\uff22\uff23 \u65e5\u672c\u8a9e\u306e\u30c6\u30ad\u30b9\u30c8",
    ("a photo of * , the cat and the dog chasing a red ball " * 8)[:400],
]


@pytest.fixture
def vocab(tmp_path):
    path = write_synthetic_vocab(tmp_path / "merges.txt.gz")
    jtok.get_tokenizer.cache_clear()
    jtok.star_token_id.cache_clear()
    yield path
    jtok.get_tokenizer.cache_clear()
    jtok.star_token_id.cache_clear()


@pytest.mark.parametrize("texts", [TEXTS, EXTRA], ids=["test_tokenizer_texts", "extra"])
def test_ids_equal_jax(vocab, texts):
    ours = ttok.tokenize(texts, vocab_path=vocab)
    ref = jtok.tokenize(texts, vocab_path=vocab)
    assert ours.dtype == ref.dtype == np.int32 and ours.shape == (len(texts), 77)
    np.testing.assert_array_equal(ours, ref)
    # the merges fire: a template is shorter than its bytes
    assert (ours[1] > 0).sum() < len("a photo of * , a dog chasing a ball")


def test_truncation_forces_eot(vocab):
    ours = ttok.tokenize(["x y " * 100, "x y " * 37 + "x"], vocab_path=vocab)
    np.testing.assert_array_equal(ours, jtok.tokenize(["x y " * 100, "x y " * 37 + "x"],
                                                      vocab_path=vocab))
    assert ours[0, 0] == ttok.SOT_TOKEN and ours[0, -1] == ttok.EOT_TOKEN and (ours > 0).all()


def test_star_id_and_vocab_lookup(vocab, monkeypatch, tmp_path):
    assert ttok.star_token_id(vocab) == jtok.star_token_id(vocab) == 265
    monkeypatch.setenv("KEDS_TPU_BPE_VOCAB", vocab)
    assert ttok.find_vocab_file() == vocab
    np.testing.assert_array_equal(ttok.tokenize(TEXTS[:4]),
                                  ttok.tokenize(TEXTS[:4], vocab_path=vocab))
    with pytest.raises(FileNotFoundError, match="explicit path"):
        ttok.find_vocab_file(str(tmp_path / "missing.gz"))
    monkeypatch.delenv("KEDS_TPU_BPE_VOCAB")
    monkeypatch.setattr(ttok, "_VOCAB_SEARCH_PATHS", ())
    with pytest.raises(FileNotFoundError, match="KEDS_TPU_BPE_VOCAB"):
        ttok.star_token_id()


def test_pretokenizer_pieces_equal_the_pattern_over_every_code_point():
    """Every code point Python's unicodedata assigns, in one string and
    shuffled among contractions: the scanner's pieces are the JAX
    package's regex pattern's."""
    chars = [chr(c) for c in range(sys.maxunicode + 1)
             if unicodedata.category(chr(c)) not in ("Cn", "Cs")]
    text = "".join(chars)
    assert ttok.pretokenize(text) == jtok.ClipBPE._PRETOKENIZE.findall(text)
    rng = np.random.default_rng(0)
    pool = chars[:2000] + list("'sStTrReEvVmMlLdD\u017f \n") * 50
    for _ in range(200):
        t = "".join(rng.choice(pool, size=int(rng.integers(0, 40))))
        assert ttok.pretokenize(t) == jtok.ClipBPE._PRETOKENIZE.findall(t), repr(t)


def test_imports_neither_regex_nor_ftfy(vocab):
    """With regex and ftfy blocked the module imports and gives the same ids."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('regex', 'ftfy'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "from keds_tpu_torch.tokenizer import tokenize\n"
        f"print(tokenize({EXTRA[:6]!r}, vocab_path={vocab!r}).tolist())\n"
        "assert not {'regex', 'ftfy'} & set(sys.modules)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=pathlib.Path(__file__).resolve().parent.parent)
    assert out.returncode == 0, out.stderr
    assert eval(out.stdout) == ttok.tokenize(EXTRA[:6], vocab_path=vocab).tolist()
