"""Caption subject/other split (counterpart of
``keds_tpu/tools/extract_nouns.py``; reference ``extract_cc_noun.py``).

Splits each CC3M caption into its head noun phrase ("subject") and the rest
with the subject replaced by ``*`` ("other"), writing ``cc_subject.json`` /
``cc_other.json`` keyed by sample basename.

Uses spaCy's dependency parse when available (the reference's method:
head-of-sentence noun chunk, extract_cc_noun.py:10-51); otherwise a
deterministic heuristic fallback (first noun-phrase-like span after leading
articles) so the tool works in minimal environments — pass ``--require-spacy``
to refuse the fallback.

spaCy and its ``en_core_web_sm`` model are used where the user has them
installed; nothing is fetched.

    python -m keds_tpu_torch.tools.extract_nouns \
        --captions captions.json --out-dir . --workers 4
"""

from __future__ import annotations

import argparse
import json
import logging
import re
from typing import Tuple

_STOPWORDS = {
    "a", "an", "the", "this", "that", "these", "those", "some", "any",
    "his", "her", "its", "their", "our", "my", "your",
}
_PREPOSITIONS = {
    "in", "on", "at", "of", "with", "by", "for", "from", "to", "over",
    "under", "near", "into", "onto", "during", "against", "between",
    "and", "or", "while", "as", "is", "are", "was", "were", "that", "which",
    "who", "standing", "sitting", "wearing", "holding", "looking",
}


def _spacy_nlp():
    try:
        import spacy

        return spacy.load("en_core_web_sm")
    except Exception:
        return None


def extract_noun_phrase_spacy(nlp, text: str) -> Tuple[str, str]:
    """Reference method: find the dependency head, take its noun chunk as the
    subject, replace it by '*' in the caption."""
    return _split_from_doc(nlp(text), text)


def _split_from_doc(doc, text: str) -> Tuple[str, str]:
    chunks = {}
    for chunk in doc.noun_chunks:
        for i in range(chunk.start, chunk.end):
            chunks[i] = chunk
    head = next((t for t in doc if t.head.i == t.i), None)
    if head is None:
        return text, text
    if head.i not in chunks:
        children = list(head.children)
        if children and children[0].i in chunks:
            head = children[0]
        else:
            other = text.replace(head.text, "*").strip()
            return text, other
    subject = chunks[head.i].text
    other = text.replace(subject, "*").strip()
    return subject, other


def extract_noun_phrase_heuristic(text: str) -> Tuple[str, str]:
    """Fallback: the leading noun-phrase-like span (determiner + tokens up to
    the first preposition/verb-ish word) is the subject — like a spaCy noun
    chunk, the determiner belongs to the chunk, so replacing it leaves
    "* in the park"-style templates."""
    words = re.findall(r"[\w'-]+", text.lower())
    if not words:
        return text, text
    end = 0
    while end < len(words) and (words[end] in _STOPWORDS or end == 0):
        end += 1
    while end < len(words) and words[end] not in _PREPOSITIONS:
        end += 1
    subject = " ".join(words[:end])
    if not subject:
        return text, text
    other = text.lower().replace(subject, "*", 1).strip()
    return subject, other


_WORKER_NLP = None
_WORKER_HAVE_SPACY = True


def _worker_init(use_spacy: bool) -> None:
    """Pool initializer: each worker process loads its own spaCy pipeline
    once (the model object does not pickle across the pool boundary)."""
    global _WORKER_NLP, _WORKER_HAVE_SPACY
    _WORKER_HAVE_SPACY = use_spacy
    _WORKER_NLP = _spacy_nlp() if use_spacy else None


def _process_chunk(chunk):
    """Split one [(name, caption)] chunk; spaCy runs via ``nlp.pipe`` so the
    parser batches internally (reference pools the per-caption call,
    extract_cc_noun.py:117-122 — pipe batching is strictly faster)."""
    out = []
    nlp = _WORKER_NLP
    if _WORKER_HAVE_SPACY and nlp is None:
        # The parent loaded spaCy (that is what _WORKER_HAVE_SPACY records),
        # so a worker that cannot must not silently fall back to the
        # heuristic — the output would mix the two splitters per-chunk.
        raise RuntimeError(
            "worker process could not load spaCy (en_core_web_sm) although "
            "the parent did; fix the worker environment or rerun with "
            "--workers 1")
    if _WORKER_HAVE_SPACY and nlp is not None:
        texts = [caption for _, caption in chunk]
        for (name, caption), doc in zip(chunk, nlp.pipe(texts, batch_size=256)):
            subject, other = _split_from_doc(doc, caption)
            out.append((name, subject, other))
    else:
        for name, caption in chunk:
            subject, other = extract_noun_phrase_heuristic(caption)
            out.append((name, subject, other))
    return out


def main(argv=None) -> None:
    from keds_tpu_torch.logging_utils import setup_logging

    p = argparse.ArgumentParser()
    p.add_argument("--captions", required=True,
                   help="json {basename: caption} or cc3m_have*.pkl list")
    p.add_argument("--out-dir", default=".")
    p.add_argument("--require-spacy", action="store_true")
    p.add_argument("--workers", type=int, default=1,
                   help="caption-split worker processes (the reference uses "
                        "a multiprocessing pool, extract_cc_noun.py:117-122)")
    args = p.parse_args(argv)
    setup_logging()

    if args.captions.endswith(".pkl"):
        import pickle

        with open(args.captions, "rb") as f:
            entries = pickle.load(f)
        cap_map = {e["filename"]: e["text"] for e in entries}
    else:
        with open(args.captions) as f:
            cap_map = json.load(f)

    nlp = _spacy_nlp()
    if nlp is None:
        if args.require_spacy:
            raise SystemExit("spaCy (en_core_web_sm) is required but unavailable")
        logging.warning("spaCy unavailable; using the heuristic splitter")

    items = [(name, str(caption)) for name, caption in cap_map.items()]
    subjects, others = {}, {}

    def consume(results) -> None:
        for name, subject, other in results:
            key = name.split(".")[0]
            subjects[key] = subject
            others[key] = other

    if args.workers > 1 and items:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        chunk_size = max(1, min(50_000, (len(items) + args.workers * 4 - 1)
                                // (args.workers * 4)))
        chunks = [items[i:i + chunk_size]
                  for i in range(0, len(items), chunk_size)]
        with ProcessPoolExecutor(
            args.workers,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init, initargs=(nlp is not None,),
        ) as pool:
            done = 0
            for results in pool.map(_process_chunk, chunks):
                consume(results)
                done += len(results)
                if done % 100_000 < chunk_size:
                    logging.info("processed %d captions", done)
    else:
        global _WORKER_NLP, _WORKER_HAVE_SPACY
        _WORKER_HAVE_SPACY = nlp is not None
        _WORKER_NLP = nlp  # reuse the already-loaded pipeline (no re-load)
        for start in range(0, len(items), 50_000):
            chunk = items[start:start + 50_000]
            consume(_process_chunk(chunk))
            logging.info("processed %d captions", start + len(chunk))

    import os

    with open(os.path.join(args.out_dir, "cc_subject.json"), "w") as f:
        json.dump(subjects, f)
    with open(os.path.join(args.out_dir, "cc_other.json"), "w") as f:
        json.dump(others, f)
    logging.info("wrote cc_subject.json / cc_other.json (%d entries)", len(subjects))


if __name__ == "__main__":
    main()
