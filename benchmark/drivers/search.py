"""Interactive composed search: one client, closed loop, each request
``ComposedQueryEngine.search`` over one batch of ``batch`` queries against
a ``DeviceCorpus`` of ``gallery_rows`` f32 unit rows, the top-``topn``
scores and ids on the host when it returns.

Mix parameters: batch, image_pool_batches, caption_tokens [lo, hi],
encode_chunk, gallery_rows, topn, trace_calls, check_requests.  Checked,
on the sampled requests against the plain reference's composed features
and an f32 scan of the gallery: ``score_sq_gap``, the mean square of the
difference between a served score and the reference's score of the same
id, and ``set_deficit``, the mean over queries of how far the reference's
scores of the served ids sum below the reference's own top ``topn``.  Both
grow as the square of the composed feature's error (a near tie crosses
more often and by more), where a widest gap grows only as its first
power and could not tell the program from its int8 control.  And
``neighbour_deficit`` (``serving.neighbour_deficit``) of the DB rows the
program retrieved for the sampled queries.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np
import torch

from benchmark.harness import reference, serving, traffic, weights
from benchmark.harness.core import Check, Record


@dataclasses.dataclass
class State:
    engine: Any
    log: serving.NeighbourLog
    corpus: Any
    inputs: serving.Inputs
    cfg: dict
    mix: dict
    prompts: np.random.Generator


def make_inputs(ctx) -> serving.Inputs:
    mix = ctx.mix
    inputs = serving.make_inputs(ctx, mix["batch"], mix["image_pool_batches"],
                                 ctx.config["compute_dtype"])
    inputs.extra["gallery"] = weights.unit_table(
        mix["gallery_rows"], ctx.config["embed_dim"],
        weights.generator(ctx.seed, weights.STREAM_GALLERY, ctx.device), ctx.device,
        torch.float32)
    return inputs


def _text(st: State) -> np.ndarray:
    lo, hi = st.mix["caption_tokens"]
    return traffic.composed_prompts(st.prompts, st.mix["batch"], lo, hi)


def setup(ctx, inputs: serving.Inputs) -> State:
    from keds_tpu_torch.engine import DeviceCorpus

    g = inputs.extra["gallery"]
    eng = serving.engine(ctx, inputs)
    st = State(eng, serving.NeighbourLog(eng.retriever), DeviceCorpus(g, g.shape[0]),
               inputs, ctx.config, ctx.mix, traffic.rng(ctx.seed, 7))
    for i in range(3):                                               # warm-up
        st.engine.search([inputs.pool[i % len(inputs.pool)]], [_text(st)], st.corpus,
                         topn=ctx.mix["topn"])
    st.log.take()
    st.prompts = traffic.rng(ctx.seed, 8)
    return st


def call(st: State, i: int, traced: bool = False) -> Record:
    j = i % len(st.inputs.pool)
    text = _text(st)
    scores, idx = st.engine.search([st.inputs.pool[j]], [text], st.corpus, topn=st.mix["topn"])
    return Record(units=st.mix["batch"], out=(j, text, scores, idx, st.log.take()))


def shapes(st: State, records: List[Record]) -> List[dict]:
    """One step a request (harness/counts.py): its composed query, as a
    batch of ``serve_bulk``'s, and the f32 ranking scan of the gallery."""
    cfg, mix, db = st.cfg, st.mix, st.cfg["db"]
    steps = []
    for rec in records:
        lengths = (traffic.real_lengths(rec.out[1]) + 2).tolist()  # '*' becomes 3 tokens
        B = len(lengths)
        steps.append({"images": B, "encode_chunk": mix["encode_chunk"] or B,
                      "searches": [[B, db["rows"], db["dim"], db["topk"], db["dtype"]]] * 2
                      + [[B, mix["gallery_rows"], cfg["embed_dim"], mix["topn"], "float32"]],
                      "heads": [B, db["topk"]], "text": lengths})
    return steps


def release(st: State) -> None:
    st.log.close()
    st.engine = st.corpus = None


def check(ctx, inputs: serving.Inputs, records: List[Record]) -> List[Check]:
    # every request holds each caption length, the longest among them
    n = min(ctx.mix["check_requests"], len(records))
    pick = traffic.rng(ctx.seed, 6).choice(len(records), size=n, replace=False)
    recs = [records[p] for p in sorted(pick.tolist())]
    images = np.concatenate([inputs.pool[rec.out[0]] for rec in recs])
    text = np.concatenate([rec.out[1] for rec in recs])
    ref, f_ref = serving.reference_features(ctx, inputs, images, text)
    with torch.no_grad(), reference.exact_f32():
        sims = ref @ inputs.extra["gallery"].T                          # (n·B, G) f32
        best = torch.topk(sims, ctx.mix["topn"], dim=1).values
    ids = torch.from_numpy(np.concatenate([rec.out[3] for rec in recs])).to(sims.device)
    served = torch.from_numpy(np.concatenate([rec.out[2] for rec in recs])).to(sims.device)
    ref_of_served = torch.gather(sims, 1, ids.long())
    sq = float(((served - ref_of_served) ** 2).mean())
    deficit = float((best.sum(1) - ref_of_served.sum(1)).mean())
    db_ids = [torch.cat([rec.out[4][0][t] for rec in recs]) for t in (0, 1)]
    db_deficit = serving.neighbour_deficit(f_ref, inputs.tables, db_ids,
                                           ctx.config["db"]["topk"])
    return [Check("score_sq_gap", sq, ctx.limits["score_sq_gap"]),
            Check("set_deficit", deficit, ctx.limits["set_deficit"]),
            Check("neighbour_deficit", db_deficit, ctx.limits["neighbour_deficit"])]
