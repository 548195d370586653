"""Bulk composed retrieval: one caller, closed loop, each call
``ComposedQueryEngine.compose`` over ``batches_per_call`` batches of
``batch`` queries, the features on the host when it returns.

Mix parameters: batch, batches_per_call, image_pool_batches (uint8 NHWC
batches made in set-up, cycled), caption_tokens [lo, hi] (every batch
holds each length equally often), encode_chunk, trace_calls, check_rows.
Checked on sampled answers against the plain reference: ``feature_gap``,
the widest 1 - cos of a composed feature, and ``neighbour_deficit``
(``serving.neighbour_deficit``) of the DB rows the program retrieved for
them, which the composed feature hardly shows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import numpy as np
import torch

from benchmark.harness import serving, traffic
from benchmark.harness.core import Check, Record


@dataclasses.dataclass
class State:
    engine: Any
    log: serving.NeighbourLog
    inputs: serving.Inputs
    cfg: dict
    mix: dict
    prompts: np.random.Generator


def make_inputs(ctx) -> serving.Inputs:
    mix = ctx.mix
    return serving.make_inputs(ctx, mix["batch"], mix["image_pool_batches"],
                               ctx.config["compute_dtype"])


def _texts(st: State) -> List[np.ndarray]:
    lo, hi = st.mix["caption_tokens"]
    return [traffic.composed_prompts(st.prompts, st.mix["batch"], lo, hi)
            for _ in range(st.mix["batches_per_call"])]


def setup(ctx, inputs: serving.Inputs) -> State:
    eng = serving.engine(ctx, inputs)
    st = State(eng, serving.NeighbourLog(eng.retriever), inputs, ctx.config, ctx.mix,
               traffic.rng(ctx.seed, 7))
    st.engine.compose(list(inputs.pool[:ctx.mix["batches_per_call"]]), _texts(st))  # warm-up
    st.log.take()
    st.prompts = traffic.rng(ctx.seed, 8)
    return st


def call(st: State, i: int, traced: bool = False) -> Record:
    n, bpc = len(st.inputs.pool), st.mix["batches_per_call"]
    idx = [(i * bpc + j) % n for j in range(bpc)]
    texts = _texts(st)
    out = st.engine.compose([st.inputs.pool[j] for j in idx], texts)
    return Record(units=bpc * st.mix["batch"], out=(idx, texts, out, st.log.take()))


def shapes(st: State, records: List[Record]) -> List[dict]:
    """One step a batch (harness/counts.py): its encode, the two searches
    of the DB, the heads and the composed text tower."""
    db, chunk = st.cfg["db"], st.mix["encode_chunk"]
    steps = []
    for rec in records:
        for text in rec.out[1]:
            lengths = (traffic.real_lengths(text) + 2).tolist()      # '*' becomes 3 tokens
            B = len(lengths)
            steps.append({"images": B, "encode_chunk": chunk or B,
                          "searches": [[B, db["rows"], db["dim"], db["topk"], db["dtype"]]] * 2,
                          "heads": [B, db["topk"]], "text": lengths})
    return steps


def release(st: State) -> None:
    st.log.close()
    st.engine = None


def check(ctx, inputs: serving.Inputs, records: List[Record]) -> List[Check]:
    B = ctx.mix["batch"]
    rows = [(r, j, i) for r, rec in enumerate(records)
            for j in range(len(rec.out[0])) for i in range(B)]
    lengths = np.concatenate([traffic.real_lengths(t) for rec in records for t in rec.out[1]])
    pick = [rows[p] for p in serving.sample_rows(ctx, lengths, ctx.mix["check_rows"])]
    images = np.stack([inputs.pool[records[r].out[0][j]][i] for r, j, i in pick])
    text = np.stack([records[r].out[1][j][i] for r, j, i in pick])
    prog = np.stack([records[r].out[2][j * B + i] for r, j, i in pick])
    ids = [torch.stack([records[r].out[3][j][t][i] for r, j, i in pick]) for t in (0, 1)]
    ref, f_ref = serving.reference_features(ctx, inputs, images, text)
    deficit = serving.neighbour_deficit(f_ref, inputs.tables, ids, ctx.config["db"]["topk"])
    return [Check("feature_gap", serving.cosine_gap(prog, ref), ctx.limits["feature_gap"]),
            Check("neighbour_deficit", deficit, ctx.limits["neighbour_deficit"])]
