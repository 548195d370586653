"""Image-stream training from raw images: ``trainer.make_train_step(
stream="image")`` on a ``RawBatch`` whose uint8 images and caption tokens
are copied from a host pool every step, AdamW over the heads (f32),
compute in the configuration's dtype, steps dispatched back to back.

Set-up builds one step and one set of heads and drives them through the
mix's first ``check_steps`` steps (pool batches 0, 1, 2: rows that all
differ), the last of which warm every shape; the window continues the same
object from there.  Checked against the plain reference following the same
steps from the same inputs and step randomness: ``loss_gap`` (the widest
relative gap of a step's loss), ``grad_gap`` (the first gradient as AdamW
got it, read back from its state after one step) and ``change_gap`` (each
head tensor's change over the steps), each by the worst tensor: the gap of
the norms over the larger of the reference tensor's norm and the median
tensor's.  Tensors whose reference gradient is under a thousandth of the
median tensor's move by round-off alone and are left out of the change.
The towers and the search, which the heads' numbers hardly see, are
checked on the same steps: ``text_gap``, the widest 1 - cos of a row of
the text tower's features (the prompt with the pseudo-tokens), and
``neighbour_deficit`` (``serving.neighbour_deficit``) of the DB rows each
step retrieved.  Three steps
at warm-up rates of 1e-8 to 3e-8 cannot see the decoupled weight decay
(lr·wd of a weight a step).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List

import numpy as np
import torch

from benchmark.harness import reference, serving, traffic
from benchmark.harness.core import Check, Record

PROMPT = (traffic.SOT, *traffic.A_PHOTO_OF, traffic.EOT)     # "a photo of"
K_PSEUDO = 3


@contextlib.contextmanager
def text_features_logged(out: List[torch.Tensor]):
    """Each text-tower call's features (``models.clip.encode_text_img``,
    which the image stream's loss calls) appended to ``out``, detached."""
    from keds_tpu_torch.models import clip as mclip

    encode = mclip.encode_text_img

    def logged(*args, **kwargs):
        y = encode(*args, **kwargs)
        out.append(y.detach().float())
        return y

    mclip.encode_text_img = logged
    try:
        yield
    finally:
        mclip.encode_text_img = encode


@dataclasses.dataclass
class State:
    step: Any
    heads: Any
    opt: Any
    retriever: Any
    inputs: serving.Inputs
    cfg: dict
    mix: dict
    t: int = 0
    marks: Dict[str, List[float]] = dataclasses.field(default_factory=dict)


def make_inputs(ctx) -> serving.Inputs:
    mix = ctx.mix
    inputs = serving.make_inputs(ctx, mix["batch"], mix["image_pool_batches"],
                                 ctx.config["train_heads_dtype"])
    r = traffic.rng(ctx.seed, 9)
    lo, hi = mix["caption_tokens"]
    inputs.extra["captions"] = np.stack([traffic.captions(r, mix["batch"], lo, hi)
                                         for _ in range(mix["image_pool_batches"])])
    return inputs


def program_leaves(heads) -> Dict[str, torch.Tensor]:
    """The program's head tensors under the reference's names."""
    out = {}
    for i, layer in enumerate(heads.img2text["layers"]):
        out[f"img2text.layers.{i}.0.weight"], out[f"img2text.layers.{i}.0.bias"] = \
            layer["w"], layer["b"]
    out["img2text.fc_out.weight"] = heads.img2text["fc_out"]["w"]
    out["img2text.fc_out.bias"] = heads.img2text["fc_out"]["b"]
    for mod in ("retrieval_fuse", "text_condition"):
        for i, layer in enumerate(getattr(heads, mod)):
            for part, name in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"),
                               ("to_out", "to_out.0")):
                out[f"{mod}.cross_layers.{i}.{name}.weight"] = layer[part]["w"]
                out[f"{mod}.cross_layers.{i}.{name}.bias"] = layer[part]["b"]
    return out


def _batch(st: State, j: int):
    from keds_tpu_torch.tokenizer import bucket_text
    from keds_tpu_torch.train.losses import RawBatch

    dev = st.inputs.clip_sd["logit_scale"].device
    caps = bucket_text(st.inputs.extra["captions"][j], n_pseudo=1)
    return RawBatch(images=torch.from_numpy(st.inputs.pool[j]).to(dev),
                    caption_tokens=torch.from_numpy(np.ascontiguousarray(caps)).to(dev))


def step_seed(ctx) -> int:
    return ctx.seed % (1 << 31)


def setup(ctx, inputs: serving.Inputs) -> State:
    from keds_tpu_torch.config import Config
    from keds_tpu_torch.models.convert import clip_from_state_dict, heads_from_checkpoint
    from keds_tpu_torch.ops.quant import maybe_quantize_clip
    from keds_tpu_torch.retrieval.database import KnowledgeDB, Retriever
    from keds_tpu_torch.train import trainer

    cfg, mix, dev = ctx.config, ctx.mix, ctx.device
    params, clip_cfg = clip_from_state_dict(inputs.clip_sd, device=dev)
    serving.check_config(cfg, clip_cfg)
    # the control: the heads and AdamW's state one precision down (bf16 for
    # the stated f32), or the towers in W8A8 int8
    heads_dtype = "bfloat16" if ctx.control == "bf16" else cfg["train_heads_dtype"]
    params = maybe_quantize_clip(params, "int8" if ctx.control == "int8" else "none")
    heads = heads_from_checkpoint(inputs.heads, device=dev, dtype=serving.dtype(heads_dtype))
    img, txt = inputs.tables
    retriever = Retriever(KnowledgeDB(img, txt, [str(i) for i in range(img.shape[0])]))
    o = mix["optimizer"]
    opt, schedule = trainer.make_optimizer(
        Config(lr=o["lr"], beta1=o["beta1"], beta2=o["beta2"], eps=o["eps"], wd=o["wd"],
               warmup=o["warmup"]), o["total_steps"], heads)
    prompt = np.zeros((1, traffic.CONTEXT), np.int32)
    prompt[0, :len(PROMPT)] = PROMPT
    step = trainer.make_train_step(
        params, clip_cfg, retriever, opt, schedule, stream="image", prompt_tokens=prompt,
        split_id=traffic.STAR, seed=step_seed(ctx), dropout=mix["dropout"],
        db_topk=cfg["db"]["topk"], compute_dtype=serving.dtype(cfg["compute_dtype"]),
        encode_chunk=mix["encode_chunk"], device=dev)
    del params
    st = State(step, heads, opt, retriever, inputs, cfg, mix)
    plant_fault(st, ctx.fault)
    leaves = program_leaves(heads)
    start = {n: p.detach().to(torch.float32, copy=True) for n, p in leaves.items()}
    losses = []
    log, text = serving.NeighbourLog(retriever), []
    with text_features_logged(text):
        for t in range(mix["check_steps"]):
            losses.append(float(st.step(heads, _batch(st, t % len(inputs.pool)), t)))
            if t == 0:
                beta1 = o["beta1"]
                grads = {n: opt.state[p]["exp_avg"].float() / (1 - beta1)
                         if p in opt.state else torch.zeros_like(p, dtype=torch.float32)
                         for n, p in leaves.items()}
    log.close()
    inputs.extra["program"] = {"losses": losses, "grads": grads,
                               "change": {n: p.detach().float() - start[n]
                                          for n, p in leaves.items()},
                               "text_features": text, "ids": log.take()}
    st.t = mix["check_steps"]
    return st


def plant_fault(st: State, fault) -> None:
    """Break the timed path underneath (the harness's own tests): 'state'
    leaves the heads unchanged by each step; 'half' steps on the first half
    of every batch only (the mean taken over it); 'neighbours' retrieves
    the DB rows one past the right ones."""
    if fault is None:
        return
    step = st.step
    if fault == "neighbours":
        serving.shift_neighbours(st.retriever)
    elif fault == "state":
        st.opt.step = lambda *a, **k: None
    elif fault == "half":
        def half(heads, batch, t, **kw):
            h = batch.images.shape[0] // 2
            return step(heads, type(batch)(batch.images[:h], batch.caption_tokens[:h]), t, **kw)

        st.step = half
    else:
        raise ValueError(f"unknown fault {fault!r}")


def call(st: State, i: int, traced: bool = False) -> Record:
    j = st.t % len(st.inputs.pool)
    if traced and st.inputs.clip_sd["logit_scale"].is_cuda:
        ev = {}

        def mark(stage: str) -> None:
            ev[stage] = torch.cuda.Event(enable_timing=True)
            ev[stage].record()

        mark("start")
        st.step(st.heads, _batch(st, j), st.t, mark=mark)
        st.marks.setdefault("_events", []).append(ev)
    else:
        st.step(st.heads, _batch(st, j), st.t)
    st.t += 1
    return Record(units=st.mix["batch"], out=j)


def shapes(st: State, records: List[Record]) -> List[dict]:
    """One step a training step (harness/counts.py): the frozen encode, both
    searches, the heads forward and backward, the text tower's forward and
    input gradient at the prompt's real length."""
    db, B = st.cfg["db"], st.mix["batch"]
    step = {"images": B, "encode_chunk": st.mix["encode_chunk"] or B,
            "searches": [[B, db["rows"], db["dim"], db["topk"], db["dtype"]]] * 2,
            "heads": [B, db["topk"]], "text": [len(PROMPT) + K_PSEUDO] * B, "backward": True}
    return [step] * len(records)


def spans(st: State) -> Dict[str, List[float]]:
    """The traced steps' device ms from the events at their ``mark`` hooks."""
    events = st.marks.pop("_events", [])
    if events:
        torch.cuda.synchronize()
    return {"encode_ms": [e["start"].elapsed_time(e["encode"]) for e in events],
            "backward_ms": [e["text_tower_forward"].elapsed_time(e["backward"])
                            for e in events]}


def release(st: State) -> None:
    st.step = st.heads = st.opt = None


def _by_worst_leaf(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
                   keep: List[str]) -> float:
    rn = {n: float(ref[n].norm()) for n in keep}
    med = float(np.median(list(rn.values())))
    return max(abs(float(prog[n].norm()) - rn[n]) / max(rn[n], med) for n in keep)


def check(ctx, inputs: serving.Inputs, records: List[Record]) -> List[Check]:
    mix, dev, seed = ctx.mix, ctx.device, step_seed(ctx)
    prog = inputs.extra["program"]
    batches = [torch.from_numpy(inputs.pool[t % len(inputs.pool)]).to(dev)
               for t in range(mix["check_steps"])]
    rate = mix["dropout"]

    def step_random(t: int):
        # the step's generator: the neighbour shuffle first, then the masks
        g = torch.Generator(device=dev).manual_seed((seed << 32) + t)
        perm = torch.randperm(ctx.config["db"]["topk"], generator=g, device=dev)
        return perm, lambda shape: torch.rand(shape, generator=g, device=dev) < 1 - rate

    with reference.exact_f32():
        ref = reference.train_steps(inputs.clip_sd, inputs.heads, inputs.tables, batches,
                                    PROMPT, ctx.config["db"]["topk"], mix["optimizer"],
                                    step_random)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    names = list(ref["grads"])
    grad_gap = _by_worst_leaf(prog["grads"], ref["grads"], names)
    init = reference.head_leaves(inputs.heads)
    gnorm = {n: float(ref["grads"][n].norm()) for n in names}
    med = float(np.median(list(gnorm.values())))
    moved = [n for n in names if gnorm[n] >= 1e-3 * med]
    change_gap = _by_worst_leaf(prog["change"],
                                {n: ref["params"][n] - init[n].detach() for n in moved}, moved)
    # row for row over the rows each step searched (a step that drops rows
    # is the loss's to catch)
    n = [len(f) for f in prog["text_features"]]
    text_gap = serving.cosine_gap(torch.cat(prog["text_features"]).cpu().numpy(),
                                  torch.cat([r[:m] for r, m in zip(ref["text_features"], n)]))
    f_ref = torch.cat([r[:m] for r, m in zip(ref["features"], n)])
    ids = [torch.cat([i[t] for i in prog["ids"]]) for t in (0, 1)]
    deficit = serving.neighbour_deficit(f_ref, inputs.tables, ids, ctx.config["db"]["topk"])
    lim = ctx.limits
    return [Check("loss_gap", loss_gap, lim["loss_gap"]),
            Check("grad_gap", grad_gap, lim["grad_gap"]),
            Check("change_gap", change_gap, lim["change_gap"]),
            Check("text_gap", text_gap, lim["text_gap"]),
            Check("neighbour_deficit", deficit, lim["neighbour_deficit"])]
