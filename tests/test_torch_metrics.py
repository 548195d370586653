"""keds_tpu_torch.evalkit.metrics against keds_tpu.evalkit.metrics: every
function on the same seeded inputs gives exactly the same output, the
ground-truth contracts fail alike, and the ``1 - s`` tie class splits the
host and device rankings the same way in both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from keds_tpu.evalkit import metrics as JM

from keds_tpu_torch.evalkit import metrics as TM
from keds_tpu_torch.ops.topk import mips_topk

torch.set_num_threads(1)

N_T, N_Q, DIM = 30, 12, 16


def _unit(rng, n):
    a = rng.standard_normal((n, DIM)).astype(np.float32)
    return a / np.linalg.norm(a, axis=1, keepdims=True)


def _inputs():
    """A corpus of 30 paths, 12 queries each with its own reference and a
    unique target, features, labels and top-k index matrices."""
    rng = np.random.default_rng(0)
    corpus, queries = _unit(rng, N_T), _unit(rng, N_Q)
    paths = [f"dev/c{i}.png" for i in range(N_T)]
    base = [f"c{i}.png" for i in range(N_T)]
    refs = [base[i] for i in range(N_Q)]
    targets = [base[(i + 5) % N_T] for i in range(N_Q)]
    top = np.argsort(-(queries @ corpus.T), axis=1, kind="stable")
    return dict(corpus=corpus, queries=queries, paths=paths, base=base, refs=refs,
                targets=targets, top=top, labels_q=rng.integers(0, 4, N_Q),
                labels_t=rng.integers(0, 4, N_T),
                ranks=rng.integers(0, N_T, (2, N_Q)))


CASES = {
    "get_metrics_coco": lambda M, x: M.get_metrics_coco(
        x["corpus"][:N_Q], x["queries"], np.float32(14.3)),
    "get_metrics_coco_from_preds": lambda M, x: M.get_metrics_coco_from_preds(*x["ranks"]),
    "get_metrics_fashion": lambda M, x: M.get_metrics_fashion(
        x["corpus"], x["queries"], x["paths"], [x["paths"][(i + 5) % N_T] for i in range(N_Q)]),
    "get_metrics_fashion_from_topk": lambda M, x: M.get_metrics_fashion_from_topk(
        x["top"][:, :25], x["paths"], [x["paths"][(i + 5) % N_T] for i in range(N_Q)]),
    "check_fashion_gt_unique": lambda M, x: M.check_fashion_gt_unique(
        x["paths"], x["paths"][:N_Q]),
    "masked_cirr_ranking": lambda M, x: M._masked_cirr_ranking(
        x["corpus"], x["queries"], x["refs"], x["paths"]).tolist(),
    "get_metrics_cirr": lambda M, x: M.get_metrics_cirr(
        x["corpus"], x["queries"], x["refs"], x["paths"], x["targets"]),
    "check_cirr_gt_unique": lambda M, x: M.check_cirr_gt_unique(
        x["base"], x["refs"], x["targets"]),
    "get_metrics_cirr_from_topk": lambda M, x: M.get_metrics_cirr_from_topk(
        x["top"][:, :21], x["base"], x["refs"], x["targets"], 21),
    "get_cirr_testoutput": lambda M, x: M.get_cirr_testoutput(
        np.concatenate([x["corpus"]] * 2), x["queries"], x["refs"],
        x["paths"] + [f"dev/d{i}.png" for i in range(N_T)], list(range(100, 100 + N_Q))),
    "get_metrics_imgnet": lambda M, x: M.get_metrics_imgnet(
        x["queries"], x["corpus"], x["labels_q"], x["labels_t"]),
    "get_metrics_imgnet_from_topk": lambda M, x: M.get_metrics_imgnet_from_topk(
        x["top"], x["labels_q"], x["labels_t"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_metric_function_equals_jax(name):
    x = _inputs()
    out = CASES[name](TM, x)
    assert out == CASES[name](JM, x)
    assert out is None if name.startswith("check") else out


def test_metrics_cover_every_function():
    public = {n for n in dir(JM) if n.startswith(("get_", "check_"))}
    assert public == {n for n in dir(TM) if n.startswith(("get_", "check_"))}
    assert public | {"masked_cirr_ranking"} == set(CASES)


def _broken(x):
    """Inputs that break each ground-truth contract."""
    dup = x["paths"][:-1] + [x["paths"][0]]           # the first path twice
    return {
        "fashion answer missing": lambda M: M.check_fashion_gt_unique(
            x["paths"][1:], x["paths"][:N_Q]),
        "fashion answer twice": lambda M: M.check_fashion_gt_unique(dup, x["paths"][:N_Q]),
        "fashion full width": lambda M: M.get_metrics_fashion(
            x["corpus"], x["queries"], dup, x["paths"][:N_Q]),
        "cirr target is reference": lambda M: M.check_cirr_gt_unique(
            x["base"], x["refs"], x["refs"]),
        "cirr reference missing": lambda M: M.check_cirr_gt_unique(
            x["base"], ["z.png"] * N_Q, x["targets"]),
        "cirr target missing": lambda M: M.check_cirr_gt_unique(
            x["base"], x["refs"], ["z.png"] * N_Q),
        "cirr full width": lambda M: M.get_metrics_cirr(
            x["corpus"], x["queries"], x["refs"], x["paths"], x["refs"]),
    }


@pytest.mark.parametrize("case", sorted(_broken(_inputs())))
def test_contract_failures_match_jax(case):
    fn = _broken(_inputs())[case]
    with pytest.raises(AssertionError) as jerr:
        fn(JM)
    with pytest.raises(AssertionError) as terr:
        fn(TM)
    assert str(terr.value) == str(jerr.value)


# --- the 1 - s tie class --------------------------------------------------------

# Scores i * 1e-9 (all below 2^-25): distinct in f32, but 1 - s rounds every
# one of them to 1.0, so the host's stable ascending argsort of the
# distances keeps corpus order while a descending top-k of the scores puts
# the last row first.
N_TIE = 8


def _tie_inputs():
    s = np.arange(N_TIE, dtype=np.float32) * np.float32(1e-9)
    assert (np.float32(1) - s == 1).all() and len(set(s.tolist())) == N_TIE
    corpus = np.zeros((N_TIE, 4), np.float32)
    corpus[:, 0] = s
    corpus[:, 1] = np.sqrt(1 - s.astype(np.float64) ** 2).astype(np.float32)
    query = np.zeros((3, 4), np.float32)
    query[:, 0] = 1                  # query . row i = s_i exactly, in any order
    return corpus, query


def _jax_device_topk(q, corpus, k):
    return np.asarray(jax.lax.top_k(jnp.matmul(
        q, corpus.T, precision=jax.lax.Precision.HIGHEST), k)[1])


def _port_device_topk(q, corpus, k):
    return mips_topk(torch.from_numpy(q), torch.from_numpy(corpus), k)[1].numpy()


@pytest.mark.parametrize("bench", ["cirr", "fashion"])
def test_one_minus_s_ties_split_host_and_device_alike(bench):
    """Host path: the port's formula gives the JAX package's table.  Device
    path: the port's top-k (mips_topk) and *_from_topk give the JAX
    package's top-k tables.  The two paths differ, in both packages alike:
    the host sees ties where the device sees distinct scores."""
    corpus, query = _tie_inputs()
    names = [f"dev/c{i}.png" for i in range(N_TIE)]
    base = [n.split("/")[1] for n in names]
    last = N_TIE - 1                 # the best score, last in corpus order
    tables = {}
    for pkg, M, topk in (("jax", JM, _jax_device_topk), ("port", TM, _port_device_topk)):
        if bench == "cirr":
            refs, targets = base[:3], [base[last]] * 3
            host = M.get_metrics_cirr(corpus, query, refs, names, targets)
            device = M.get_metrics_cirr_from_topk(topk(query, corpus, N_TIE), base, refs,
                                                  targets, N_TIE)
        else:
            answers = [names[last]] * 3
            host = M.get_metrics_fashion(corpus, query, names, answers)
            device = M.get_metrics_fashion_from_topk(topk(query, corpus, N_TIE), names,
                                                     answers)
        tables[pkg] = host, device
    assert tables["port"] == tables["jax"]
    host, device = tables["port"]
    r1 = "recall_R@1" if bench == "cirr" else "R@1"
    assert host[r1] == 0.0 and device[r1] == 100.0
