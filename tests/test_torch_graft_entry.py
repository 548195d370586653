"""graft_entry_torch.py against __graft_entry__.py: entry()'s composed-query
forward on the same weights (CLIP's VIT_L_14 patched to a tiny config at
224 px in both packages), its example arguments, the two-rank dry run on
the CPU from a parent outside any group, and the refusals without CUDA."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as gj
from keds_tpu.models import clip as jclip

import graft_entry_torch as gt
from keds_tpu_torch.models import clip as tclip
from keds_tpu_torch.models.convert import clip_from_numpy, heads_from_numpy

from torch_port_helpers import to_numpy

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
ATOL = 1e-4          # the engine parity tests' (tests/test_torch_engine.py)
BF16_COSINE_MIN = 0.99
TINY = dict(embed_dim=64, image_resolution=224, vision_layers=2, vision_width=64,
            vision_patch_size=32, transformer_width=64, transformer_heads=1,
            transformer_layers=2)


@pytest.fixture(scope="module")
def tiny():
    """Both packages' VIT_L_14 patched to TINY for the module; JAX's entry()
    (its fn jitted) and its f32 weights from its own _build."""
    mp = pytest.MonkeyPatch()
    mp.setenv("KEDS_TPU_JAX_CACHE", "0")      # _build's setup_jax: no cache under HOME
    mp.setattr(jclip, "VIT_L_14", jclip.ClipConfig(**TINY))
    mp.setattr(tclip, "VIT_L_14", tclip.ClipConfig(**TINY))
    fn, args = gj.entry()
    f32 = gj._build(jclip.VIT_L_14, db_rows=gt.ENTRY_DB_ROWS, dtype=jnp.float32)
    yield jax.jit(fn), args, f32
    mp.undo()


def _port(params, heads, db_img, db_txt, dtype):
    """JAX weights and DB tables as port tensors of ``dtype`` on the CPU."""
    return (clip_from_numpy(to_numpy(params), device="cpu", dtype=dtype),
            heads_from_numpy(to_numpy(heads), device="cpu", dtype=dtype),
            *(torch.from_numpy(np.array(a, np.float32)).to(dtype) for a in (db_img, db_txt)))


def _run_port(*args) -> np.ndarray:
    with torch.no_grad():
        return gt.composed_query(*args).float().numpy()


def test_entry_arguments_match_jax(tiny):
    _, jargs, _ = tiny
    fn, args = gt.entry(device="cpu")
    assert fn is gt.composed_query
    params, heads, db_img, db_txt, images, text = args
    np.testing.assert_array_equal(text.numpy(), np.asarray(jargs[5]))
    assert tuple(text.shape) == (8, 32)
    assert tuple(images.shape) == np.asarray(jargs[4]).shape == (8, 224, 224, 3)
    assert images.dtype == torch.bfloat16 and not images.any()
    assert tuple(db_img.shape) == tuple(db_txt.shape) == (gt.ENTRY_DB_ROWS, 64)
    assert db_img.dtype == params["text"]["tok_emb"].dtype == torch.bfloat16
    np.testing.assert_allclose(db_img.float().norm(dim=1).numpy(), 1.0, atol=1e-2)
    out = _run_port(*args)
    assert out.shape == (8, 64) and np.isfinite(out).all()


@pytest.mark.parametrize("images", ["zeros", "random"])
def test_entry_fn_matches_jax_f32(tiny, images):
    jfn, jargs, (params, heads, db) = tiny
    if images == "zeros":
        x = np.zeros((8, 224, 224, 3), np.float32)
    else:
        x = np.random.default_rng(3).standard_normal((8, 224, 224, 3)).astype(np.float32)
    text = np.array(jargs[5])
    ref = np.asarray(jfn(params, heads, db.image_db, db.text_db, jnp.asarray(x),
                         jnp.asarray(text)))
    out = _run_port(*_port(params, heads, db.image_db, db.text_db, torch.float32),
                    torch.from_numpy(x), torch.from_numpy(text))
    assert out.shape == ref.shape == (8, 64)
    np.testing.assert_allclose(out, ref, atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(out, axis=1), 1.0, atol=1e-5)


def test_entry_fn_matches_jax_bf16(tiny):
    jfn, jargs, _ = tiny
    params, heads, db_img, db_txt, images, text = jargs
    ref = np.asarray(jfn(*jargs), np.float32)
    out = _run_port(*_port(params, heads, db_img, db_txt, torch.bfloat16),
                    torch.zeros(images.shape, dtype=torch.bfloat16),
                    torch.from_numpy(np.array(text)))
    cos = (out * ref).sum(1) / (np.linalg.norm(out, axis=1) * np.linalg.norm(ref, axis=1))
    assert cos.min() >= BF16_COSINE_MIN, cos


def test_dryrun_multichip_two_cpu_ranks():
    """From a parent with no group and no rank variables, as a user runs it:
    the four steps' lines, the neighbours-mode loss bit-equal, both ranks
    over gloo with the same global losses."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                        "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    code = ("import json, graft_entry_torch as g\n"
            "r = g.dryrun_multichip(2, device='cpu')\n"
            "print('PARENT_OK', json.dumps(r))\n")
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    for step in ("image-stream step OK", "precomputed-neighbour step OK (bit-equal",
                 "text-stream step OK", "sharded composed-query OK, out (8, 64)"):
        assert any(ln.startswith("dryrun_multichip(2): " + step) for ln in lines), step
    ranks = json.loads(lines[-1].removeprefix("PARENT_OK "))
    assert [r["rank"] for r in ranks] == [0, 1]
    assert {r["backend"] for r in ranks} == {"gloo"} and {r["device"] for r in ranks} == {"cpu"}
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert ranks[0]["losses"]["image"] == ranks[0]["losses"]["neighbours"]
    assert ranks[0]["lines"] == [ln for ln in lines if ln.startswith("dryrun_multichip(2)")]


@pytest.mark.parametrize("call", ["entry", "dryrun_multichip"])
def test_entry_points_refuse_without_cuda(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        gt.entry() if call == "entry" else gt.dryrun_multichip(2)
