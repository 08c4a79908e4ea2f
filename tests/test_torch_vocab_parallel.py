"""The vocab-parallel logits and cross entropy of training on a mesh
(``layers.unembed_local``, ``shardlib.vocab_nll``,
``transformer.next_token_nll(start=)``) against the reference.

The gloo ranks of a 1x2 and a 2x2 mesh (one spawn each,
``tests/_torch_layout_ranks``) take one train step's loss of the global
batch (4 x 16) on their pieces -- tinyllama-1.1b's untied head uncapped
and capped at 30, llama3.2-1b's tied table capped -- and gather every
gradient whole.  The loss and each gradient leaf are held to
``jax.value_and_grad`` of the reference's ``loss_fn`` (loss 1e-5 relative,
each leaf 1e-4 of its largest value, as ``tests/test_torch_training.py``
holds the mesh-free step); no op of the forward or the backward makes a
tensor of the whole vocabulary; a vocabulary that the model axis does not
divide keeps the gathered path."""

import os

import numpy as np
import pytest
import torch

import _torch_layout_ranks as LR
from _torch_train import assert_grads, batch, configs, port_params, ref_loss_and_grads

import repro_torch.configs as C
from repro_torch.distributed import shardlib as sl
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

MESHES = [(1, 2), (2, 2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        d = tmp_path_factory.mktemp("vocab_parallel")
        params = {}
        for arch in sorted({a for a, _ in LR.VOCAB.values()}):
            params[arch] = str(d / f"{arch}.pt")
            torch.save(port_params(configs(arch)[0]), params[arch])
        out = {}
        for shape in MESHES:
            job = {"vocab": list(LR.VOCAB), "params": params,
                   "out": str(d / "x".join(map(str, shape)))}
            os.makedirs(job["out"])
            out[shape] = (LR.run_mesh(shape, job), job["out"])
        return out
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(LR.VOCAB))
def test_vocab_parallel_loss_matches_the_reference(runs, case, shape):
    """The meshed loss and its gathered gradients against the reference's
    ``jax.value_and_grad``; every rank took the vocab-parallel cross
    entropy once and made no whole-vocabulary tensor."""
    arch, cap = LR.VOCAB[case]
    rcfg, _ = configs(arch, logit_softcap=cap)
    (want_loss, _), want_grads = ref_loss_and_grads(rcfg, batch(rcfg, LR.VOCAB_B, LR.VOCAB_S))
    rows, out = runs[shape]
    got = np.load(os.path.join(out, f"vocab_{case}.npz"))
    np.testing.assert_allclose(got["loss"], np.asarray(want_loss), rtol=1e-5)
    grads = [torch.from_numpy(got[f"g{i}"]) for i in range(len(want_grads))]
    assert_grads(grads, want_grads, rel=1e-4)
    for row in rows:
        res = row[f"vocab {case}"]
        assert res["vocab_nll_calls"] == 1 and res["whole_vocab_ops"] == 0, (row["coords"], res)
        assert abs(res["loss"] - float(want_loss)) <= 1e-5 * abs(float(want_loss))


def test_an_indivisible_vocabulary_stays_gathered():
    """whisper-tiny's 51865 rows and internvl2-2b's 92553 do not divide the
    model axis: their heads stay whole, so ``unembed_local`` returns the
    whole vocabulary (start None) and the loss keeps the gathered path."""
    for arch in ("whisper-tiny", "internvl2-2b"):
        cfg = C.get_config(arch)
        for m in (2, 16):
            mesh = sl.MeshShape({"data": 1, "model": m}, coords={"data": 0, "model": 0})
            rules = M.rules_for(cfg, None, mesh=mesh)
            assert sl.spec_for((cfg.d_model, cfg.vocab), "d", "vocab", mesh=mesh,
                               rules=rules) == (None, None)


def test_next_token_nll_is_the_gathered_loss_without_a_split():
    """Without a split vocabulary (start None) the loss is the plain fp32
    logsumexp minus the label's logit over the unmasked positions."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((2, 5, 11), generator=g)
    labels = torch.randint(0, 11, (2, 5), generator=g)
    labels[0, 1] = -1
    want = torch.nn.functional.cross_entropy(logits[labels >= 0], labels[labels >= 0])
    torch.testing.assert_close(T.next_token_nll(logits, labels), want)
    cfg = C.get_config("tinyllama-1.1b", smoke=True)
    x = torch.randn((2, 5, cfg.d_model), generator=g)
    p = {"tok": torch.randn((cfg.vocab, cfg.d_model), generator=g)}
    y, start = L.unembed_local(cfg, p, x)
    assert start is None and torch.equal(y, L.unembed(cfg, p, x))
