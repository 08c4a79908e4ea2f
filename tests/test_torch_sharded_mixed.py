"""Mixed-family serving on a mesh of ranks against the reference's
unmeshed ``MixedServingEngine``: every rank runs one mixed engine whose
members carry the mesh (each with its ``rules_for``) over one shared page
allocator.

The ranks run as gloo processes on the CPU (``tests/_torch_ranks``), one
torch thread each, on the CLI's mix (tinyllama-1.1b:2, recurrentgemma-2b:1,
whisper-tiny:1, smoke, fp32, dense weights, pages of 16: tinyllama and
whisper draw from the shared pool, recurrentgemma keeps its contiguous
rings).  Each member's greedy streams must equal the reference's mixed
engine's bit for bit; after every tick each member's caches are held to
their slices of the unmeshed port mix's within 1e-5 of the largest entry,
the union audit runs on every rank, and the shared allocator's free list
equals the unmeshed mix's (so it is the same on every rank)."""

import warnings

import numpy as np
import pytest
import torch

import _torch_families as F
import _torch_ranks as R
from repro.serving import config as RC
from repro.serving import mixed as RM
from repro.serving.engine import Request as RRequest

from repro_torch.configs import get_config

CACHE_RTOL = 1e-5
MIX = (("tinyllama-1.1b", 4), ("recurrentgemma-2b", 2), ("whisper-tiny", 2))
FLAT = dict(max_len=32, max_batch=2, page_size=16)


def _requests() -> list:
    """(arch, uid, prompt, extras): each family's requests, prompts of 5-8
    tokens, whisper's frames drawn after each prompt."""
    rng = np.random.default_rng(3)
    out = []
    for arch, n in MIX:
        cfg = get_config(arch, smoke=True)
        for i in range(n):
            prompt = rng.integers(1, cfg.vocab, size=5 + i).astype(np.int32).tolist()
            extras = None
            if cfg.family == "audio":
                extras = {"frames": rng.normal(size=(cfg.n_frames, cfg.d_model))
                          .astype(np.float32)}
            out.append((arch, len(out), prompt, extras))
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """(the reference mix's streams {arch: [tokens]}, [(arch, saved dense
    params)])."""
    tmp = tmp_path_factory.mktemp("mix")
    members, specs = [], []
    for arch, _ in MIX:
        rcfg, rparams, _ = F.ref_model(arch, "none", 0)
        specs.append(RM.WorkloadSpec(name=arch, cfg=rcfg, params=rparams,
                                     config=RC.EngineConfig.of(**FLAT)))
        path = str(tmp / f"{arch}.pt")
        torch.save(F.port_params(arch, "none", 0), path)
        members.append((arch, path))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = RM.MixedServingEngine(specs)
    reqs = []
    for arch, uid, prompt, extras in _requests():
        r = RRequest(uid=uid, prompt=np.asarray(prompt, np.int32), max_new_tokens=5,
                     extras=extras)
        reqs.append((arch, r))
        ref.submit(arch, r)
    ref.run_until_done()
    ref.audit_pages()
    want = {}
    for arch, r in reqs:
        want.setdefault(arch, []).append([int(t) for t in r.output])
    return want, members


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_meshed_mix_equals_the_reference_mix(reference, shape, tmp_path):
    want, members = reference
    res = R.run_mixed(shape, dict(members=members, flat=FLAT, requests=_requests(), max_new=5,
                                  out=str(tmp_path)))
    D, M = shape
    for r in res:
        assert r["streams"] == want, r["rank"]
        assert r["solo_streams"] == want
        assert r["cache_err"] <= CACHE_RTOL, r["cache_err"]
        assert None not in r["frees"]  # equal to the unmeshed mix's every tick
        assert r["paged"] == ["tinyllama-1.1b", "whisper-tiny"] and r["used_pages"] == 0
        # each member by its own degrees: tinyllama's 2 KV heads and
        # whisper's 6 split over 2; recurrentgemma's one does not
        assert r["degrees"] == {"tinyllama-1.1b": [D, M, 2], "recurrentgemma-2b": [D, M, 1],
                                "whisper-tiny": [D, M, 2]}
        assert all(mine < whole for mine, whole in r["weight_bytes"].values())
    first = res[0]
    assert all((r["frees"], r["ticks"]) == (first["frees"], first["ticks"]) for r in res)
