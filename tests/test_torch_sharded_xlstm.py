"""xlstm-350m on a mesh of ranks against the reference's unmeshed engine:
the mLSTM's heads split over the model axis, the sLSTM's state whole on
every rank.

The ranks run as gloo processes on the CPU (``tests/_torch_ranks``), one
torch thread each, on smoke xlstm-350m (mlstm, slstm x 2; d 64, 4 heads:
the mLSTM's 128 up channels are 4 heads of 32, the sLSTM's ``w_up`` 170
columns) on the contiguous cache it serves, over its dense weights and
over the reference's packed quant_sparse plan (blocks of 16,
``tests/_torch_moe.PLAN``).  At 1x2 a rank holds 2 mLSTM heads and one
half of ``w_up``'s columns (all of ``a`` or all of ``b``); at 1x4 one
head, and ``w_up`` (170 columns) stays whole; at 2x2 also its data
replica's rows; at 1x8 (dense) the 4 heads do not split 8 ways while the
128 up channels do, so a rank convolves its 16 channels, gathers them
and runs the recurrence whole.  A rank's greedy streams must equal the reference's
unmeshed engine's bit for bit.  A split contraction (the mLSTM's dense
``w_down``) sums its partial products in another order under the
all-reduce, so a rank's caches -- its heads of the mLSTM's C, n, m, its
channels of the conv state, the sLSTM's whole state -- are held to its
slices of the unsharded port engine's within 1e-5 of the largest entry
after every step, and each step's logits within 1e-5 of the largest."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core import weight_plan as RW
from repro.models.api import get_api as ref_get_api
from repro.serving.config import EngineConfig as REngineConfig
from repro.serving.engine import Request as RRequest
from repro.serving.engine import ServingEngine as RServingEngine

import _torch_moe as TM
import _torch_ranks as R
from repro_torch import interop
from repro_torch.core import weight_plan as WP

ARCH = "xlstm-350m"
CACHE_RTOL = 1e-5
LOGIT_RTOL = 1e-5
FLAT = dict(max_len=64, max_batch=4)


def _prompts() -> list:
    """Five prompts of 6-20 tokens (the mLSTM's chunkwise prefill over
    several chunk lengths); five requests on four slots, so one waits for
    a slot and takes a used slot's fixed-size state."""
    r = np.random.default_rng(1)
    return [r.integers(0, 256, n).astype(np.int32).tolist() for n in (12, 20, 6, 9, 15)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    rcfg = ref_get_config(ARCH, smoke=True)
    rapi = ref_get_api(rcfg)
    rparams = rapi.init_params(rcfg, jax.random.key(0))
    rplan = rapi.compress(rcfg, rparams, RW.PlanConfig(**TM.PLAN))
    prompts = _prompts()
    want = {}
    for name, plan, params in (("quant_sparse", rplan, None), ("none", None, rparams)):
        eng = RServingEngine(rcfg, params, plan=plan, config=REngineConfig.of(**FLAT))
        reqs = [RRequest(uid=i, prompt=np.asarray(p, np.int32), max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_done()
        want[name] = [[int(t) for t in r.output] for r in reqs]
    tmp = tmp_path_factory.mktemp("xlstm")
    plan_dir = str(tmp / "plan")
    WP.save_plan(plan_dir, interop.plan_from_reference(rplan))
    dense = str(tmp / "dense.pt")
    torch.save(interop.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams)),
               dense)
    return want, plan_dir, dense, prompts


# the leaves' cuts on every rank (dense; the packed plan differs where a
# leaf packs)
_DENSE = {
    (1, 2): {"mlstm.w_u": "n_split", "mlstm.w_z": "n_split", "mlstm.w_if": "whole",
             "mlstm.w_down": "k_split", "slstm.w_gates": "n_split", "slstm.w_up": "n_split",
             "slstm.w_down": "whole"},
    (1, 4): {"mlstm.w_u": "n_split", "mlstm.w_z": "n_split", "mlstm.w_if": "whole",
             "mlstm.w_down": "k_split", "slstm.w_gates": "n_split", "slstm.w_up": "whole",
             "slstm.w_down": "whole"},
}
_DENSE[(2, 2)] = _DENSE[(1, 2)]
_DENSE[(1, 8)] = dict(_DENSE[(1, 4)], **{"slstm.w_gates": "n_split"})


@pytest.mark.parametrize("shape,compress", [
    ((1, 2), "none"), ((1, 2), "quant_sparse"), ((1, 4), "none"), ((1, 4), "quant_sparse"),
    ((2, 2), "none"), ((2, 2), "quant_sparse"), ((1, 8), "none")])
def test_meshed_xlstm_equals_the_reference(reference, shape, compress, tmp_path):
    """Each rank projects, convolves and runs its mLSTM heads (4 / M of
    them) and contracts their channels through ``w_down`` (a dense leaf's
    partial sum all-reduced; a packed one stays whole, C1, and gathers the
    channels); it gathers the sLSTM's gate columns once a call, runs the
    recurrence whole with the whole ``r_gates`` (placed whole: C1) and
    gathers ``w_up``'s product columns where they split."""
    want, plan_dir, dense, prompts = reference
    job = dict(arch=ARCH, flat=FLAT, prompts=prompts, max_new=6, out=str(tmp_path),
               rules="rules_for")
    if compress == "none":
        job["params"] = dense
    else:
        job["plan_dir"] = plan_dir
    res = R.run_path(shape, job)
    for r in res:
        assert r["streams"] == want[compress], r["rank"]
        assert r["solo_streams"] == want[compress]
        assert r["cache_err"] <= CACHE_RTOL, r["cache_err"]
        assert r["logit_err"] <= LOGIT_RTOL, r["logit_err"]
        assert r["kinds"]["slstm.r_gates"] == [4, 4, 16, 16]  # whole on every rank
        if compress == "none":
            assert {k: v for k, v in r["kinds"].items() if k != "slstm.r_gates"} == \
                _DENSE[shape]
        else:
            assert r["kinds"]["mlstm.w_u"] == "n_split"
        assert set(r["states"]) == {"FINISHED"} and not r["degraded"]
        assert r["weight_bytes"][0] < r["weight_bytes"][1]
    first = res[0]
    assert all((r["streams"], r["steps"]) == (first["streams"], first["steps"]) for r in res)
