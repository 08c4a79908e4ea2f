"""Shared set-up of the MoE parity tests (tests/test_torch_moe.py,
test_torch_moe_serving.py): both MoE smoke configs and a qwen2-moe variant
whose 6 experts are padded to 8, the reference's params and packed plans
carried into the port by ``interop``, and both engines over the same plan
(the pattern of tests/_torch_families.py).

The plan packs the smoke expert stacks: blocks of 16 and a ``min_size`` /
``min_contract`` low enough for a (2, E, 32, 64) down-projection stack (at
the defaults, 16384 and 64, it would stay dense).  Both packages get the
same PlanConfig."""

import dataclasses
import functools

import jax
import numpy as np

from repro.configs import get_config as ref_get_config
from repro.core import weight_plan as RW
from repro.models.api import get_api as ref_get_api
from repro.serving import config as RC
from repro.serving.engine import ServingEngine as RServingEngine

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.serving import config as PC
from repro_torch.serving.engine import ServingEngine

ARCHS = ("granite-moe-1b-a400m", "qwen2-moe-a2.7b")
PADDED = "qwen2-moe-pad8"
VARIANTS = ARCHS + (PADDED,)
PLAN = dict(default="quant_sparse", q_prune=0.5, bk=16, bn=16, min_size=1024, min_contract=16)


def configs(variant: str) -> tuple:
    """(reference config, port config) of a smoke variant."""
    arch = "qwen2-moe-a2.7b" if variant == PADDED else variant
    rcfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    if variant == PADDED:
        rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(rcfg.moe, pad_to=8))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, pad_to=8))
    return rcfg, cfg


@functools.lru_cache(maxsize=None)
def ref_model(variant: str, compress: str = "none", seed: int = 0):
    rcfg, _ = configs(variant)
    params = ref_get_api(rcfg).init_params(rcfg, jax.random.key(seed))
    plan = None
    if compress != "none":
        plan = RW.compress(params, RW.PlanConfig(**dict(PLAN, default=compress)))
        params = plan.params
    return rcfg, params, plan


def port_params(variant: str, compress: str = "none", seed: int = 0):
    _, params, _ = ref_model(variant, compress, seed)
    return interop.params_from_reference(jax.tree_util.tree_map(np.asarray, params))


def prompts(seed: int = 0) -> list:
    """Prompt 0 of 20 tokens, which 1 and 2 extend by 4 (one full page of 16
    mapped by refcount, the boundary page copied); 3 and 4 stand alone at
    24.  Two lengths keep the reference's jitted prefill to two compiles."""
    r = np.random.default_rng(seed)
    prefix = r.integers(0, 256, 20).astype(np.int32)
    out = [prefix] + [np.concatenate([prefix, r.integers(0, 256, 4).astype(np.int32)])
                      for _ in range(2)]
    return out + [r.integers(0, 256, 24).astype(np.int32) for _ in range(2)]


def engines(variant: str, *, spec_k: int = 0, max_len: int = 64, max_batch: int = 5, **flat):
    """(reference engine, port engine on the CPU) over the reference's packed
    quant_sparse plan; ``spec_k`` > 0 drafts with the target's own dense
    weights (self-draft)."""
    rcfg, _, rplan = ref_model(variant, "quant_sparse")
    _, cfg = configs(variant)
    rspec, pspec = RC.SpecConfig(), PC.SpecConfig()
    if spec_k:
        rspec = RC.SpecConfig(draft_cfg=rcfg, draft_params=ref_model(variant)[1], spec_k=spec_k)
        pspec = PC.SpecConfig(draft_cfg=cfg, draft_params=port_params(variant), spec_k=spec_k)
    rconf = RC.EngineConfig.of(max_len=max_len, max_batch=max_batch, spec=rspec, **flat)
    pconf = PC.EngineConfig.of(max_len=max_len, max_batch=max_batch, spec=pspec, **flat)
    ref = RServingEngine(rcfg, rplan.params, plan=rplan, config=rconf)
    eng = ServingEngine(cfg, None, plan=interop.plan_from_reference(rplan), device="cpu",
                        config=pconf)
    return ref, eng
