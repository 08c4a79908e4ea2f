"""Shared set-up of the enc-dec and VLM parity tests
(tests/test_torch_encdec.py, test_torch_vlm.py,
test_torch_encdec_serving.py): whisper-tiny and internvl2-2b at their smoke
configs (fp32), the reference's params and packed plans carried into the
port by ``interop``, the requests' frames and patches drawn with numpy, and
both engines over the same plan (the pattern of tests/_torch_moe.py).

The plan packs the smoke leaves: blocks of 16 and a ``min_size`` /
``min_contract`` low enough for whisper-smoke's 48 x 96 MLP (at the
defaults, 16384 and 64, every smoke projection would stay dense).  Both
packages get the same PlanConfig."""

import functools

import jax
import numpy as np

from repro.configs import get_config as ref_get_config
from repro.core import weight_plan as RW
from repro.models.api import get_api as ref_get_api
from repro.serving import config as RC
from repro.serving.engine import Request as RRequest
from repro.serving.engine import ServingEngine as RServingEngine

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.serving import config as PC
from repro_torch.serving.engine import Request, RequestState, ServingEngine

WHISPER, INTERNVL = "whisper-tiny", "internvl2-2b"
ARCHS = (WHISPER, INTERNVL)
PLAN = dict(default="quant_sparse", q_prune=0.5, bk=16, bn=16, min_size=1024, min_contract=16)
TOL = dict(rtol=1e-5, atol=1e-5)
# the quickstart flags the serving tests take (--kv-dtype int8 --page-size 16
# --share-prefix): the enc-dec warns and serves fp, both warn and share nothing
QUICKSTART = dict(kv_dtype="int8", page_size=16, share_prefix=True)


@functools.lru_cache(maxsize=None)
def ref_model(arch: str, compress: str = "none", seed: int = 0):
    """(reference cfg, params, plan) of the smoke config."""
    rcfg = ref_get_config(arch, smoke=True)
    params = ref_get_api(rcfg).init_params(rcfg, jax.random.key(seed))
    plan = None
    if compress != "none":
        plan = RW.compress(params, RW.PlanConfig(**dict(PLAN, default=compress)))
        params = plan.params
    return rcfg, params, plan


def port_params(arch: str, compress: str = "none", seed: int = 0):
    _, params, _ = ref_model(arch, compress, seed)
    return interop.params_from_reference(jax.tree_util.tree_map(np.asarray, params))


def extras(cfg, n: int, seed: int) -> list:
    """``n`` requests' frontend-stub inputs (float32 normals): whisper's
    frames (n_frames, d), internvl's patches (n_patches, d)."""
    r = np.random.default_rng(seed)
    if cfg.family == "audio":
        return [{"frames": r.normal(size=(cfg.n_frames, cfg.d_model)).astype(np.float32)}
                for _ in range(n)]
    return [{"patches": r.normal(size=(cfg.n_patches, cfg.d_model)).astype(np.float32)}
            for _ in range(n)]


def batch_extra(cfg, B: int, seed: int) -> np.ndarray:
    """A (B, n, d) batch of frames or patches."""
    return np.stack([next(iter(e.values())) for e in extras(cfg, B, seed)])


def prompts(seed: int = 0) -> list:
    """Prompt 0 of 20 tokens, which 1 and 2 extend by 4 (equal token
    prefixes that must NOT share pages: the requests' frames or patches
    differ); 3 and 4 stand alone at 24."""
    r = np.random.default_rng(seed)
    prefix = r.integers(0, 256, 20).astype(np.int32)
    out = [prefix] + [np.concatenate([prefix, r.integers(0, 256, 4).astype(np.int32)])
                      for _ in range(2)]
    return out + [r.integers(0, 256, 24).astype(np.int32) for _ in range(2)]


def engine_configs(max_len: int = 64, max_batch: int = 5, **flat) -> tuple:
    return (RC.EngineConfig.of(max_len=max_len, max_batch=max_batch, **flat),
            PC.EngineConfig.of(max_len=max_len, max_batch=max_batch, **flat))


def engines(arch: str, *, max_len: int = 64, max_batch: int = 5, **flat):
    """(reference engine, port engine on the CPU) over the reference's packed
    quant_sparse plan."""
    rcfg, _, rplan = ref_model(arch, "quant_sparse")
    rconf, pconf = engine_configs(max_len, max_batch, **flat)
    ref = RServingEngine(rcfg, rplan.params, plan=rplan, config=rconf)
    eng = ServingEngine(get_config(arch, smoke=True), None,
                        plan=interop.plan_from_reference(rplan), device="cpu", config=pconf)
    return ref, eng


def request_pair(arch: str, ps, max_new: int, seed: int = 1) -> tuple:
    """The same requests, with the same frames or patches, for both."""
    ex = extras(get_config(arch, smoke=True), len(ps), seed)
    return ([RRequest(uid=i, prompt=p.copy(), max_new_tokens=max_new, extras=e)
             for i, (p, e) in enumerate(zip(ps, ex))],
            [Request(uid=i, prompt=p.copy(), max_new_tokens=max_new, extras=e)
             for i, (p, e) in enumerate(zip(ps, ex))])


def serve_both(ref, eng, rreqs, reqs, *, check=None, max_ticks: int = 500):
    """Tick both engines together until the reference is done, holding the
    page tables, slot -> page maps and (enc-dec) frame tables equal every
    tick; ``check(ref, eng)`` runs after every tick.  Every request must
    finish with the reference's tokens, and no page may stay in use."""
    for rr, tr in zip(rreqs, reqs):
        ref.submit(rr)
        eng.submit(tr)
    for _ in range(max_ticks):
        if not ref.queue and not ref._live_slots():
            break
        ref.step()
        eng.step()
        if eng.paged:
            np.testing.assert_array_equal(eng._table, ref._table)
            assert eng.slot_pages == ref.slot_pages
            if ref.slot_xpages is not None:
                np.testing.assert_array_equal(eng._xtable, ref._xtable)
                assert eng.slot_xpages == ref.slot_xpages
        if check is not None:
            check(ref, eng)
    assert not eng.queue and not eng._live_slots()
    for tr, rr in zip(reqs, rreqs):
        assert tr.state is RequestState.FINISHED
        assert tr.output == rr.output, tr.uid
    if eng.paged:
        eng.audit_pages()
        assert eng.pages_in_use == 0
