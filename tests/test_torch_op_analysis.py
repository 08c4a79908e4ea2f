"""The port's op analysis (``repro_torch/launch/op_analysis.py``) against the
reference's HLO analysis (``repro/launch/hlo_analysis.py``).

Unit cases: each case of tests/test_hlo_analysis.py that has a torch form,
the same function analyzed by both -- the reference on the jitted JAX
function's optimized HLO, the port on the eager torch function.  Dot FLOPs
and dot bytes are held exactly; the reference's total FLOPs also count the
elementwise ops XLA fuses differently, so its FLOPs here are its dots'
(``H._instr_costs`` patched, test-side, to keep dot and convolution FLOPs
only).

Model cases: decode, prefill and train steps of tinyllama, granite-moe and
recurrentgemma at smoke size on one device, the port's dot FLOPs within 1%
of the reference's (they come out equal).  The reference routes a MoE's
tokens through one-hot dispatch and combine einsums -- dots -- where the
port gathers and scatters; those dots (every dot with a tensor of a
dispatch group's G tokens by a multiple of its capacity C, or by top_k x
experts) are set apart on the reference's side.  The token counts are
chosen so that G and C name no other tensor: 3 sequences at decode (G = C
= 3), 2 x 150 tokens at prefill and train (G 300, C 188)."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as ref_get_config
from repro.launch import hlo_analysis as H
from repro.models.api import get_api as ref_get_api
from repro.training import optimizer as RO
from repro.training.trainer import make_train_step as ref_make_train_step

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.launch import op_analysis as OA
from repro_torch.models.api import get_api
from repro_torch.training import optimizer as O
from repro_torch.training.trainer import make_train_step

S32 = jnp.float32


def _spec(*shape):
    return jax.ShapeDtypeStruct(shape, S32)


def _dot_instr_costs(routing=()):
    """``H._instr_costs`` keeping dot and convolution FLOPs only, and none
    of a dot that touches a MoE routing tensor: a dim of G tokens whose
    other dims multiply to a multiple of the capacity C, or to top_k x
    experts (``routing``: (G, C, K * E) triples)."""
    orig = H._instr_costs

    def is_routing(type_str) -> bool:
        dims = H._dims_of(type_str)
        for G, C, KE in routing:
            if G in dims:
                rest = list(dims)
                rest.remove(G)
                n = math.prod(rest)
                if n % C == 0 or n == KE:
                    return True
        return False

    def costs(ins, comp, is_entry, gte_resolver=None):
        c = orig(ins, comp, is_entry, gte_resolver)
        types = [ins.type_str] + [comp.symbols.get(H._operand_name(o) or "", "")
                                  for o in ins.operands]
        if ins.op not in ("dot", "convolution") or any(map(is_routing, types)):
            c.flops = 0.0
        return c

    return costs


@pytest.fixture
def ref_dots(monkeypatch):
    """analyze(f, *specs, donate=(), routing=()) -> the reference's Costs of
    the jitted ``f`` with dot FLOPs only."""

    def analyze(f, *specs, donate=(), routing=()):
        monkeypatch.setattr(H, "_instr_costs", _dot_instr_costs(routing))
        txt = jax.jit(f, donate_argnums=donate).lower(*specs).compile().as_text()
        return H.analyze(txt)

    return analyze


def _randn(*shape):
    return torch.from_numpy(np.random.default_rng(sum(shape)).normal(size=shape)
                            .astype(np.float32))


# ---------------------------------------------------------------------------
# tests/test_hlo_analysis.py's cases
# ---------------------------------------------------------------------------


def test_loop_matches_scan_and_unroll_flops(ref_dots):
    """A Python loop of ten x @ w is what the reference's scan and its
    unrolled loop both count: 10 x 2 x 128^3, dot bytes equal too."""
    def f_scan(x, w):
        return jax.lax.scan(lambda c, _: (c @ w, None), x, None, length=10)[0]

    def f_unroll(x, w):
        for _ in range(10):
            x = x @ w
        return x

    def port(x, w):
        for _ in range(10):
            x = x @ w
        return x

    _, c, _ = OA.analyze(port, _randn(128, 128), _randn(128, 128))
    assert c.dot_flops == c.flops == 10 * 2 * 128 ** 3
    for f in (f_scan, f_unroll):
        r = ref_dots(f, _spec(128, 128), _spec(128, 128))
        assert c.dot_flops == r.flops
        assert c.bytes_by_cat["dot"] == r.bytes_by_cat["dot"]
    assert c.bytes_by_cat["while_carry"] == 0


def test_nested_loops_multiply(ref_dots):
    def f(x, w):
        def outer(c, _):
            return jax.lax.scan(lambda c2, _: (c2 @ w, None), c, None, length=4)[0], None
        return jax.lax.scan(outer, x, None, length=3)[0]

    def port(x, w):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x

    _, c, _ = OA.analyze(port, _randn(64, 64), _randn(64, 64))
    r = ref_dots(f, _spec(64, 64), _spec(64, 64))
    assert c.dot_flops == r.flops == 12 * 2 * 64 ** 3
    assert c.bytes_by_cat["dot"] == r.bytes_by_cat["dot"]


def test_dot_flops_with_batch_dims(ref_dots):
    _, c, _ = OA.analyze(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                         _randn(4, 32, 64), _randn(4, 64, 16))
    r = ref_dots(lambda a, b: jnp.einsum("bij,bjk->bik", a, b), _spec(4, 32, 64),
                 _spec(4, 64, 16))
    assert c.dot_flops == r.flops == 2 * 4 * 32 * 64 * 16
    assert c.bytes_by_cat["dot"] == r.bytes_by_cat["dot"]


def test_dot_bytes(ref_dots):
    """Operands at their width, the result at most 2 bytes an element."""
    _, c, _ = OA.analyze(lambda a, b: a @ b, _randn(128, 256), _randn(256, 64))
    r = ref_dots(lambda a, b: a @ b, _spec(128, 256), _spec(256, 64))
    assert c.bytes_by_cat["dot"] == r.bytes_by_cat["dot"] \
        == 4 * (128 * 256 + 256 * 64) + 2 * 128 * 64


def test_entry_output_counted_inputs_not(ref_dots):
    _, c, _ = OA.analyze(lambda x: x * 2.0, _randn(1024))
    r = ref_dots(lambda x: x * 2.0, _spec(1024))
    assert c.bytes_by_cat["entry_io"] == r.bytes_by_cat["entry_io"] == 4096


def test_donated_output_not_counted(ref_dots):
    """The reference donates the buffer; the port updates it in place and
    names it donated."""
    _, c, _ = OA.analyze(lambda x: x.mul_(2.0), _randn(1024), donate=(0,))
    r = ref_dots(lambda x: x * 2.0, _spec(1024), donate=(0,))
    assert c.bytes_by_cat["entry_io"] == r.bytes_by_cat["entry_io"] == 0


def test_elementwise_assumed_fused(ref_dots):
    _, c, _ = OA.analyze(lambda x: torch.tanh(x) * 2 + 1, _randn(4096))
    r = ref_dots(lambda x: jnp.tanh(x) * 2 + 1, _spec(4096))
    assert c.bytes_by_cat["dot"] == r.bytes_by_cat["dot"] == 0
    assert c.bytes == c.bytes_by_cat["entry_io"] == r.bytes_by_cat["entry_io"]
    assert c.flops == 3 * 4096  # tanh, *, + each charged |result|


def test_reduce_bytes_operands_plus_result(ref_dots):
    """A reduction costs its operand elements and moves operands plus
    result.  (The reference's XLA:CPU module wraps this reduce in loop
    fusions, which its model charges as elementwise: only the entry bytes
    compare.)"""
    _, c, _ = OA.analyze(lambda x: x.sum(-1), _randn(64, 128))
    r = ref_dots(lambda x: jnp.sum(x, axis=-1), _spec(64, 128))
    assert c.flops == 64 * 128
    assert c.bytes_by_cat["reduce"] == 4 * (64 * 128 + 64)
    assert c.bytes_by_cat["entry_io"] == r.bytes_by_cat["entry_io"] == 256


def test_copies_and_cache_updates():
    """cat / clone: 2x the result; an in-place write into a slot: 2x the
    update; views free."""
    cache, new = _randn(4, 16, 8), _randn(4, 1, 8)

    def step(cache, new):
        cache[:, 3:4] = new  # a slot of the cache
        return torch.cat([new, new], dim=1).transpose(0, 1)

    _, c, _ = OA.analyze(step, cache, new, donate=(0,))
    assert c.bytes_by_cat["cache_update"] == 2 * new.numel() * 4
    assert c.bytes_by_cat["copy"] == 2 * 2 * new.numel() * 4
    assert c.flops == 0


@pytest.fixture
def fake_group():
    """A fake process group of 4 ranks (this process rank 0) with a 2 x 2
    (data, model) DeviceMesh: the collectives dispatch and send nothing."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_collective_detection(fake_group):
    """The reference's case: one all-reduce of f32[64] is 256 bytes, one
    count; shardlib's gather charges its result, and the autograd
    Functions' backward collectives are charged where the backward runs."""
    from repro_torch.distributed import shardlib as sl

    x = _randn(64)
    _, c, _ = OA.analyze(lambda t: dist.all_reduce(t), x)
    assert c.collective_bytes["all-reduce"] == 256
    assert c.collective_counts["all-reduce"] == 1
    assert c.bytes_by_cat["collective"] == c.total_collective_bytes == 256

    def gathered(t):
        with sl.use_mesh(fake_group):
            return sl.all_gather(t, "model", dim=0), sl.all_reduce(t, "data")

    _, c, _ = OA.analyze(gathered, _randn(16, 8))
    assert c.collective_bytes == {"all-gather": 2 * 16 * 8 * 4, "all-reduce": 16 * 8 * 4,
                                  "reduce-scatter": 0.0, "all-to-all": 0.0,
                                  "collective-permute": 0.0}

    w = _randn(8, 4).requires_grad_(True)

    def tp(x):  # Megatron's f: identity forward, an all-reduce in the backward
        with sl.use_mesh(fake_group):
            y = sl.fan_out(x) @ w
            return torch.autograd.grad(y.sum(), [x])[0]

    _, c, _ = OA.analyze(tp, _randn(16, 8).requires_grad_(True))
    assert c.collective_counts["all-reduce"] == 1
    assert c.collective_bytes["all-reduce"] == 16 * 8 * 4
    assert c.dot_flops == 2 * (2 * 16 * 8 * 4)  # forward and the dx product


def test_memory_peak_of_live_temporaries():
    """Arguments once; a temporary counts while it lives: x @ w (64 KB),
    then tanh of it (64 KB) while the product is alive, then the sum."""
    x, w = _randn(128, 64), _randn(64, 128)
    _, _, m = OA.analyze(lambda a, b: torch.tanh(a @ b).sum(), x, w)
    assert m.argument_bytes == 2 * 128 * 64 * 4
    assert m.temp_bytes == 2 * 128 * 128 * 4
    assert m.output_bytes == 4


# ---------------------------------------------------------------------------
# model steps: the port's dot FLOPs against the reference's
# ---------------------------------------------------------------------------

MODEL_ARCHS = ["tinyllama-1.1b", "granite-moe-1b-a400m", "recurrentgemma-2b"]
DECODE_B, B, S, CACHE = 3, 2, 150, 160


@functools.lru_cache(maxsize=None)
def _models(arch):
    rcfg, cfg = ref_get_config(arch, smoke=True), get_config(arch, smoke=True)
    rparams = ref_get_api(rcfg).init_params(rcfg, jax.random.key(0))
    tparams = interop.params_from_reference(jax.tree_util.tree_map(np.asarray, rparams))
    return rcfg, rparams, cfg, tparams


def _routing(rcfg) -> tuple:
    """(G, C, K * E) of the reference's dispatch groups at the decode batch
    and at B x S tokens (``repro/models/moe.py``'s group size and capacity)."""
    m = rcfg.moe
    if m is None:
        return ()
    out = []
    for T in (DECODE_B, B * S):
        G = min(T, 512)
        while T % G:
            G -= 1
        C = G if T <= 256 else max(1, math.ceil(G * m.top_k / m.n_experts * m.capacity_factor))
        out.append((G, C, m.top_k * m.n_experts_padded))
    return tuple(out)


def _tokens(b, s):
    return np.random.default_rng(b * s).integers(0, 256, (b, s)).astype(np.int32)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
@pytest.mark.parametrize("kind", ["decode", "prefill", "train"])
def test_step_dot_flops_match_reference(ref_dots, arch, kind):
    rcfg, rparams, cfg, tparams = _models(arch)
    rapi, api = ref_get_api(rcfg), get_api(cfg)
    routing = _routing(rcfg)
    if kind == "decode":
        tok, pos = _tokens(DECODE_B, 1), np.full((DECODE_B,), 7, np.int32)
        r = ref_dots(functools.partial(rapi.decode_step, rcfg), rparams,
                     rapi.init_cache(rcfg, DECODE_B, CACHE, S32), jnp.asarray(tok),
                     jnp.asarray(pos), routing=routing)
        _, c, _ = OA.analyze(functools.partial(api.decode_step, cfg), api.unstack(cfg, tparams),
                             api.init_cache(cfg, DECODE_B, CACHE, torch.float32),
                             torch.from_numpy(tok), torch.from_numpy(pos), donate=(1,))
    elif kind == "prefill":
        tok = _tokens(B, S)
        r = ref_dots(functools.partial(rapi.prefill, rcfg), rparams,
                     {"tokens": jnp.asarray(tok)}, rapi.init_cache(rcfg, B, CACHE, S32),
                     routing=routing)
        _, c, _ = OA.analyze(functools.partial(api.prefill, cfg), api.unstack(cfg, tparams),
                             {"tokens": torch.from_numpy(tok)},
                             api.init_cache(cfg, B, CACHE, torch.float32), donate=(2,))
    else:
        tok = _tokens(B, S)
        oc = RO.OptimizerConfig()
        r = ref_dots(ref_make_train_step(rcfg, rapi.loss_fn, oc), rparams,
                     RO.init_opt_state(oc, rparams),
                     {"tokens": jnp.asarray(tok), "labels": jnp.asarray(tok)}, routing=routing)
        poc = O.OptimizerConfig()
        _, c, _ = OA.analyze(make_train_step(cfg, api.loss_fn, poc), tparams,
                             O.init_opt_state(poc, tparams),
                             {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(tok)},
                             donate=(0, 1))
    assert r.flops > 0
    assert c.dot_flops == pytest.approx(r.flops, rel=1e-2)


@pytest.mark.parametrize("arch,S", [("tinyllama-1.1b", 1100), ("xlstm-350m", 64)])
def test_repeated_loop_bodies_replay_their_exact_costs(arch, S):
    """Prefills analyzed with and without the replay of the dry run's
    repeated loop bodies (``dryrun.REPEATED``): tinyllama at 1100 tokens
    (past the dense threshold: the chunked flash's ``flash_rows``) and
    xlstm (the sLSTM's ``slstm_step``, once a token): the same costs and
    the same memory."""
    from repro_torch.launch import dryrun as D

    cfg = get_config(arch, smoke=True)
    api = get_api(cfg)
    params = api.unstack(cfg, api.init_params(cfg, 0, device="cpu"))
    tok = torch.from_numpy(_tokens(1, S))

    def run(repeated):
        with torch.no_grad():
            return OA.analyze(functools.partial(api.prefill, cfg), params, {"tokens": tok},
                              api.init_cache(cfg, 1, S, torch.float32), donate=(2,),
                              repeated=repeated)[1:]

    full, replayed = run(()), run(D.REPEATED)
    assert replayed == full
    assert full[0].flops > 0 and full[1].temp_bytes > 0

