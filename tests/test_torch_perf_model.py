"""PyTorch port vs the JAX reference: the decode roofline model and the
batch sizer (pure float arithmetic, so equal to the last bit).  The port's
defaults are the H100 data-sheet constants; the reference is handed the
same constants explicitly."""

import math

import pytest

from repro.core import batching as RB
from repro.core import perf_model as RP

from repro_torch.core import batching as TB
from repro_torch.core import perf_model as TP

H100 = dict(peak_flops=989e12, hbm_bw=3.35e12)


def test_h100_constants():
    assert TP.H100_PEAK_FLOPS == 989e12 and TP.H100_HBM_BW == 3.35e12


@pytest.mark.parametrize("q_prune,kv,ctx,sparse", [
    (0.0, 0.0, 0, True), (0.5, 0.0, 0, False), (0.5, 11968.0, 48, True),
    (0.44, 11968.0, 128, True), (0.0, 5e6, 4096, True)])
def test_decode_n_opt_and_step_time_match(q_prune, kv, ctx, sparse):
    kw = dict(b_weight=1.0, q_prune=q_prune, q_overhead=1.003, sparse_compute=sparse,
              n_params=1_100_048_384, kv_bytes_per_token=kv, context_len=ctx)
    got = TP.decode_n_opt(**kw)
    want = RP.decode_n_opt(**H100, **kw)
    assert got == want or (math.isinf(got) and math.isinf(want))
    for batch in (1, 8, 64):
        t = TP.decode_step_time(1_100_048_384, batch, kv, ctx, b_weight=1.0,
                                q_prune=q_prune, sparse_compute=sparse)
        r = RP.decode_step_time(1_100_048_384, batch, kv, ctx, b_weight=1.0,
                                q_prune=q_prune, sparse_compute=sparse, **H100)
        assert t == r


@pytest.mark.parametrize("ctx,ps", [(1, 16), (16, 16), (17, 16), (56, 8)])
def test_pages_match(ctx, ps):
    assert TP.pages_for_context(ctx, ps) == RP.pages_for_context(ctx, ps)
    assert TP.paged_pool_pages(8, ctx + 0.5, ps) == RP.paged_pool_pages(8, ctx + 0.5, ps)
    assert TB.mean_decode_context(ctx, 16) == RB.mean_decode_context(ctx, 16)


def test_batch_sizer_matches():
    kw = dict(n_params=1_100_048_384, b_weight=1.0, q_prune=0.44, q_overhead=1.003,
              kv_bytes_per_token=11968.0, context_len=48)
    assert TB.BatchSizer(**kw).n_opt == RB.BatchSizer(**H100, **kw).n_opt
    big = dict(kw, kv_bytes_per_token=1e9)
    assert TB.BatchSizer(**big).n_opt == TB.UNBOUNDED_NOPT == RB.BatchSizer(**H100, **big).n_opt
