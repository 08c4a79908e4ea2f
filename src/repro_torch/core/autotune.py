"""Offline plan autotuner (port of ``repro/core/autotune.py``): search the
compression and serving design space.

The paper picks its pruning rate and batch size by hand against a fixed
accuracy budget (<=1.5% drop, Section 6.4).  This module closes the loop:
candidates are scored with the port's own timing model and the winner
ships as a plan artifact that the serving engine loads.

    objective    modeled committed tokens/s from the two-term roofline
                 (perf_model.decode_step_time / spec_decode_n_opt with
                 single-pass KV accounting), at the candidate's feasible
                 batch, with the H100 data-sheet constants by default
                 (``perf_model.HARDWARE_LABEL``; not measurements).
    constraint   the paper's accuracy budget, evaluated with
                 ``pruning.iterative_prune`` on a seeded calibration task --
                 lazily: the perf model screens every candidate, and the
                 trainer runs only when a candidate would become the
                 incumbent best, at most once per distinct sparsity level.
    ceilings     KV pool bytes per card (perf_model.paged_pool_pages) and
                 the shared memory one CTA of the block-sparse kernels
                 (B1, B2, B4) needs at the candidate's block edge.

Search knobs (one ``Candidate``): per-leaf-group (kind, q_prune), block
size, kv_dtype, page size, spec_k and the (data, model) mesh, which
``predict`` charges as the reference does: the weight stream and the MACs
over the model axis, the KV stream and the pool over the degree the KV
heads split by, the batch over the data replicas.  Two strategies behind one
``search()``: a seeded random sweep and simulated annealing with per-knob
neighbourhood moves, both seeded by ``np.random.default_rng(seed)`` and
drawing as the reference's do, so that equal inputs give the reference's
trace trial for trial.  Both seed trial 0 with the uniform-default
candidate, so the winner is >= uniform on modeled tokens/s.

The ``TunedPlan`` artifact (JSON, schema 1) carries the winning per-leaf
assignments as 3-tuple ``PlanConfig.rules``; its keys are the reference's,
so either package reads the other's file.  The port does not read the
file's ``use_kernel``: its plan runs the kernels on the card, where the
reference's False would run the plain versions.

Plan stats are predicted from parameter shapes alone (``api.param_shapes``,
nothing allocated); ``tests/test_torch_autotune.py`` holds them to
``compress()`` exactly.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import perf_model as pm
from repro_torch.core import weight_plan as WP
from repro_torch.core.batching import BatchSizer, mean_decode_context
from repro_torch.device import resolve_device
from repro_torch.kernels.block_sparse import DECODE_MAX_M

TUNED_SCHEMA_VERSION = 1

SPARSE_KINDS = ("block_sparse", "quant_sparse")

# the shared memory one CTA may have on the H100: 227 KB, the bound that
# csrc/wgmma_column.cuh's Geometry static_asserts
H100_SMEM_BYTES = 232448


# ---------------------------------------------------------------------------
# design space + constraint ceilings
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Knob values the tuner may assign.

    The FIRST element of every tuple is the uniform default -- the candidate
    every search seeds trial 0 with.  Ordered knobs (q_prunes, blocks,
    page_sizes, spec_ks) are listed monotonically: the annealer's moves
    step to adjacent values.  ``meshes`` lists (data, model) degrees; the
    CLI searches one card, and a caller reaches meshes through this field
    (a served artifact takes its mesh from the caller, as the reference's
    does)."""

    q_prunes: tuple = (0.0, 0.25, 0.5, 0.75)
    kinds: tuple = ("quant_sparse", "block_sparse", "quant", "dense")
    blocks: tuple = (128,)  # bk == bn; the kernels take 128 only
    kv_dtypes: tuple = ("fp", "int8")
    page_sizes: tuple = (0, 16)  # 0 = contiguous per-slot cache
    spec_ks: tuple = (0,)
    meshes: tuple = ((1, 1),)  # (data, model) parallel degrees
    # plan eligibility floor + packing options, forwarded to PlanConfig
    min_size: int = 16384
    min_contract: int = 64
    score: str = "l1"
    # speculative-decode prior (spec_ks beyond 0 need a draft model)
    spec_accept: float = 0.8
    draft_n_params: int = 0

    def __post_init__(self):
        for k in self.kinds:
            if k not in WP.REPRS:
                raise ValueError(f"unknown representation {k!r} in kinds")
        for q in self.q_prunes:
            if not 0.0 <= q < 1.0:
                raise ValueError(f"q_prune values must be in [0, 1), got {q}")
        if any(b < 1 for b in self.blocks):
            raise ValueError("block sizes must be >= 1")
        if any(p < 0 for p in self.page_sizes):
            raise ValueError("page sizes must be >= 0 (0 = contiguous)")
        if any(k < 0 for k in self.spec_ks):
            raise ValueError("spec_k values must be >= 0")


@dataclasses.dataclass(frozen=True)
class Constraints:
    """Hardware ceilings + workload the candidates are evaluated against
    (the H100 data sheet's rates, not measurements)."""

    max_acc_drop: float = 0.015  # the paper's Section 6.4 budget
    pool_bytes: float = 16e9  # KV cache budget per card
    smem_bytes: float = H100_SMEM_BYTES  # one CTA's shared memory
    max_batch: int = 256
    max_len: int = 256
    prompt_len: int = 32
    max_new: int = 64
    peak_flops: float = pm.H100_PEAK_FLOPS
    hbm_bw: float = pm.H100_HBM_BW

    def __post_init__(self):
        if self.prompt_len + self.max_new > self.max_len:
            raise ValueError(
                f"prompt_len + max_new = {self.prompt_len + self.max_new} "
                f"exceeds max_len = {self.max_len}")


# ---------------------------------------------------------------------------
# model inventory (shapes only -- no parameter allocation)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LeafInfo:
    path: str
    name: str
    shape: tuple  # full stacked shape
    lead: int  # product of leading (stacking) dims
    size: int


def _shape_leaves(tree, path: str, out: list) -> None:
    """The (shape, init) leaves of a ``param_shapes`` tree in the order jax
    flattens the reference's params: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _shape_leaves(tree[k], f"{path}/{k}" if path else str(k), out)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            _shape_leaves(v, f"{path}/{i}" if path else str(i), out)
    else:
        shp = tuple(int(d) for d in tree[0])
        lead = int(np.prod(shp[:-2])) if len(shp) > 2 else 1
        out.append(LeafInfo(path, path.rsplit("/", 1)[-1], shp, lead,
                            int(np.prod(shp)) if shp else 1))


def model_leaves(cfg) -> tuple:
    """Every tensor leaf of ``api.init_params`` as a LeafInfo, from the
    family's ``param_shapes``: paths and names as ``compress()`` reports
    them, nothing allocated."""
    from repro_torch.models import api as MA

    out: list = []
    _shape_leaves(MA.get_api(cfg).param_shapes(cfg), "", out)
    return tuple(out)


def _quant_ok(leaf: LeafInfo, space: SearchSpace) -> bool:
    return (
        len(leaf.shape) >= 2
        and leaf.size >= space.min_size
        and leaf.shape[-2] >= space.min_contract
        and (leaf.name.startswith("w") or leaf.name in WP.QUANT_KEYS)
    )


def _sparse_ok(leaf: LeafInfo, space: SearchSpace, block: int) -> bool:
    if not (_quant_ok(leaf, space) and leaf.name.startswith("w")):
        return False
    K, N = leaf.shape[-2], leaf.shape[-1]
    return K % block == 0 and N % block == 0 and K >= block and N >= block


def tunable_groups(cfg, space: SearchSpace) -> tuple:
    """Leaf-NAME groups the tuner assigns (kind, q_prune) to -- every leaf
    that could take a non-dense representation.  Layers sharing a
    projection share its assignment, as ``PlanConfig.rules`` match paths by
    substring."""
    return tuple(sorted({l.name for l in model_leaves(cfg) if _quant_ok(l, space)}))


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One point in the design space."""

    assign: tuple  # ((group_name, kind, q_prune), ...) sorted by name
    block: int
    kv_dtype: str  # "fp" | "int8"
    page_size: int  # 0 = contiguous
    spec_k: int
    mesh: tuple  # (data, model)


def uniform_candidate(cfg, space: SearchSpace) -> Candidate:
    """The uniform-default baseline: every knob at its first space value."""
    return Candidate(
        assign=tuple((g, space.kinds[0], space.q_prunes[0])
                     for g in tunable_groups(cfg, space)),
        block=space.blocks[0],
        kv_dtype=space.kv_dtypes[0],
        page_size=space.page_sizes[0],
        spec_k=space.spec_ks[0],
        mesh=space.meshes[0],
    )


def candidate_plan_config(cand: Candidate, space: SearchSpace) -> WP.PlanConfig:
    """The PlanConfig that materializes this candidate's weight plan:
    per-group assignments as 3-tuple rules, longest name first so that
    substring matching picks the most specific group; everything unmatched
    stays dense.  Its nodes run the CUDA kernels on the card
    (``use_kernel``; ``weight_plan.with_use_kernel`` switches a tree to the
    plain versions)."""
    rules = tuple(sorted(cand.assign, key=lambda r: (-len(r[0]), r[0])))
    return WP.PlanConfig(
        default="dense", rules=rules, q_prune=0.0, bk=cand.block, bn=cand.block,
        score=space.score, min_size=space.min_size, min_contract=space.min_contract)


def normalize_space(cfg, space: SearchSpace) -> SearchSpace:
    """Drop knob values this model family cannot serve (int8 KV, paged KV,
    speculative decode), mirroring the engine's own gates, so that the
    tuner never scores a datapath the engine would fall back from."""
    from repro_torch.models import api as MA

    kv = space.kv_dtypes
    if "int8" in kv and not MA.supports_int8_kv(cfg):
        kv = tuple(k for k in kv if k != "int8") or ("fp",)
    pages = space.page_sizes
    if any(p > 0 for p in pages) and not MA.supports_paged_kv(cfg):
        pages = (0,)
    specs = space.spec_ks
    if any(k > 0 for k in specs) and (
            space.draft_n_params <= 0 or not MA.supports_spec_decode(cfg)):
        specs = tuple(k for k in specs if k == 0) or (0,)
    return dataclasses.replace(space, kv_dtypes=kv, page_sizes=pages, spec_ks=specs)


# ---------------------------------------------------------------------------
# analytic plan-stat prediction (mirrors weight_plan._leaf_stats)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PlanStats:
    """Aggregate weight-stream stats of a candidate plan, computed without
    packing: the quantities WeightPlan derives from its packed leaves."""

    n_weights: int
    surviving: int
    payload_bytes: float
    meta_bytes: float
    max_q: float  # highest q_prune actually applied to any sparse leaf

    @property
    def weight_bytes(self) -> float:
        return self.payload_bytes + self.meta_bytes

    @property
    def q_prune_effective(self) -> float:
        return 1.0 - self.surviving / max(1, self.n_weights)

    @property
    def b_weight_effective(self) -> float:
        return self.payload_bytes / max(1, self.surviving)

    @property
    def q_overhead_effective(self) -> float:
        return self.weight_bytes / max(1.0, self.payload_bytes)


def predict_plan_stats(leaves, cand: Candidate, space: SearchSpace) -> PlanStats:
    """What ``compress(params, candidate_plan_config(cand))`` reports, from
    shapes alone -- with ``assign_leaf``'s degradation chain (quant_sparse
    -> quant -> dense for ineligible leaves).  Assumes untied block scores
    (true for real weights): ``block_mask`` prunes exactly round(q *
    n_blocks) blocks of each slice.  A ``block_sparse`` payload is charged
    2 bytes a weight, as ``_leaf_stats`` charges it, though it is packed
    and streamed in fp32."""
    assign = {name: (kind, q) for name, kind, q in cand.assign}
    bk = bn = cand.block
    n_total = surv = 0
    payload = meta = 0.0
    max_q = 0.0
    for l in leaves:
        kind, q = assign.get(l.name, ("dense", 0.0))
        if kind in SPARSE_KINDS and not _sparse_ok(l, space, cand.block):
            kind = "quant" if kind == "quant_sparse" else "dense"
        if kind == "quant" and not _quant_ok(l, space):
            kind = "dense"
        n = l.size
        n_total += n
        if kind == "dense":
            surv += n
            payload += n * 2.0
            continue
        K, N = l.shape[-2], l.shape[-1]
        if kind == "quant":
            surv += n
            payload += float(n)
            meta += 4.0 * (n // K)  # per-(slice, out-channel) scales
            continue
        nrb, ncb = K // bk, N // bn
        pruned = int(round(q * nrb * ncb))
        sb = l.lead * (nrb * ncb - pruned)  # surviving blocks
        sv = sb * bk * bn
        surv += sv
        payload += sv * (1.0 if kind == "quant_sparse" else 2.0)
        meta += 4.0 * sb + 4.0 * l.lead * ncb  # row idx per block + counts
        if kind == "quant_sparse":
            meta += 4.0 * l.lead * N  # per-out-channel scales
        if pruned > 0:
            max_q = max(max_q, q)
    return PlanStats(n_total, surv, payload, meta, max_q)


def kernel_smem_bytes(block: int, payload_bytes: float, rows: int) -> float:
    """Shared memory of one CTA of the block-sparse kernels (B1, B2, B4) at
    block edge ``block`` for an x of ``rows`` rows.

    An int8 payload (``payload_bytes`` 1) runs the ``wgmma`` column body:
    ``Geometry<NC, S>::kSmem`` of ``csrc/wgmma_column.cuh`` at the tile
    ``block_sparse.launch_plan`` picks -- S stages of a bf16 x tile (64 NC
    rows) and a raw block, two converted bf16 blocks, 2 S mbarriers and 1 KB
    of alignment slack; (NC, S) = (1, 4) up to 64 rows, (2, 3) above.  At
    128: 197,696 and 214,064 bytes.  An fp32 payload runs the CUDA-core
    body of ``csrc/fma_column.cuh``: two payload blocks and a 64-row fp32 x
    slice padded by 4, whatever the rows (165,888 bytes at 128)."""
    if payload_bytes != 1.0:
        return float(2 * payload_bytes * block * block + 4 * block * (64 + 4))
    nc, stages = (1, 4) if rows <= DECODE_MAX_M else (2, 3)
    x_tile = 64 * nc * block * 2
    return float(stages * (x_tile + block * block) + 2 * block * block * 2
                 + 2 * stages * 8 + 1024)


# ---------------------------------------------------------------------------
# candidate scoring (the cheap screen: perf model only)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Prediction:
    """Modeled operating point of one candidate."""

    feasible: bool
    reason: str  # "" when feasible; the violated ceiling otherwise
    tokens_per_s: float  # committed tokens/s at ``batch``
    batch: int  # feasible serving batch (n_opt clamped by ceilings)
    n_opt: float  # unclamped balance point (inf = memory-bound)
    balance: float  # t_calc / t_mem at the balance point (1.0 if finite)
    kv_bytes_per_token: float
    context: int  # context_len the kv stream is charged at
    num_pages: int  # pool capacity at ``batch`` (0 = contiguous)
    stats: PlanStats


def _infeasible(reason: str, stats: PlanStats, kv_tok: float, ctx: int) -> Prediction:
    return Prediction(False, reason, 0.0, 0, 0.0, 0.0, kv_tok, ctx, 0, stats)


def predict(cfg, cand: Candidate, space: SearchSpace, cons: Constraints) -> Prediction:
    """Score one candidate: modeled tokens/s at its feasible batch, or the
    ceiling it violates.  Perf-model arithmetic only; the candidate's mesh
    (d, m) charges d data replicas, m model-parallel cards and a KV split
    of m where m divides the KV heads (else 1), line for line as the
    reference's."""
    from repro_torch.models import api as MA

    stats = predict_plan_stats(model_leaves(cfg), cand, space)
    d, m = int(cand.mesh[0]), int(cand.mesh[1])
    kv_m = m if (m > 1 and cfg.n_kv_heads % m == 0) else 1
    kv_dt = "int8" if cand.kv_dtype == "int8" else None
    paged = cand.page_size > 0
    alloc_ctx = min(cons.max_len, cons.prompt_len + cons.max_new)
    # a paged pool holds actual contexts -> charge the mean; the contiguous
    # cache reserves (and streams) max_len (core/batching.py rationale)
    ctx = mean_decode_context(cons.prompt_len, cons.max_new) if paged else cons.max_len
    kv_tok = MA.kv_bytes_per_token(cfg, kv_dt, context_len=ctx)
    store_tok = MA.kv_bytes_per_token(cfg, kv_dt)  # storage rate (unwindowed)

    kinds = {k for _, k, _ in cand.assign}
    if kinds & set(SPARSE_KINDS):
        rows = max(1, cons.max_batch) * (cand.spec_k + 1)
        payloads = [b for k, b in (("quant_sparse", 1.0), ("block_sparse", 4.0)) if k in kinds]
        if any(kernel_smem_bytes(cand.block, b, rows) > cons.smem_bytes for b in payloads):
            return _infeasible("smem", stats, kv_tok, ctx)

    sizer = BatchSizer(
        n_params=stats.n_weights,
        b_weight=stats.b_weight_effective,
        peak_flops=cons.peak_flops,
        hbm_bw=cons.hbm_bw,
        n_chips=d,
        q_prune=stats.q_prune_effective,
        q_overhead=stats.q_overhead_effective,
        sparse_compute=True,
        kv_bytes_per_token=kv_tok,
        context_len=ctx,
        model_parallel=m,
        kv_parallel=kv_m,
        spec_k=cand.spec_k,
        spec_accept=space.spec_accept if cand.spec_k > 0 else 0.0,
        draft_n_params=space.draft_n_params if cand.spec_k > 0 else 0,
    )
    batch = min(sizer.n_opt, cons.max_batch)

    # -- KV memory ceiling (pool bytes per card) ----------------------------
    if paged:
        page_bytes = cand.page_size * store_tok / kv_m
        per_seq = pm.pages_for_context(alloc_ctx, cand.page_size)
        cap = int((cons.pool_bytes / page_bytes) / max(1, per_seq) / 1.1) + 2
        while cap > 0 and (pm.paged_pool_pages(cap, alloc_ctx, cand.page_size) * page_bytes
                           > cons.pool_bytes):
            cap -= 1
        batch = min(batch, cap)
    else:
        per_seq_bytes = cons.max_len * store_tok / kv_m
        batch = min(batch, int(cons.pool_bytes // max(1.0, per_seq_bytes)))
    if batch < 1:
        return _infeasible("kv-pool", stats, kv_tok, ctx)
    num_pages = pm.paged_pool_pages(batch, alloc_ctx, cand.page_size) if paged else 0

    # -- objective ----------------------------------------------------------
    t = sizer.step_time(batch)
    tps = sizer.committed_per_tick(batch) / t

    # balance at the unclamped balance point -- the paper's t_calc == t_mem
    # check; memory-bound candidates (n_opt = inf) report balance 0
    kw = dict(q_prune=stats.q_prune_effective, q_overhead=stats.q_overhead_effective,
              sparse_compute=True, n_params=stats.n_weights, kv_bytes_per_token=kv_tok,
              context_len=ctx, model_parallel=m, kv_parallel=kv_m)
    if cand.spec_k > 0:
        n_f = pm.spec_decode_n_opt(cand.spec_k, cons.peak_flops, cons.hbm_bw,
                                   stats.b_weight_effective, **kw)
    else:
        n_f = pm.decode_n_opt(cons.peak_flops, cons.hbm_bw, stats.b_weight_effective, **kw)
    balance = 0.0
    if math.isfinite(n_f):
        tt = pm.decode_step_time(
            stats.n_weights, n_f * (cand.spec_k + 1),
            kv_tok / (cand.spec_k + 1) if cand.spec_k > 0 else kv_tok, ctx,
            cons.peak_flops, cons.hbm_bw, stats.b_weight_effective, d,
            stats.q_prune_effective, stats.q_overhead_effective, True,
            model_parallel=m, kv_parallel=kv_m)
        balance = tt["t_calc"] / tt["t_mem"]
    return Prediction(True, "", tps, int(batch), float(n_f), balance, kv_tok, ctx,
                      num_pages, stats)


# ---------------------------------------------------------------------------
# accuracy constraint (the expensive oracle -- evaluated lazily)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    """Seeded calibration task for the accuracy budget: a small FC net on
    synthetic classification, the repo's Table-4 protocol miniaturized."""

    n_features: int = 64
    n_classes: int = 8
    hidden: tuple = (128, 64)
    n_train: int = 2048
    n_test: int = 512
    base_steps: int = 160
    refine_steps: int = 60
    stages: int = 2
    batch: int = 128
    lr: float = 2e-3
    seed: int = 0

    @classmethod
    def smoke(cls) -> "CalibrationConfig":
        return cls(n_features=32, n_classes=4, hidden=(64,),
                   n_train=512, n_test=256, base_steps=80, refine_steps=30)


class CalibrationEvaluator:
    """Answers "does pruning at sparsity q stay within the accuracy
    budget?" with ``pruning.iterative_prune`` on the calibration task,
    trained eagerly on ``device`` (the CUDA device unless device="cpu").

    The base network trains once (lazily, on the first query); each
    distinct q prunes and refines from the trained base, so verdicts do not
    depend on the order of queries.  Results are memoized: the search's
    lazy screening consults this oracle at most once per sparsity level.
    The init comes from a ``torch.Generator`` seeded with ``calib.seed``,
    so the numbers differ from the reference's ``jax.random`` draws."""

    def __init__(self, calib: Optional[CalibrationConfig] = None, *,
                 max_acc_drop: float = 0.015, device=None):
        self.calib = calib if calib is not None else CalibrationConfig()
        self.max_acc_drop = float(max_acc_drop)
        self.device = resolve_device(device)
        self.evals: list = []  # every oracle run, in call order
        self._memo: dict = {}
        self._base = None  # (netcfg, params, data, base_acc) once trained

    @property
    def n_evals(self) -> int:
        return len(self.evals)

    def _tensor(self, a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a)).to(self.device)

    def _train_some(self, netcfg, data, params, masks, steps):
        from repro_torch.core import pruning as PR
        from repro_torch.data import minibatches
        from repro_torch.models import fcnet as F
        from repro_torch.training import optimizer as O
        from repro_torch.training.trainer import make_train_step

        c = self.calib
        opt_cfg = O.OptimizerConfig(lr=c.lr, warmup_steps=10,
                                    decay_steps=c.base_steps + c.stages * c.refine_steps,
                                    weight_decay=0.0)
        opt = O.init_opt_state(opt_cfg, params)
        batches = minibatches(data["x_train"], data["y_train"], c.batch, seed=c.seed + 1)
        step = make_train_step(netcfg, lambda n, p, b: F.loss_fn(n, p, b, masks), opt_cfg)
        for _ in range(steps):
            batch = {k: self._tensor(v) for k, v in next(batches).items()}
            params, opt, _ = step(params, opt, batch)
            if masks is not None:
                params = PR.apply_masks(params, masks)
        return params

    def _accuracy(self, netcfg, params, data) -> float:
        from repro_torch.models import fcnet as F

        return F.accuracy(netcfg, params, self._tensor(data["x_test"]),
                          self._tensor(data["y_test"]))

    def _ensure_base(self):
        if self._base is not None:
            return self._base
        from repro_torch.data import ClassifyDataConfig, synthetic_classification
        from repro_torch.models import fcnet as F

        c = self.calib
        data = synthetic_classification(ClassifyDataConfig(
            n_features=c.n_features, n_classes=c.n_classes,
            n_train=c.n_train, n_test=c.n_test, seed=c.seed))
        netcfg = F.FCNetConfig("autotune-calib", (c.n_features, *c.hidden, c.n_classes))
        gen = torch.Generator(device=self.device).manual_seed(c.seed)
        params = F.init_params(netcfg, gen, device=self.device)
        params = self._train_some(netcfg, data, params, None, c.base_steps)
        self._base = (netcfg, params, data, self._accuracy(netcfg, params, data))
        return self._base

    def evaluate(self, q: float) -> dict:
        """Run the pruning oracle at sparsity q (uncached)."""
        from repro_torch.core import pruning as PR

        netcfg, base_params, data, base_acc = self._ensure_base()
        c = self.calib
        _, _, achieved, hist = PR.iterative_prune(
            base_params,
            train_some=lambda p, m, s: self._train_some(netcfg, data, p, m, s),
            evaluate=lambda p: self._accuracy(netcfg, p, data),
            target_q=q, stages=c.stages, refine_steps=c.refine_steps,
            max_acc_drop=self.max_acc_drop)
        acc = hist[-1]["acc"] if achieved >= q - 1e-9 else next(
            h["acc"] for h in hist if abs(h["q"] - achieved) < 1e-9)
        res = {
            "q": float(q),
            "achieved_q": float(achieved),
            "base_acc": base_acc,
            "acc": float(acc),
            "drop": float(base_acc - acc),
            "ok": bool(achieved >= q - 1e-9),
        }
        self.evals.append(res)
        return res

    def feasible(self, q: float) -> bool:
        """Memoized: does sparsity q meet the budget on the calibration set?
        q == 0 is trivially feasible (nothing pruned)."""
        if q <= 0.0:
            return True
        key = round(float(q), 9)
        if key not in self._memo:
            self._memo[key] = self.evaluate(q)["ok"]
        return self._memo[key]


# ---------------------------------------------------------------------------
# search strategies (one interface)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TuneResult:
    strategy: str
    trials: int
    seed: int
    best: Candidate
    prediction: Prediction
    uniform: Prediction
    trace: tuple  # one JSON-safe dict per trial (trial 0 = uniform seed)
    acc_evals: tuple  # oracle runs recorded by the evaluator (if any)
    budget: float


def _neighbor(vals: tuple, cur, rng, ordered: bool):
    """One neighbourhood move: the adjacent value of an ordered knob, any
    other value of a categorical one."""
    i = vals.index(cur)
    if ordered:
        if i == 0:
            return vals[1]
        if i == len(vals) - 1:
            return vals[-2]
        return vals[i + (1 if rng.random() < 0.5 else -1)]
    others = [v for v in vals if v != cur]
    return others[int(rng.integers(len(others)))]


def _mutate(cand: Candidate, groups: tuple, space: SearchSpace, rng) -> Candidate:
    """Change ONE knob to a neighbouring value (the annealer's move set)."""
    moves = []
    for gi in range(len(groups)):
        if len(space.kinds) > 1:
            moves.append(("kind", gi))
        if len(space.q_prunes) > 1:
            moves.append(("q", gi))
    for knob, vals in (("block", space.blocks), ("kv", space.kv_dtypes),
                       ("page", space.page_sizes), ("spec", space.spec_ks),
                       ("mesh", space.meshes)):
        if len(vals) > 1:
            moves.append((knob, 0))
    if not moves:
        return cand
    knob, gi = moves[int(rng.integers(len(moves)))]
    if knob in ("kind", "q"):
        assign = list(cand.assign)
        name, kind, q = assign[gi]
        if knob == "kind":
            kind = _neighbor(space.kinds, kind, rng, ordered=False)
        else:
            q = _neighbor(space.q_prunes, q, rng, ordered=True)
        assign[gi] = (name, kind, q)
        return dataclasses.replace(cand, assign=tuple(assign))
    if knob == "block":
        return dataclasses.replace(cand, block=_neighbor(space.blocks, cand.block, rng, True))
    if knob == "kv":
        return dataclasses.replace(
            cand, kv_dtype=_neighbor(space.kv_dtypes, cand.kv_dtype, rng, False))
    if knob == "page":
        return dataclasses.replace(
            cand, page_size=_neighbor(space.page_sizes, cand.page_size, rng, True))
    if knob == "spec":
        return dataclasses.replace(cand, spec_k=_neighbor(space.spec_ks, cand.spec_k, rng, True))
    return dataclasses.replace(cand, mesh=_neighbor(space.meshes, cand.mesh, rng, False))


def _random_candidate(groups: tuple, space: SearchSpace, rng) -> Candidate:
    pick = lambda vals: vals[int(rng.integers(len(vals)))]  # noqa: E731
    return Candidate(
        assign=tuple((g, pick(space.kinds), pick(space.q_prunes)) for g in groups),
        block=pick(space.blocks),
        kv_dtype=pick(space.kv_dtypes),
        page_size=pick(space.page_sizes),
        spec_k=pick(space.spec_ks),
        mesh=pick(space.meshes),
    )


def _trace_row(i: int, strategy: str, cand: Candidate, pred: Prediction,
               accepted: bool, best_tps: float) -> dict:
    return {
        "trial": i,
        "strategy": strategy,
        "tokens_per_s": pred.tokens_per_s,
        "feasible": pred.feasible,
        "reason": pred.reason,
        "accepted": accepted,
        "best_tokens_per_s": best_tps,
        "max_q": pred.stats.max_q,
        "batch": pred.batch,
        "block": cand.block,
        "kv_dtype": cand.kv_dtype,
        "page_size": cand.page_size,
        "spec_k": cand.spec_k,
        "mesh": list(cand.mesh),
    }


def search(cfg, *, space: Optional[SearchSpace] = None,
           constraints: Optional[Constraints] = None, strategy: str = "anneal",
           trials: int = 32, seed: int = 0, accuracy: Any = None) -> TuneResult:
    """Explore the design space; return the best candidate found.

    ``accuracy`` is the expensive oracle: a ``CalibrationEvaluator`` (or any
    callable q -> bool).  It runs only when a feasible candidate would
    displace the incumbent best and its max sparsity level has not been
    ruled on yet -- at most once per distinct q_prune value, under a
    monotone sparsity ceiling (if q fails the budget, so does every q' >=
    q).  ``None`` disables the constraint (perf screening only).

    Both strategies seed trial 0 with the uniform-default candidate, so
    ``result.prediction.tokens_per_s >= result.uniform.tokens_per_s``
    whenever the uniform baseline is itself feasible.  Fixed (cfg, space,
    constraints, strategy, trials, seed) reproduce the search exactly."""
    if strategy not in ("random", "anneal"):
        raise ValueError(f"strategy must be 'random' or 'anneal', got {strategy!r}")
    space = normalize_space(cfg, space if space is not None else SearchSpace())
    cons = constraints if constraints is not None else Constraints()
    groups = tunable_groups(cfg, space)
    if not groups:
        raise ValueError(f"no tunable leaves in {cfg.name} at min_size={space.min_size}")
    rng = np.random.default_rng(seed)

    # -- lazy accuracy gate with a monotone sparsity ceiling ---------------
    q_ceiling = [max(space.q_prunes)]
    acc_memo: dict = {}

    def acc_ok(q: float) -> bool:
        if accuracy is None or q <= 0.0:
            return True
        if q > q_ceiling[0] + 1e-12:
            return False  # a lower (or equal) q already failed the budget
        key = round(q, 9)
        if key not in acc_memo:
            probe = accuracy.feasible if hasattr(accuracy, "feasible") else accuracy
            acc_memo[key] = bool(probe(q))
            if not acc_memo[key]:
                q_ceiling[0] = min(q_ceiling[0], q - 1e-9)
        return acc_memo[key]

    uni = uniform_candidate(cfg, space)
    uni_pred = predict(cfg, uni, space, cons)
    best, best_pred = None, None
    if uni_pred.feasible and acc_ok(uni_pred.stats.max_q):
        best, best_pred = uni, uni_pred
    trace = [_trace_row(0, strategy, uni, uni_pred, best is uni,
                        best_pred.tokens_per_s if best_pred else 0.0)]

    def consider(cand: Candidate, pred: Prediction) -> bool:
        """Would this displace the incumbent?  Only then is the accuracy
        oracle consulted."""
        nonlocal best, best_pred
        if not pred.feasible:
            return False
        if best_pred is not None and pred.tokens_per_s <= best_pred.tokens_per_s:
            return False
        if not acc_ok(pred.stats.max_q):
            return False
        best, best_pred = cand, pred
        return True

    if strategy == "random":
        for i in range(1, trials + 1):
            cand = _random_candidate(groups, space, rng)
            pred = predict(cfg, cand, space, cons)
            accepted = consider(cand, pred)
            trace.append(_trace_row(i, strategy, cand, pred, accepted,
                                    best_pred.tokens_per_s if best_pred else 0.0))
    else:  # anneal
        current, cur_pred = uni, uni_pred
        t0, t_end = 0.25, 0.01  # relative-delta temperature schedule
        alpha = (t_end / t0) ** (1.0 / max(1, trials))
        for i in range(1, trials + 1):
            temp = t0 * alpha ** (i - 1)
            cand = _mutate(current, groups, space, rng)
            pred = predict(cfg, cand, space, cons)
            accepted = False
            if pred.feasible:
                ref = cur_pred.tokens_per_s if cur_pred.feasible else 0.0
                if pred.tokens_per_s >= ref:
                    accepted = True
                elif ref > 0:
                    rel = (ref - pred.tokens_per_s) / ref
                    accepted = rng.random() < math.exp(-rel / temp)
            if accepted:
                current, cur_pred = cand, pred
            consider(cand, pred)
            trace.append(_trace_row(i, strategy, cand, pred, accepted,
                                    best_pred.tokens_per_s if best_pred else 0.0))

    if best is None:
        raise ValueError(
            "no feasible candidate found -- relax Constraints "
            f"(uniform baseline: {uni_pred.reason or 'accuracy budget'})")
    acc_evals = tuple(getattr(accuracy, "evals", ()) or ())
    return TuneResult(strategy=strategy, trials=trials, seed=seed, best=best,
                      prediction=best_pred, uniform=uni_pred, trace=tuple(trace),
                      acc_evals=tuple(dict(e) for e in acc_evals), budget=cons.max_acc_drop)


# ---------------------------------------------------------------------------
# TunedPlan artifact
# ---------------------------------------------------------------------------


def tuned_plan_doc(cfg, result: TuneResult, *, space: SearchSpace,
                   constraints: Optional[Constraints] = None) -> dict:
    """The JSON artifact of a finished search: the winning per-leaf
    assignments (as a rebuildable PlanConfig), serving knobs, predicted
    throughput against the uniform baseline, the accuracy audit and the
    whole search trace.  ``plan`` carries the reference's ``use_kernel``
    and ``interpret`` keys at the values the reference's search writes by
    default (False, False), so that its ``plan_config`` takes this file;
    the port's ``plan_config`` ignores both."""
    cons = constraints if constraints is not None else Constraints()
    pc = candidate_plan_config(result.best, space)
    p = result.prediction
    u = result.uniform
    return {
        "schema_version": TUNED_SCHEMA_VERSION,
        "kind": "tuned_plan",
        "arch": cfg.name,
        "strategy": result.strategy,
        "trials": result.trials,
        "seed": result.seed,
        "assignments": [[g, k, q] for g, k, q in result.best.assign],
        "plan": {
            "default": pc.default,
            "rules": [list(r) for r in pc.rules],
            "q_prune": pc.q_prune,
            "bk": pc.bk,
            "bn": pc.bn,
            "score": pc.score,
            "min_size": pc.min_size,
            "min_contract": pc.min_contract,
            "use_kernel": False,
            "interpret": False,
        },
        "serving": {
            "kv_dtype": result.best.kv_dtype,
            "page_size": result.best.page_size,
            "num_pages": p.num_pages,
            "spec_k": result.best.spec_k,
            "mesh": list(result.best.mesh),
            "max_batch": p.batch,
            "max_len": cons.max_len,
            "expected_context": p.context,
        },
        "predicted": {
            "tokens_per_s": p.tokens_per_s,
            "uniform_tokens_per_s": u.tokens_per_s,
            "speedup": p.tokens_per_s / u.tokens_per_s if u.tokens_per_s > 0 else None,
            "batch": p.batch,
            "n_opt": p.n_opt if math.isfinite(p.n_opt) else None,
            "balance": p.balance,
        },
        "measured": {"tokens_per_s": None, "uniform_tokens_per_s": None},
        "accuracy": {
            "budget": result.budget,
            "max_q": p.stats.max_q,
            "evals": [dict(e) for e in result.acc_evals],
        },
        "trace": [dict(r) for r in result.trace],
    }


def save_tuned(path: str, doc: dict) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


def load_tuned(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("kind") != "tuned_plan":
        raise ValueError(f"{path} is not a TunedPlan artifact")
    if doc.get("schema_version") != TUNED_SCHEMA_VERSION:
        raise ValueError(f"TunedPlan schema {doc.get('schema_version')} unsupported "
                         f"(expected {TUNED_SCHEMA_VERSION})")
    for key in ("arch", "plan", "serving", "predicted", "accuracy"):
        if key not in doc:
            raise ValueError(f"TunedPlan artifact missing {key!r}")
    return doc


def plan_config(doc: dict) -> WP.PlanConfig:
    """The winning PlanConfig of a TunedPlan artifact, the exact config
    ``compress`` needs to rebuild the tuned plan.  The file's ``use_kernel``
    is not read (the plan runs the kernels on the card, as
    ``candidate_plan_config``'s does) and the reference's ``interpret`` is
    dropped, as ``weight_plan.load_plan`` does."""
    d = {k: v for k, v in doc["plan"].items() if k not in ("use_kernel", "interpret")}
    d["rules"] = tuple(tuple(r) for r in d.get("rules", ()))
    return WP.PlanConfig(**d)


def engine_kwargs(doc: dict) -> dict:
    """ServingEngine config keys (flat names) encoded by a TunedPlan artifact;
    the plan is left out -- compress or load it apart and pass ``plan=``."""
    s = doc["serving"]
    kw: dict = {"max_batch": int(s["max_batch"]), "max_len": int(s["max_len"])}
    if s.get("kv_dtype") == "int8":
        kw["kv_dtype"] = "int8"
    if int(s.get("page_size") or 0) > 0:
        kw["page_size"] = int(s["page_size"])
        if int(s.get("num_pages") or 0) > 0:
            kw["num_pages"] = int(s["num_pages"])
        if int(s.get("expected_context") or 0) > 0:
            kw["expected_context"] = int(s["expected_context"])
    if int(s.get("spec_k") or 0) > 0:
        kw["spec_k"] = int(s["spec_k"])
    return kw


def engine_config(doc: dict, **overrides):
    """The TunedPlan's serving point as an ``EngineConfig``
    (``serving/config.py``), the flat keys routed by ``EngineConfig.of``.
    ``overrides`` win over the artifact; the artifact records ``spec_k``
    only, which is dropped unless ``draft_cfg`` is passed."""
    from repro_torch.serving.config import EngineConfig

    kw = engine_kwargs(doc)
    if "draft_cfg" not in overrides:
        kw.pop("spec_k", None)
    kw.update(overrides)
    return EngineConfig.of(**kw)
