"""The reference's production layouts on the port, the sequence side: a
decode cache cut along its sequence (``cache_seq``), Megatron sequence
parallelism (``seq_sp``), the fp8 KV cache (``kv8``), and the dry run's
cache specs under the reference's rules.

- Decode: the gloo ranks of a 1x2 and a 2x2 mesh (one spawn each,
  ``tests/_torch_layout_ranks``) prefill and decode teacher-forced under
  ``rules_for`` of decode_32k (``cache_seq`` over "model") and of
  long_500k (a batch of 1: over ("data", "model")): tinyllama-1.1b in fp32,
  int8 and e4m3, gemma3-4b's local rings.  Every step's logits and every
  cache piece are held to the unsharded run at 1e-5 of the max, and the
  unsharded run to the reference's unmeshed ``api.decode_step`` (an int8
  cache at the repo's int8 tolerance, 5e-3: a quantization tie may flip
  with a matmul's summation order, each payload within one step).
- kv8: the port's caches with e4m3 ``k`` / ``v`` leaves equal the
  reference's bit for bit after a prefill and every step; logits within
  1e-5 of the max.
- sp: ``_torch_train_ranks``' training cases under
  ``train_placement(sequence_parallel=True)`` on the 1x2 mesh, held to the
  mesh-free step as the tensor-parallel steps are
  (``tests/test_torch_sharded_training.py``: losses 1e-5 relative, step
  0's gradients 1e-5 of each leaf's max, params after two steps 1e-4); a
  prefill under ``seq_sp`` held to the unsharded one.
- The dry run: every decode cell's cache pieces, as ``dryrun.build_step``
  places them under ``rules_for(cfg, shape)``, have the shapes the
  reference's specs give over ``_fake_mesh`` (256 and 512 devices)."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_layout_ranks as LR
import _torch_train_ranks as TR
import repro.configs as RC
from _torch_train import configs, port_params, ref_params
from repro.distributed import shardlib as RS
from repro.launch import mesh as RM
from repro.models.api import get_api as ref_get_api
from repro.models.api import input_specs as ref_input_specs

import repro_torch.configs as C
from repro_torch.distributed import shardlib as sl
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.models.api import get_api

TOL = 1e-5
SP_CASES = ("adamw", "gemma3", "granite", "recurrentgemma", "xlstm", "whisper", "internvl")
MESHES = [(1, 2), (2, 2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: its ranks' results}: every decode case on both meshes, the
    sp prefill and training cases on 1x2."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        d = tmp_path_factory.mktemp("seq_parallel")
        # the decode cases take the reference's params (their unsharded run
        # is held to the reference's); the sp steps, held to the port's own
        # mesh-free step, the port's init of the smoke config
        decode = {LR.DECODE[c][0] for c in LR.DECODE}
        params = {}
        for arch in sorted(decode | {TR.params_key(c) for c in SP_CASES}):
            params[arch] = str(d / f"{arch}.pt")
            cfg = C.get_config(arch, smoke=True)
            torch.save(port_params(configs(arch)[0]) if arch in decode
                       else get_api(cfg).init_params(cfg, 0, device="cpu"), params[arch])
        out = {}
        for shape in MESHES:
            job = {"decode": list(LR.DECODE), "params": params,
                   "out": str(d / "x".join(map(str, shape)))}
            if shape == (1, 2):
                job.update(sp_prefill=True, sp_train=list(SP_CASES))
            os.makedirs(job["out"])
            out[shape] = LR.run_mesh(shape, job)
        return out
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# decode over a cache cut along its sequence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(LR.DECODE))
def test_sequence_cut_decode_matches_the_unsharded_step(runs, case, shape):
    """The prefill's and every teacher-forced step's logits within 1e-5 of
    the max of the unsharded run's, every cache piece within 1e-5 of its
    slice of the whole cache, and each ring really cut: a rank holds 1/2
    (decode_32k: "model"), or on 2x2 at a batch of 1 1/4 ("data",
    "model"), of its slots -- gemma3-4b's window of 8 too."""
    _, _, B, rules_shape = LR.DECODE[case]
    parts = shape[1] * (shape[0] if rules_shape == "long_500k" else 1)
    ring = 8 if case.startswith("gemma3") else LR.LENGTH
    for row in runs[shape]:
        got = row[case]
        assert got["finite"]
        assert got["err"] <= TOL, (row["coords"], got)
        assert got["cache_err"] <= TOL, (row["coords"], got)
        assert got["slots"] == ring // parts, (row["coords"], got)


def _ref_layers(rcfg, rcache) -> list:
    """The reference's stacked cache as one dict of numpy arrays a layer,
    in the port's layer order."""
    unit, n_units, rem = T.find_unit(rcfg.layer_kinds)
    out = [{k: np.asarray(v[u]) for k, v in rcache["unit"][pi].items()}
           for u in range(n_units) for pi in range(len(unit))]
    for ri, (_, count) in enumerate(T.rem_runs(rem)):
        out += [{k: np.asarray(v[i]) for k, v in rcache["rem"][ri].items()}
                for i in range(count)]
    return out


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8) if a.dtype.itemsize == 1 else a


@functools.lru_cache(maxsize=None)
def _ref_decode(case: str) -> tuple:
    """The reference's unmeshed prefill and teacher-forced steps of a decode
    case: (logits (B, 1 + STEPS, V), each layer's cache after every call)."""
    arch, kv, B, _ = LR.DECODE[case]
    rcfg = configs(arch)[0]
    api = ref_get_api(rcfg)
    params = ref_params(rcfg)
    toks = jnp.asarray(LR.decode_tokens(B))
    cache = api.init_cache(rcfg, B, LR.LENGTH, jnp.float32,
                           kv_dtype=jnp.int8 if kv == "int8" else None)
    if kv == "kv8":  # the reference's dry run casts the attention K/V leaves so
        cache = jax.tree_util.tree_map_with_path(
            lambda p, s: s.astype(jnp.float8_e4m3fn) if getattr(p[-1], "key", "") in ("k", "v")
            else s, cache)
    step = jax.jit(functools.partial(api.decode_step, rcfg))
    lg, cache = jax.jit(functools.partial(api.prefill, rcfg))(
        params, {"tokens": toks[:, :LR.PROMPT]}, cache)
    out, caches = [np.asarray(lg)], [_ref_layers(rcfg, cache)]
    for i in range(LR.STEPS):
        p = LR.PROMPT + i
        lg, cache = step(params, cache, toks[:, p:p + 1], jnp.full((B,), p, jnp.int32))
        out.append(np.asarray(lg))
        caches.append(_ref_layers(rcfg, cache))
    return np.concatenate(out, axis=1), caches


@pytest.mark.parametrize("case", list(LR.DECODE))
def test_unsharded_decode_matches_the_reference(case):
    """The port's unsharded prefill and teacher-forced steps (the runs the
    ranks hold their meshes to) against the reference's unmeshed ones: the
    logits at 1e-5 of the max; an e4m3 cache's payloads bit for bit after
    the prefill and every step."""
    arch, kv, B, _ = LR.DECODE[case]
    rcfg = configs(arch)[0]
    cfg = C.get_config(arch, smoke=True)
    api = get_api(cfg)
    params = api.unstack(cfg, port_params(rcfg))
    cache = api.init_cache(cfg, B, LR.LENGTH, torch.float32, kv_dtype=LR.KV_DTYPES[kv],
                           device="cpu")
    want, ref_caches = _ref_decode(case)
    tokens = torch.from_numpy(LR.decode_tokens(B))
    got = [api.prefill(cfg, params, {"tokens": tokens[:, :LR.PROMPT]}, cache)[0]]
    states = [[{k: t.clone() for k, t in layer.items()} for layer in cache["layers"]]]
    for i in range(LR.STEPS):
        p = LR.PROMPT + i
        got.append(api.decode_step(cfg, params, cache, tokens[:, p:p + 1],
                                   torch.full((B,), p, dtype=torch.int32))[0])
        states.append([{k: t.clone() for k, t in layer.items()} for layer in cache["layers"]])
    got = torch.cat(got, dim=1).numpy()
    if kv == "int8":
        # a per-(token, head) int8 rounding tie may flip with the matmuls'
        # summation order: the repo's int8 standard (tests/_torch_families.py),
        # each payload within one step of the reference's, at most two of a
        # layer's K or V payloads off
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-3)
        for mine, ref in zip(states, ref_caches):
            for layer, ref_layer in zip(mine, ref):
                for k in ("k", "v"):
                    d = np.abs(layer[k].numpy().astype(np.int32) - ref_layer[k].astype(np.int32))
                    assert d.max() <= 1 and (d > 0).sum() <= 2, (k, d.max(), (d > 0).sum())
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    if kv == "kv8":
        for mine, ref in zip(states, ref_caches):
            for layer, ref_layer in zip(mine, ref):
                for k in ("k", "v"):
                    assert layer[k].dtype == torch.float8_e4m3fn
                    np.testing.assert_array_equal(layer[k].view(torch.uint8).numpy(),
                                                  _bits(ref_layer[k]))


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SP_CASES)
def test_sp_steps_match_the_mesh_free_trainer(runs, case):
    """Two AdamW steps with the residual stream cut on its sequence over
    "model" (tinyllama-1.1b, gemma3-4b's tied scaled table and windows,
    granite-moe's routed FFN, recurrentgemma's RG-LRU, xlstm's cells,
    whisper's encoder and decoder, internvl's patches): the losses, step 0's
    gradient pieces and the params after the steps equal the mesh-free
    trainer's within the tensor-parallel tolerances, and the ZeRO-1
    moments stay slices of the whole."""
    for row in runs[(1, 2)]:
        got = row[f"sp {case}"]
        assert got["loss_rel"] <= 1e-5, (row["coords"], got["losses"])
        assert got["grad_err"] <= 1e-5, (row["coords"], got["grad_err"])
        over, n, worst = got["params"]
        assert over == 0, (row["coords"], over, n, worst)
        assert got["zero"] == {"moments_equal": True, "params_equal": True}


def test_sp_prefill_matches_the_unsharded_prefill(runs):
    """A 16-token prefill under ``seq_sp``: the residual stream is cut (one
    gather a block input: 2 a layer, plus the last position's), the logits
    and the cache pieces within 1e-5 of the unsharded prefill's."""
    cfg = C.get_config("tinyllama-1.1b", smoke=True)
    for row in runs[(1, 2)]:
        got = row["sp_prefill"]
        assert got["split"] and got["gathers"] == 2 * cfg.n_layers + 1, got
        assert got["err"] <= TOL and got["cache_err"] <= TOL, got


def test_seq_split_follows_the_rules():
    """``seq_split`` is False without a mesh, without the rule, or where
    the model axis does not divide the sequence; "model" only."""
    mesh = sl.MeshShape({"data": 1, "model": 2}, coords={"data": 0, "model": 0})
    assert not sl.seq_split(16)
    with sl.use_mesh(mesh):
        assert not sl.seq_split(16)
    with sl.use_mesh(mesh, {"seq_sp": "model"}):
        assert sl.seq_split(16) and not sl.seq_split(15)
    with sl.use_mesh(sl.MeshShape({"data": 2, "model": 1}, coords={"data": 0, "model": 0}),
                     {"seq_sp": "data"}):
        with pytest.raises(NotImplementedError, match="model"):
            sl.seq_split(16)


def test_a_cache_piece_comes_from_its_record():
    """Under a ``cache_seq`` mapping a rank reads its slots of the global
    ring from the piece's shape and the rules: a ring of 8 cut in two,
    wherever the piece came from (a clone, a copy to another dtype); a
    ring of 5, which the axis does not divide, is refused where it is
    placed (``shardlib.local_zeros``) rather than kept whole and misread."""
    from repro_torch.models import layers as L

    mesh = sl.MeshShape({"data": 1, "model": 2}, coords={"data": 0, "model": 1})
    rules = {"cache_seq": "model"}
    axes = ("batch", "cache_seq", "kv_heads", None)

    def place(n):
        return sl.local_zeros(torch.empty((1, n, 3, 4), device="meta"), axes, mesh,
                              dict(sl.DEFAULT_RULES, **rules), "cpu")

    cut = place(8)
    assert cut.shape == (1, 4, 3, 4)
    with pytest.raises(ValueError, match="do not divide"):
        place(5)
    with sl.use_mesh(mesh, rules):
        for c in (cut, cut.clone(), cut.to(torch.float8_e4m3fn)):
            assert L.cache_seq_piece(c, False) == L.SeqPiece(4, 8, ("model",))
    with sl.use_mesh(mesh):
        assert L.cache_seq_piece(cut, False) is None


# ---------------------------------------------------------------------------
# the dry run's cache specs
# ---------------------------------------------------------------------------


def _fake_mesh(sizes: dict):
    n = int(np.prod(list(sizes.values())))
    return Mesh(np.asarray([jax.devices()[0]] * n).reshape(tuple(sizes.values())),
                tuple(sizes))


def _norm(spec, rank):
    out = [None if e is P.UNCONSTRAINED else e for e in tuple(spec)]
    return tuple(out) + (None,) * (rank - len(out))


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", C.ARCH_IDS)
def test_dry_run_cache_pieces_follow_the_reference_specs(arch, multi_pod):
    """Every decode cell's cache, as ``dryrun.build_step`` places it for
    rank 0 under ``rules_for(cfg, shape)``, holds the pieces the
    reference's ``tree_shardings`` of its cache give over a fake mesh of
    the same axes: leaf by leaf (by name, the reference's stacked layers
    counted once a layer), each dimension the whole one over the product
    of its spec's axes."""
    cfg, rcfg = C.get_config(arch), RC.get_config(arch)
    sizes = M.make_production_mesh(multi_pod=multi_pod).shape
    mesh = sl.MeshShape(dict(sizes), coords={a: 0 for a in sizes})
    for shape in [s for s in C.shapes_for(arch) if s.kind == "decode"]:
        rules = M.rules_for(cfg, shape, mesh=mesh)
        rrules = RM.rules_for(rcfg, shape, mesh=_fake_mesh(sizes))
        assert rules == rrules
        rcache = ref_input_specs(rcfg, shape)["cache"]
        rsh = RS.tree_shardings(rcache, ref_get_api(rcfg).cache_axes(rcfg),
                                mesh=_fake_mesh(sizes), rules=rrules)
        want = {}
        for (path, leaf), ns in zip(jax.tree_util.tree_flatten_with_path(rcache)[0],
                                    jax.tree.leaves(rsh)):
            name = getattr(path[-1], "key", str(path[-1]))
            spec = _norm(ns.spec, leaf.ndim)[1:]
            whole = tuple(leaf.shape[1:])
            piece = tuple(n // int(np.prod([sizes[a] for a in ((e,) if isinstance(e, str)
                                                                 else (e or ()))]))
                          for n, e in zip(whole, spec))
            want.setdefault(name, set()).add((whole, piece))
        _, args, _ = D.build_step(cfg, shape, mesh, rules)
        cache = args[1]
        whole_cache = get_api(cfg).init_cache(cfg, shape.global_batch, shape.seq_len,
                                              getattr(torch, cfg.compute_dtype),
                                              device="meta")
        for mine, whole in zip(cache["layers"], whole_cache["layers"]):
            for name, t in mine.items():
                assert (tuple(whole[name].shape), tuple(t.shape)) in want[name], \
                    (shape.name, name, tuple(t.shape), want[name])
