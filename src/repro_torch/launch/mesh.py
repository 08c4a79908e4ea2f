"""Meshes, ranks and sharding-rule selection (port of ``repro/launch/mesh.py``).

A serving mesh is a ``torch.distributed`` ``DeviceMesh`` of shape (data,
model) with dim names ("data", "model") over one process per rank.
``make_serving_mesh`` takes the serve CLI's ``--mesh``: ``"none"`` (no
mesh), ``"host"`` (1 x every visible card; (1, 1) on the CPU, as the
reference's is on one CPU device) or ``"DxM"``.  ``make_production_mesh``
is shapes only (a ``shardlib.MeshShape``): there are no 256 ranks here.

Ranks.  ``spawn_ranks`` starts D*M processes (the ``spawn`` start method;
they meet at a ``FileStore`` in a fresh temporary directory) and waits for
them; under ``torchrun`` the ranks exist already and ``init_rank`` reads
the environment.  The backend is decided up front by ``choose_backend``
and logged by the caller: NCCL where each rank owns a card, gloo where
ranks share a card or run on the CPU.  More ranks than cards is refused,
as the reference refuses more ranks than devices, unless the caller lets
ranks share a card (``share_card``, the CLI's ``--share-card``).  Nothing
falls back from one backend to the other after a failure, and one rank's
exception fails the whole launch.  ``join_torchrun`` is that choice for
a rank ``torchrun`` started, shared by the serve and train CLIs.

Training.  ``train_placement`` is where a config's training state lies on
a mesh (an ``optimizer.Placement``): params by ``rules_for``, AdamW
moments by ``opt_rules`` (ZeRO-1).  ``train_mesh_sizes`` reads the train
CLI's ``--mesh``.
"""

from __future__ import annotations

import datetime
import math
import os
import shutil
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.distributed import shardlib as sl
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models.api import get_api
from repro_torch.training import optimizer as O

AXES = ("data", "model")


def make_production_mesh(*, multi_pod: bool = False) -> sl.MeshShape:
    """The reference's production meshes as shapes: (16, 16) (data, model),
    or (2, 16, 16) (pod, data, model) for two pods."""
    if multi_pod:
        return sl.MeshShape({"pod": 2, "data": 16, "model": 16})
    return sl.MeshShape({"data": 16, "model": 16})


def parse_mesh(spec: Optional[str], device_type: str = "cpu") -> Optional[tuple]:
    """``--mesh`` -> (data, model), or None for "none": "host" is 1 x the
    visible cards (1 x 1 on the CPU), "DxM" explicit."""
    if spec in (None, "", "none"):
        return None
    if spec == "host":
        n = torch.cuda.device_count() if device_type == "cuda" else 1
        return 1, max(1, n)
    try:
        d, m = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh must be 'none', 'host', or 'DxM' (got {spec!r})") from None
    if d < 1 or m < 1:
        raise ValueError(f"--mesh {spec}: both degrees must be >= 1")
    return d, m


def choose_backend(world: int, device_type: str, share_card: bool = False) -> str:
    """NCCL when each of the ``world`` ranks on this host owns one of its
    cards, gloo for ranks that share a card (only with ``share_card``) or
    run on the CPU.  Raises ValueError for more ranks than cards without
    ``share_card``."""
    if device_type == "cpu":
        return "gloo"
    n = torch.cuda.device_count()
    if world <= n:
        return "nccl"
    if not share_card:
        raise ValueError(f"--mesh needs {world} cards, have {n} (hint: --share-card lets "
                         f"ranks share a card over gloo)")
    return "gloo"


def rank_device(rank: int, device_type: str) -> torch.device:
    """The device of ``rank``: its own card (rank modulo the cards, so that
    ranks that share a card share card 0..n-1 in turn), or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_rank(rank: int, world: int, backend: str, store_dir: Optional[str] = None) -> None:
    """Join the process group: at the FileStore under ``store_dir``
    (``spawn_ranks``), from ``torchrun``'s environment (``store_dir``
    None and WORLD_SIZE set), or alone (world 1, a HashStore)."""
    timeout = datetime.timedelta(seconds=600)
    if store_dir is not None:
        store = dist.FileStore(os.path.join(store_dir, "store"), world)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                                timeout=timeout)
    elif "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://", timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)


def join_torchrun(device_type: str, share_card: bool = False) -> None:
    """Join ``torchrun``'s group as the rank its environment names: its
    card (LOCAL_RANK), the backend chosen from the ranks on this host
    (LOCAL_WORLD_SIZE) and its cards (``choose_backend``)."""
    world = int(os.environ["WORLD_SIZE"])
    backend = choose_backend(int(os.environ.get("LOCAL_WORLD_SIZE", world)), device_type,
                             share_card)
    if device_type == "cuda":
        torch.cuda.set_device(rank_device(int(os.environ.get("LOCAL_RANK", 0)), "cuda"))
    init_rank(int(os.environ["RANK"]), world, backend)


def make_serving_mesh(shape: Optional[tuple], backend: str = "gloo"):
    """The DeviceMesh of (data, model) ``shape`` over the initialized
    process group (which must hold D*M ranks); None for no mesh.  A world
    of one joins a group of its own first."""
    if shape is None:
        return None
    return make_mesh(dict(zip(AXES, shape)), backend)


def make_mesh(sizes: dict, backend: str = "gloo"):
    """The DeviceMesh of ``sizes`` ({axis name: size}, in mesh order) over
    the initialized process group, which must hold their product of ranks.
    A world of one joins a group of its own first."""
    n = math.prod(sizes.values())
    label = "x".join(str(v) for v in sizes.values())
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a {label} mesh needs {n} ranks: spawn them first "
                               f"(spawn_ranks) or run under torchrun")
        init_rank(0, 1, backend)
    if dist.get_world_size() != n:
        raise ValueError(f"a {label} mesh needs {n} ranks, the group has "
                         f"{dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cuda" if backend == "nccl" else "cpu", tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))


def train_mesh_sizes(spec: str, world: int) -> Optional[dict]:
    """The train CLI's ``--mesh`` over ``world`` ranks as {axis: size}:
    "host" is 1 x the ranks there are (None -- the mesh-free step, which a
    1 x 1 mesh equals -- for a world of one); "pod" and "multipod" are the
    reference's production meshes, (16, 16) and (2, 16, 16), refused with
    the ranks they need when the world differs."""
    if spec == "host":
        return None if world == 1 else {"data": 1, "model": world}
    if spec not in ("pod", "multipod"):
        raise ValueError(f"--mesh must be host, pod or multipod (got {spec!r})")
    sizes = make_production_mesh(multi_pod=spec == "multipod").shape
    need = math.prod(sizes.values())
    if world != need:
        raise ValueError(f"--mesh {spec} is a {'x'.join(map(str, sizes.values()))} mesh: it "
                         f"needs {need} ranks under torchrun, this run has {world}")
    return dict(sizes)


def make_host_mesh(device_type: str = "cpu"):
    """1 x every visible card (1 x 1 on the CPU): ``make_serving_mesh("host")``."""
    return make_serving_mesh(parse_mesh("host", device_type),
                             choose_backend(1, device_type))


def _rank_entry(rank: int, world: int, backend: str, store_dir: str, target, args) -> None:
    init_rank(rank, world, backend, store_dir)
    try:
        target(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(target, args: tuple, world: int, backend: str) -> None:
    """Run ``target(rank, *args)`` in ``world`` spawned processes, each in
    the process group (``init_rank``) and left again after ``target``
    returns.  Returns when all have ended; raises (and ends the others)
    when one fails."""
    import torch.multiprocessing as tmp

    store_dir = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        tmp.start_processes(_rank_entry, args=(world, backend, store_dir, target, args),
                            nprocs=world, join=True, start_method="spawn")
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)


def rules_for(cfg, shape=None, *, zero_opt: bool = True, sequence_parallel: bool = False,
              mesh=None) -> dict:
    """Logical -> physical rules for one (arch, shape) cell, the
    reference's: decode shards the cache's sequence (``cache_seq``) over
    "model", and at a batch below 16 (long_500k) over ("data", "model");
    ``sequence_parallel`` cuts a train or prefill step's residual stream on
    its sequence (``seq_sp``); a prefill below batch 16 shards its prompt
    and cache over "data" (``seq``, which the port refuses where it would
    split); MoE archs whose expert count does not divide the model axis
    shard the expert FFN instead (``expert_ff``).  ``mesh`` gives the
    model axis's size (16 without one, the production axis)."""
    rules = dict(sl.DEFAULT_RULES)
    model_size = int(sl.axis_sizes(mesh).get("model", 1)) if mesh is not None else 16
    if sequence_parallel and (shape is None or shape.kind in ("train", "prefill")):
        rules["seq_sp"] = "model"
    if shape is not None and shape.kind == "decode":
        rules["cache_seq"] = "model" if shape.global_batch >= 16 else ("data", "model")
    if shape is not None and shape.kind == "prefill" and shape.global_batch < 16:
        rules["seq"] = "data"
        rules["cache_seq"] = "data"
    if cfg is not None and cfg.moe is not None and cfg.moe.n_experts_padded % model_size != 0:
        rules["experts"] = None
        rules["expert_ff"] = "model"
    return rules


def opt_rules(rules: dict) -> dict:
    """ZeRO-1: optimizer state also sharded over the data axes (d_model
    mapped onto them)."""
    r = dict(rules)
    r["d"] = ("pod", "data")
    return r


def train_placement(cfg, mesh, *, sequence_parallel: bool = False) -> O.Placement:
    """Where ``cfg``'s training state lies on ``mesh``, for every family:
    params by ``rules_for`` (an MoE's expert stacks on their expert axis,
    or under "expert_ff" their FFN width), moments by ``opt_rules`` of
    them (ZeRO-1: d_model also over the data axes).  An sLSTM's
    ``r_gates`` is placed whole, as the serving engine places it
    (``ssm.placement_axes``, ROADMAP C1), its moments split over the data
    axes only.  ``sequence_parallel`` adds the ``seq_sp`` rule that the
    step runs under (Megatron's sequence parallelism: the residual stream
    cut on its sequence over "model"); it places no leaf otherwise."""
    api = get_api(cfg)
    rules = rules_for(cfg, None, sequence_parallel=sequence_parallel, mesh=mesh)
    axes = api.param_axes(cfg)
    return O.Placement.of(T.meta_tree(api.param_shapes(cfg)), SSM.placement_axes(axes), mesh,
                          rules, opt_rules(rules),
                          moment_axes=SSM.placement_axes(axes, moments=True))
