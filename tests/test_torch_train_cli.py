"""The port's training launcher (``repro_torch.launch.train``) on the CPU,
its checkpoints and its fault handling: the smoke loss falls, a resumed or
restarted run equals the uninterrupted one, refusals by name, the device
rule, and ``(params, opt_state)`` checkpoints carried both ways between
the reference's store and the port's.  The CPU runs are deterministic, so
resumed runs are held to exact equality."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as rckpt
from repro.configs import get_config as ref_get_config
from repro.models.api import get_api as ref_get_api
from repro.training import optimizer as RO

from repro_torch import interop
from repro_torch.checkpoint import store
from repro_torch.configs import get_config
from repro_torch.core.weight_plan import flatten_leaves
from repro_torch.distributed.fault import RestartSupervisor, StragglerDetector
from repro_torch.launch import train
from repro_torch.models.api import get_api
from repro_torch.training import optimizer as O

from _torch_train import one_thread  # noqa: F401  (the fixture)

# torch on one thread: under the suite's workers a full pool per test crawls
pytestmark = pytest.mark.usefixtures("one_thread")


def _args(**kw):
    base = dict(arch="tinyllama-1.1b", smoke=True, steps=12, batch=4, seq=32, lr=3e-3,
                accum=1, seed=0, remat=False, compression=None, mesh="host",
                ckpt_dir=None, ckpt_every=5, log_every=100, device="cpu")
    base.update(kw)
    return types.SimpleNamespace(**base)


def _equal_trees(a, b):
    la, lb = flatten_leaves(a), flatten_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x.detach(), y.detach())


def test_loss_falls_ten_percent_in_20_steps():
    """As the reference's test_loss_decreases, at a batch where 20 steps
    learn the synthetic stream's structure (the reference's own curve at
    these flags falls 10.7%)."""
    out = train.run(_args(steps=20, batch=16, seq=64, lr=1e-2))
    assert len(out["losses"]) == 20 and out["restarts"] == 0
    assert out["losses"][-1] < 0.9 * out["losses"][0]


@pytest.mark.parametrize("flags", [dict(accum=2, batch=8), dict(compression="int8"),
                                   dict(compression="topk"), dict(remat=True)])
def test_launcher_options_train(flags):
    out = train.run(_args(steps=6, **flags))
    assert np.isfinite(out["losses"]).all() and out["restarts"] == 0
    if "compression" in flags:
        assert "ef" in out["opt_state"]


def test_checkpoint_resume_continues(tmp_path):
    d = str(tmp_path / "ck")
    train.run(_args(steps=10, ckpt_dir=d, ckpt_every=4))
    assert store.latest_step(d) == 10
    out = train.run(_args(steps=14, ckpt_dir=d, ckpt_every=4))  # restored at 10
    assert len(out["losses"]) == 4


def test_resume_matches_uninterrupted(tmp_path):
    d = str(tmp_path / "ck")
    full = train.run(_args(steps=6))
    train.run(_args(steps=3, ckpt_dir=d, ckpt_every=100))  # the final checkpoint, at 3
    resumed = train.run(_args(steps=6, ckpt_dir=d, ckpt_every=100))
    assert resumed["losses"] == full["losses"][3:]
    _equal_trees(resumed["params"], full["params"])
    _equal_trees(resumed["opt_state"], full["opt_state"])


def test_restart_matches_uninterrupted(tmp_path, monkeypatch):
    """A RuntimeError at step 4 of 6 (checkpoints every 3 steps, the one
    after step 3 holding 4 steps): one restart, resumed at step 4, and the
    losses and params of the uninterrupted run."""
    full = train.run(_args(steps=6))
    real, failed = train.synthetic_lm_batch, []

    def flaky(cfg, step):
        if step == 4 and not failed:
            failed.append(step)
            raise RuntimeError("injected fault at step 4")
        return real(cfg, step)

    monkeypatch.setattr(train, "synthetic_lm_batch", flaky)
    out = train.run(_args(steps=6, ckpt_dir=str(tmp_path / "ck"), ckpt_every=3))
    assert failed == [4] and out["restarts"] == 1
    assert out["losses"] == full["losses"]
    _equal_trees(out["params"], full["params"])


def test_supervisor_gives_up_after_max_restarts():
    sup = RestartSupervisor(max_restarts=2)
    calls = []

    def loop(start):
        calls.append(start)
        raise RuntimeError("always")

    with pytest.raises(RuntimeError, match="always"):
        sup.run(loop, lambda: 0)
    assert len(calls) == 3 and sup.restarts == 2


def test_straggler_detector_flags_the_slow_host():
    det = StragglerDetector(n_hosts=3, window=4)
    for _ in range(6):
        det.record(0, 1.0)
        det.record(1, 1.1)
        det.record(2, 2.0)
    assert det.stragglers() == [2]
    assert StragglerDetector(n_hosts=2).stragglers() == []


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "pod"], "needs 256 ranks under torchrun, this run has 1"),
    (["--mesh", "multipod"], "needs 512 ranks under torchrun, this run has 1"),
])
def test_refused_by_name(argv, match):
    """The production meshes need their ranks: outside torchrun the driver
    refuses them with the count (meshed training itself is
    tests/test_torch_sharded_training.py)."""
    base = ["--arch", "tinyllama-1.1b", "--smoke", "--steps", "1", "--device", "cpu"]
    with pytest.raises(ValueError, match=match):
        train.main(base + argv)


def test_no_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train.main(["--arch", "tinyllama-1.1b", "--smoke", "--steps", "1"])


# --- checkpoints between the packages ---------------------------------------

def _ref_state(error_feedback: bool):
    cfg = ref_get_config("tinyllama-1.1b", smoke=True)
    params = ref_get_api(cfg).init_params(cfg, jax.random.key(3))
    oc = RO.OptimizerConfig()
    opt = RO.init_opt_state(oc, params, error_feedback=error_feedback)
    r = np.random.default_rng(0)
    opt = jax.tree_util.tree_map(
        lambda x: jnp.asarray(r.normal(size=x.shape).astype(np.float32)) if x.ndim else x + 7,
        opt)
    return params, opt


def _port_like(error_feedback: bool):
    cfg = get_config("tinyllama-1.1b", smoke=True)
    params = get_api(cfg).init_params(cfg, 0, device="cpu")
    return params, O.init_opt_state(O.OptimizerConfig(), params, error_feedback=error_feedback)


@pytest.mark.parametrize("ef", [False, True])
def test_reference_checkpoint_restores_in_port(tmp_path, ef):
    rparams, ropt = _ref_state(ef)
    rckpt.save(str(tmp_path), 7, (rparams, ropt), {"step": 7})
    (params, opt), meta = store.restore(str(tmp_path), _port_like(ef))
    assert meta == {"step": 7} and opt["step"].dtype == torch.int32 and int(opt["step"]) == 7
    want = jax.tree_util.tree_leaves((rparams, ropt))
    got = flatten_leaves((params, opt))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _equal_trees(opt, interop.opt_state_from_reference(jax.tree_util.tree_map(np.asarray, ropt)))


@pytest.mark.parametrize("ef", [False, True])
def test_port_checkpoint_restores_in_reference(tmp_path, ef):
    params, opt = _port_like(ef)
    for t in flatten_leaves(opt["mu"]):
        t.normal_()
    store.save(str(tmp_path), 5, (params, opt), {"step": 5})
    like = _ref_state(ef)
    (rparams, ropt), meta = rckpt.restore(str(tmp_path), like)
    assert meta == {"step": 5}
    want = interop.tree_to_numpy((params, opt))
    for g, w in zip(jax.tree_util.tree_leaves((rparams, ropt)), jax.tree_util.tree_leaves(want)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(np.asarray(g), w)


def test_async_checkpointer_snapshots_synchronously(tmp_path):
    """The next step's in-place update cannot reach a save in flight: the
    leaves are copied to the host before ``save`` returns."""
    saver = store.AsyncCheckpointer(str(tmp_path), keep=2)
    w = torch.ones(256, 256)
    saver.save(1, {"w": w})
    w.add_(1.0)
    saver.wait()
    (got,), _ = store.restore_flat(str(tmp_path))
    assert torch.equal(got, torch.ones(256, 256))
    for s in (2, 3):
        saver.save(s, {"w": w})
    saver.wait()
    assert store.all_steps(str(tmp_path)) == [2, 3]


def test_async_checkpointer_error_surfaces_on_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = store.AsyncCheckpointer(str(blocker))
    saver.save(1, {"w": torch.zeros(2)})
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()  # raised once


def test_restore_checks_structure_and_refuses_shardings(tmp_path):
    """Structure and shape are checked; shardings that are not a tree of
    specs are refused, and a tree of them (a mesh, served since sharded
    serving) keeps each leaf's local piece."""
    from repro_torch.distributed import shardlib as sl

    a = torch.arange(6.0).reshape(2, 3)
    store.save(str(tmp_path), 1, {"a": a, "b": torch.zeros(4)})
    with pytest.raises(ValueError, match="leaves"):
        store.restore(str(tmp_path), {"a": torch.zeros(2, 3)})
    with pytest.raises(ValueError, match="shape"):
        store.restore(str(tmp_path), {"a": torch.zeros(3, 2), "b": torch.zeros(4)})
    like = {"a": torch.zeros(2, 3), "b": torch.zeros(4)}
    with pytest.raises(TypeError, match="Spec"):
        store.restore(str(tmp_path), like, shardings=object())
    mesh = sl.MeshShape({"data": 2, "model": 1}, coords={"data": 1, "model": 0})
    specs = sl.tree_specs(like, {"a": ("batch", None), "b": (None,)}, mesh=mesh)
    got, _ = store.restore(str(tmp_path), like, shardings=specs)
    assert torch.equal(got["a"], a[1:]) and got["b"].shape == (4,)
