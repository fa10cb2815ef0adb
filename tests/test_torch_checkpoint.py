"""The port's checkpointing and fault tolerance (``training/checkpoint.py``,
``training/fault.py``, ``train_loop``'s checkpoints), as
``tests/test_training.py`` tests the JAX package's, plus the two packages'
checkpoints read by each other: a DLRM train state saved by either restores
in the other bit for bit."""

import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.models import dlrm  # noqa: E402
from repro_torch.training import checkpoint as ck  # noqa: E402
from repro_torch.training import fault  # noqa: E402
from repro_torch.training.train_loop import (LoopConfig, TrainState,  # noqa: E402
                                             make_train_step, resume_or_init,
                                             train_loop)

CFG = dlrm.DLRMConfig(vocab_size=65, d_emb=8, bot_mlp=(16, 8),
                      top_mlp=(16, 1))
TCFG = TrainConfig(lr=1e-3)


def _state(seed: int = 0) -> TrainState:
    gen = torch.Generator().manual_seed(seed)
    return TrainState.create(dlrm.DLRM(CFG, device="cpu", generator=gen),
                             TCFG)


def _batch(seed: int = 0, rows: int = 32) -> dict:
    rng = np.random.default_rng(seed)
    return {"dense": torch.tensor(rng.normal(size=(rows, 16)),
                                  dtype=torch.float32),
            "sparse": torch.tensor(rng.integers(0, CFG.vocab_size,
                                                size=(rows, 32)),
                                   dtype=torch.int32),
            "label": torch.tensor(rng.integers(0, 2, size=rows),
                                  dtype=torch.float32)}


def _trained(steps: int = 3, seed: int = 0) -> TrainState:
    state = _state(seed)
    step = make_train_step(dlrm.loss_fn, TCFG)
    for i in range(steps):
        state, _ = step(state, _batch(i))
    return state


def _assert_states_equal(a: TrainState, b: TrainState) -> None:
    assert a.step == b.step
    for x, y in zip(dlrm.state_to_jax_leaves(a), dlrm.state_to_jax_leaves(b)):
        assert torch.equal(x, y)


def _committed(d) -> list:
    return sorted(int(p.split("_")[1]) for p in os.listdir(d)
                  if p.startswith("step_")
                  and os.path.exists(os.path.join(d, p, "COMMITTED")))


def _tiny_state(v=1.0):
    return {"w": np.full((3, 3), v, np.float32)}


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    d = str(tmp_path)
    state = _trained()
    ck.save(state, d, 7)
    assert ck.latest_step(d) == 7
    restored = ck.restore(d, _state(seed=1))
    _assert_states_equal(state, restored)
    # uncommitted dirs are invisible
    os.makedirs(os.path.join(d, "step_00000009"))
    assert ck.latest_step(d) == 7
    ck.save(state, d, 8)
    ck.save(state, d, 9)
    ck.prune(d, keep=1)
    assert ck.latest_step(d) == 9
    with pytest.raises(FileNotFoundError):
        ck.restore(d, _state(), step=7)


def test_checkpoint_layout_is_the_reference_flatten_order(tmp_path):
    """Leaves: params (bot_mlp b/w per layer, tables, top_mlp b/w), then
    AdamW m and v in the same order, then the int32 step; w as [in, out]."""
    state = _trained(1)
    path = ck.save(state, str(tmp_path), 1)
    n_params = 2 * (len(CFG.bot_mlp) + len(CFG.top_mlp)) + 1
    leaves = sorted(f for f in os.listdir(path) if f.startswith("leaf_"))
    assert len(leaves) == 3 * n_params + 1
    first = np.load(os.path.join(path, leaves[0]))
    np.testing.assert_array_equal(first, state.model.bot_mlp[0].bias
                                  .detach().numpy())
    w0 = np.load(os.path.join(path, leaves[1]))
    np.testing.assert_array_equal(w0, state.model.bot_mlp[0].weight
                                  .detach().numpy().T)
    step = np.load(os.path.join(path, leaves[-1]))
    assert step.dtype == np.int32 and step.shape == () and int(step) == 1


def test_checkpoint_structure_mismatch_rejected(tmp_path):
    d = str(tmp_path)
    ck.save({"a": np.ones(3)}, d, 1)
    with pytest.raises(ValueError):
        ck.restore(d, {"a": np.ones(3), "b": np.ones(2)})
    with pytest.raises(ValueError):
        ck.restore(d, {"a": np.ones(4)})


def test_checkpoint_tensor_tree_roundtrip(tmp_path):
    tree = {"b": [torch.arange(6, dtype=torch.int32).reshape(2, 3), None],
            "a": (torch.ones(2), np.float32(2.5))}
    ck.save(tree, str(tmp_path), 2)
    got = ck.restore(str(tmp_path), {"b": [torch.zeros(2, 3), None],
                                     "a": (torch.zeros(2), np.float32(0))})
    assert torch.equal(got["b"][0], tree["b"][0]) and got["b"][1] is None
    assert torch.equal(got["a"][0], tree["a"][0])
    assert float(got["a"][1]) == 2.5


def test_async_checkpointer(tmp_path):
    acp = ck.AsyncCheckpointer()
    w = torch.ones((4, 4))
    acp.save_async({"w": w}, str(tmp_path), 3)
    w.add_(1.0)  # the snapshot was taken before save_async returned
    acp.wait()
    assert ck.latest_step(str(tmp_path)) == 3
    got = ck.restore(str(tmp_path), {"w": torch.zeros(4, 4)})
    assert torch.equal(got["w"], torch.ones((4, 4)))


def test_watchdog_fires():
    wd = fault.Watchdog(0.05)
    wd.arm()
    deadline = time.monotonic() + 10.0
    while not wd._fired.is_set() and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(fault.WatchdogTimeout):
        wd.check()
    wd.close()


def test_run_with_restarts():
    attempts = []

    def make_fn():
        def fn():
            attempts.append(1)
            if len(attempts) < 3:
                raise RuntimeError("injected failure")
        return fn

    stats = fault.run_with_restarts(make_fn, max_restarts=5)
    assert stats.restarts == 2 and len(attempts) == 3
    attempts.clear()
    with pytest.raises(RuntimeError):  # two failures, one restart allowed
        fault.run_with_restarts(make_fn, max_restarts=1)


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_restart_resumes_from_checkpoint(tmp_path, async_ckpt):
    """Train 10 steps with a checkpoint every 5, restore into a fresh state
    (resume_or_init), train on to 15: the same as 15 uninterrupted steps."""
    d = str(tmp_path)
    step_fn = make_train_step(dlrm.loss_fn, TCFG)

    def batches(lo, hi):
        for i in range(lo, hi):
            yield _batch(i)

    state = train_loop(_state(), step_fn, batches(0, 10),
                       LoopConfig(total_steps=10, ckpt_dir=d, ckpt_every=5,
                                  log_every=0, watchdog_s=60.0),
                       device="cpu", async_ckpt=async_ckpt)
    assert ck.latest_step(d) == 10 and _committed(d) == [5, 10]
    restored = resume_or_init(lambda: _state(seed=3), d)
    _assert_states_equal(state, restored)
    restored = train_loop(restored, step_fn, batches(10, 15),
                          LoopConfig(total_steps=15, ckpt_dir=d,
                                     ckpt_every=5, log_every=0),
                          device="cpu", async_ckpt=async_ckpt)
    assert restored.step == 15
    straight = train_loop(_state(), step_fn, batches(0, 15),
                          LoopConfig(total_steps=15, log_every=0),
                          device="cpu")
    _assert_states_equal(straight, restored)


def test_resume_or_init_without_checkpoint(tmp_path):
    fresh = resume_or_init(_state, str(tmp_path / "none"))
    _assert_states_equal(fresh, _state())
    assert resume_or_init(_state, "").step == 0


# ---------------- checkpoint rollover (online service posture) ----------

def test_prune_interleaved_with_async_saves_keeps_exact(tmp_path):
    d = str(tmp_path)
    acp = ck.AsyncCheckpointer()
    for step in range(3, 31, 3):
        acp.save_async(_tiny_state(step), d, step)
        ck.prune(d, keep=2)
    acp.wait()
    ck.prune(d, keep=2)
    assert _committed(d) == [27, 30]
    assert ck.latest_step(d) == 30
    restored = ck.restore(d, _tiny_state(0.0))
    np.testing.assert_array_equal(restored["w"], _tiny_state(30)["w"])


def test_prune_keep_one_edge(tmp_path):
    d = str(tmp_path)
    for step in (1, 2, 3):
        ck.save(_tiny_state(step), d, step)
    ck.prune(d, keep=1)
    assert ck.latest_step(d) == 3
    assert [p for p in os.listdir(d) if p.startswith("step_")] == \
        ["step_00000003"]


def test_prune_uncommitted_garbage_cannot_displace_committed(tmp_path):
    d = str(tmp_path)
    ck.save(_tiny_state(7), d, 7)
    crash = os.path.join(d, "step_00000009")
    os.makedirs(crash)
    with open(os.path.join(crash, "manifest.json"), "w") as fh:
        fh.write("{}")
    ck.prune(d, keep=1)
    assert not os.path.isdir(crash)
    assert ck.latest_step(d) == 7
    restored = ck.restore(d, _tiny_state(0.0))
    np.testing.assert_array_equal(restored["w"], _tiny_state(7)["w"])


# ---------------- the two packages read each other's checkpoints --------

def _ref_cfg():
    from repro.models import dlrm as ref_dlrm
    return ref_dlrm, ref_dlrm.DLRMConfig(
        vocab_size=CFG.vocab_size, d_emb=CFG.d_emb, bot_mlp=CFG.bot_mlp,
        top_mlp=CFG.top_mlp)


def _assert_port_equals_ref(port: TrainState, ref) -> None:
    """Parameters and moments bit-equal, ``w`` against ``weight.T``."""
    import jax
    ref_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref)]
    port_leaves = [x.numpy() for x in dlrm.state_to_jax_leaves(port)]
    assert len(ref_leaves) == len(port_leaves)
    for i, (a, b) in enumerate(zip(ref_leaves, port_leaves)):
        assert a.shape == b.shape and a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
    m = port.model
    np.testing.assert_array_equal(np.asarray(ref.params["top_mlp"][1]["w"]),
                                  m.top_mlp[1].weight.detach().numpy().T)
    np.testing.assert_array_equal(np.asarray(ref.opt["v"]["tables"]),
                                  port.opt["v"][0].numpy())


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    import jax
    import jax.numpy as jnp
    from repro.configs.base import TrainConfig as RefTrainConfig
    from repro.training import checkpoint as ref_ck
    from repro.training.train_loop import TrainState as RefTrainState

    ref_dlrm, cfg = _ref_cfg()
    ref = RefTrainState.create(ref_dlrm.init(jax.random.key(0), cfg),
                               RefTrainConfig(lr=1e-3))
    rng = np.random.default_rng(5)
    ref = RefTrainState(
        params=ref.params,
        opt=jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.normal(size=x.shape).astype(x.dtype)),
            ref.opt),
        step=jnp.asarray(7, jnp.int32))
    ref_ck.save(ref, str(tmp_path), 7)
    port = ck.restore(str(tmp_path), _state(seed=9))
    assert port.step == 7
    _assert_port_equals_ref(port, ref)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    import jax
    from repro.configs.base import TrainConfig as RefTrainConfig
    from repro.training import checkpoint as ref_ck
    from repro.training.train_loop import TrainState as RefTrainState

    port = _trained(4)  # moments and step are not zero
    ck.save(port, str(tmp_path), port.step)
    ref_dlrm, cfg = _ref_cfg()
    shapes = jax.eval_shape(lambda: RefTrainState.create(
        ref_dlrm.init(jax.random.key(0), cfg), RefTrainConfig(lr=1e-3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    ref = ref_ck.restore(str(tmp_path), zeros)
    assert int(ref.step) == 4
    _assert_port_equals_ref(port, ref)


def test_adafactor_checkpoint_restores_across_packages(tmp_path):
    """A DLRM Adafactor state (one leaf per parameter; a transposed
    ``w``'s row factor is the reference's column factor) saved by the port
    restores in the reference, and back in the port, bit for bit."""
    import jax
    from repro.configs.base import TrainConfig as RefTrainConfig
    from repro.training import checkpoint as ref_ck
    from repro.training.train_loop import TrainState as RefTrainState

    tc = TrainConfig(lr=1e-3, optimizer="adafactor")
    gen = torch.Generator().manual_seed(0)
    port = TrainState.create(dlrm.DLRM(CFG, device="cpu", generator=gen), tc)
    step = make_train_step(dlrm.loss_fn, tc)
    for i in range(2):
        port, _ = step(port, _batch(i))
    ck.save(port, str(tmp_path / "a"), port.step)
    ref_dlrm, cfg = _ref_cfg()
    shapes = jax.eval_shape(lambda: RefTrainState.create(
        ref_dlrm.init(jax.random.key(0), cfg),
        RefTrainConfig(lr=1e-3, optimizer="adafactor")))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   shapes)
    ref = ref_ck.restore(str(tmp_path / "a"), zeros)
    assert int(ref.step) == 2
    mine = [x.numpy() for x in dlrm.state_to_jax_leaves(port)]
    theirs = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref)]
    assert [a.shape for a in mine] == [b.shape for b in theirs]
    for i, (a, b) in enumerate(zip(mine, theirs)):
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")
    # the reference's column factor of top_mlp[0].w ([16 in, 16 out]) is
    # the port's row factor of its [out, in] weight
    np.testing.assert_array_equal(
        np.asarray(ref.opt["f"]["top_mlp"][0]["w"]["vc"]),
        port.opt["f"][[n for n, _ in port.model.named_parameters()].index(
            "top_mlp.0.weight")]["vr"].numpy())
    ref_ck.save(ref, str(tmp_path / "b"), 2)
    back = ck.restore(str(tmp_path / "b"), TrainState.create(
        dlrm.DLRM(CFG, device="cpu"), tc))
    for a, b in zip(dlrm.state_to_jax_leaves(back),
                    dlrm.state_to_jax_leaves(port)):
        assert torch.equal(a, b)
