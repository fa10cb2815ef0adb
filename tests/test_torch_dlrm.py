"""The port's DLRM, AdamW and train loop against the JAX package's, from
the same initial parameters (JAX init exported through numpy) on the same
batches, and the whole ETL -> DLRM loop of both packages end to end.

Tolerances: the two frameworks sum float32 products in different orders,
so each element may differ by a few ulp of the *operands'* scale.  Logits
near zero come from cancellation, so they are held to rtol 1e-5 with an
absolute floor of 1e-5 times the largest logit.  AdamW turns a gradient
that is rounding noise into a full +-lr step, so after three steps the
parameters are held tensor by tensor in norm (relative error 1e-4) and the
losses and gradient norms to rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from repro.configs.base import TrainConfig as RefTrainConfig  # noqa: E402
from repro.data.source import Source as RefSource  # noqa: E402
from repro.models import dlrm as rdlrm  # noqa: E402
from repro.session import EtlJob as RefEtlJob  # noqa: E402
from repro.training import train_loop as rtl  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.data.source import Source  # noqa: E402
from repro_torch.models import dlrm  # noqa: E402
from repro_torch.session import EtlJob  # noqa: E402
from repro_torch.training import train_loop as ttl  # noqa: E402

SMALL = dict(vocab_size=2049, d_emb=16, bot_mlp=(64, 32, 16),
             top_mlp=(64, 32, 1))


def _models(seed: int = 0):
    rcfg, tcfg = rdlrm.DLRMConfig(**SMALL), dlrm.DLRMConfig(**SMALL)
    params = rdlrm.init(jax.random.key(seed), rcfg)
    model = dlrm.DLRM(tcfg, device="cpu")
    model.load_state_dict(dlrm.params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return rcfg, params, model


def _batch(rows: int = 128, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"dense": rng.normal(size=(rows, 16)).astype(np.float32),
            "sparse": rng.integers(0, 2049, size=(rows, 32)).astype(np.int32),
            "label": (rng.random(rows) < 0.3).astype(np.float32)}


def _t(batch: dict) -> dict:
    return {k: torch.tensor(v) for k, v in batch.items()}


def test_params_from_jax_layout():
    rcfg, params, model = _models()
    sd = model.state_dict()
    assert sum(v.numel() for v in sd.values()) == rcfg.param_count()
    np.testing.assert_array_equal(sd["bot_mlp.0.weight"].numpy(),
                                  np.asarray(params["bot_mlp"][0]["w"]).T)
    np.testing.assert_array_equal(sd["tables"].numpy(),
                                  np.asarray(params["tables"]))


def test_logits_and_loss_match():
    rcfg, params, model = _models()
    b = _batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    with torch.no_grad():
        want = np.asarray(rdlrm.forward(params, jb, rcfg))
        np.testing.assert_allclose(model(_t(b)).numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
        tp.assert_match(rdlrm.loss_fn(params, jb, rcfg),
                        dlrm.loss_fn(model, _t(b)), "loss")


def test_three_adamw_steps_match():
    rcfg, params, model = _models(seed=1)
    rstate = rtl.TrainState.create(params, RefTrainConfig(lr=3e-3))
    rstep = jax.jit(rtl.make_train_step(
        lambda p, b: rdlrm.loss_fn(p, b, rcfg), RefTrainConfig(lr=3e-3)))
    state = ttl.TrainState.create(model, TrainConfig(lr=3e-3))
    step = ttl.make_train_step(dlrm.loss_fn, TrainConfig(lr=3e-3))
    for i in range(3):
        b = _batch(seed=10 + i)
        rstate, rm = rstep(rstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = step(state, _t(b))
        np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                                   rtol=1e-4, err_msg=f"loss step {i}")
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-4)
    want = dlrm.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       rstate.params))
    for k, v in model.state_dict().items():
        err = torch.linalg.vector_norm(v - want[k])
        assert err <= 1e-4 * torch.linalg.vector_norm(want[k]), (k, err)


def test_etl_to_dlrm_end_to_end_matches():
    """Both packages' EtlJob (Pipeline II) feeding 3 DLRM steps from the
    same initial parameters give the same losses."""
    ref_t, port_t = tp.build_pair(tp.paper("II", batch_size=256))
    fit = dict(rows=3000, batch_size=1000, seed=7)
    src = dict(rows=3 * 256, batch_size=256, seed=2)
    rjob = RefEtlJob(ref_t, RefSource.synth("I", **src), backend="jnp",
                     fit_source=RefSource.synth("I", **fit))
    tjob = EtlJob(port_t, Source.synth("I", **src), backend="cuda",
                  device="cpu", fit_source=Source.synth("I", **fit))
    rjob.fit()
    tjob.fit()
    assert tjob.state.n_unique == rjob.state.n_unique
    rcfg, params, model = _models(seed=2)
    tcfg = RefTrainConfig(lr=1e-3)
    rstate = rtl.TrainState.create(params, tcfg)
    rstep = jax.jit(rtl.make_train_step(
        lambda p, b: rdlrm.loss_fn(p, b, rcfg), tcfg))
    state = ttl.TrainState.create(model, TrainConfig(lr=1e-3))
    step = ttl.make_train_step(dlrm.loss_fn, TrainConfig(lr=1e-3))
    rlosses, losses = [], []
    with rjob.batches() as rex:
        for b in rex:
            rstate, m = rstep(rstate, b)
            rlosses.append(float(m["loss"]))
    with tjob.batches() as tex:
        state = ttl.train_loop(state, step, tex,
                               ttl.LoopConfig(total_steps=3, log_every=1),
                               device="cpu",
                               on_metrics=lambda m: losses.append(m["loss"]))
    assert len(losses) == len(rlosses) == 3
    np.testing.assert_allclose(losses, rlosses, rtol=1e-4)
