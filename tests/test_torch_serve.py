"""The port's serving path against the JAX package's: ``prefill`` (logits
and KV caches in the reference's stacked layout), ``decode_step``, greedy
``generate``, the reference's own serving tests (``tests/test_models.py``:
the serve smoke test, prefill + decode == forward, MoE at high capacity,
the ring cache dropping old tokens) on the port, sampled decode, and
``launch.serve`` (its prompts and its metrics), at the reduced configs of
the dense, MoE and VLM families, from the same parameters; the SSM, hybrid
and enc-dec archs where a shared case applies (each family's own file
holds its prefill and decode parity).

Tolerances (ROADMAP's LM tolerances, ``torch_lm_pair.logits_close``):
float32 compute: logits and cache K / V within rtol 1e-4 (absolute floor
1e-4 x the largest magnitude); bfloat16 compute: 3e-2 x the largest.
Cache positions are bit-equal, and greedy tokens at float32 compute equal
the reference's.  Sampled decode cannot reproduce JAX's PRNG: it is held
to its seed, its range and, over 40,000 draws, frequencies within 0.02 of
``softmax(logits / T)`` (five standard deviations of a frequency is at
most 0.0125 there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_lm_pair as lp  # noqa: E402
from repro.configs import registry as rreg  # noqa: E402
from repro.configs.base import ALL_SHAPES as RSHAPES  # noqa: E402
from repro.configs.base import ShapeCfg as RShapeCfg  # noqa: E402
from repro.launch import serve as rserve  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro.serving import decode as rdecode  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import decode  # noqa: E402

TRANSFORMERS = [a for a in lp.PORTED if treg.get_config(a).family in
                ("dense", "moe", "vlm")]
# prompted by tokens alone (an enc-dec prefill also takes frames)
TOKEN_PROMPTED = [a for a in lp.PORTED if a != "whisper_base"]


# ---------------------------------------------------------------------------
# prefill and decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [*TRANSFORMERS, "mixtral_8x7b:wrap"])
def test_prefill_and_decode_match_the_reference(case, compute):
    """Prefill of 16 tokens into a 24-slot cache, then 3 decode steps
    (``mixtral_8x7b`` reduced has a 16-token window: a 16-slot ring; in
    the ``wrap`` case 40 prompt tokens into 64, so the ring holds the last
    16 rotated, and the decode steps write over wrapped slots): the
    prefill's last-token logits and every cache leaf, then each step's
    logits and the cache after the last."""
    arch, _, wrap = case.partition(":")
    S, max_len = (40, 64) if wrap else (16, 24)
    rm, params, tm, mod = lp.pair(arch, compute_dtype=compute)
    tok = lp.tokens(tm.cfg.vocab_size, 2, S + 3, seed=1)
    lg, rc = rm.prefill(params, {"tokens": jnp.asarray(tok[:, :S])}, max_len)
    tlg, tc = tm.prefill(mod, {"tokens": torch.tensor(tok[:, :S])}, max_len)
    lp.logits_close(lg, tlg, compute)
    lp.cache_close(rc, tc, compute)
    if wrap:
        assert tc["moe_blocks"]["pos"].shape[-1] == 16
        assert int(tc["moe_blocks"]["pos"][0, 0]) == 32  # 32 % 16 == 0
    for pos in range(S, S + 3):
        lg, rc = rm.decode_step(params, rc, jnp.asarray(tok[:, pos:pos + 1]),
                                jnp.int32(pos))
        tlg, tc = tm.decode_step(mod, tc, torch.tensor(tok[:, pos:pos + 1]),
                                 pos)
        lp.logits_close(lg, tlg, compute)
    lp.cache_close(rc, tc, compute)


@pytest.mark.parametrize("arch", TOKEN_PROMPTED)
def test_greedy_generate_equals_the_reference(arch):
    """Greedy ``generate`` at float32 compute: the reference's tokens."""
    rm, params, tm, mod = lp.pair(arch, seed=2, compute_dtype="float32")
    tok = lp.tokens(tm.cfg.vocab_size, 2, 16, seed=3)
    want, _ = rdecode.generate(rm, params, jnp.asarray(tok), max_new=6,
                               max_len=22)
    got, stats = decode.generate(tm, mod, torch.tensor(tok), max_new=6,
                                 max_len=22)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 6) and stats.tokens == 12


# ---------------------------------------------------------------------------
# the reference's serving tests (tests/test_models.py), on the port
# ---------------------------------------------------------------------------

SHAPE = ShapeCfg("smoke", seq_len=32, global_batch=4, kind="train")


@pytest.mark.parametrize("arch", lp.PORTED)
def test_arch_smoke_serve(arch):
    _, tcfg = lp.cfgs(arch)
    model = api.build_model(tcfg)
    mod = model.init(device="cpu")
    batch = api.random_batch(tcfg, SHAPE, device="cpu")
    sb = {k: (v[:, :16] if v.ndim == 2 else v) for k, v in batch.items()}
    logits, cache = model.prefill(mod, sb, 32)
    assert torch.isfinite(logits).all(), arch
    tok = torch.argmax(logits[:, -1:, :], -1).to(torch.int32)
    lg2, _ = model.decode_step(mod, cache, tok, 16)
    assert torch.isfinite(lg2).all() and lg2.shape == logits.shape, arch


def _decode_vs_forward(arch, seed=1, **kw) -> float:
    """prefill(16) + decode(1) logits against the full forward's at
    position 16: the largest difference over the largest magnitude."""
    _, tcfg = lp.cfgs(arch, **kw)
    model = api.build_model(tcfg)
    mod = model.init(seed=seed, device="cpu")
    toks = api.random_batch(tcfg, ShapeCfg("s", 33, 2, "train"), seed=5,
                            device="cpu")["tokens"]
    with torch.no_grad():
        want = model.forward(mod, {"tokens": toks[:, :18]})[:, 16]
    _, cache = model.prefill(mod, {"tokens": toks[:, :16]}, 33)
    lg2, _ = model.decode_step(mod, cache, toks[:, 16:17], 16)
    return float((lg2[:, 0] - want).abs().max() / (want.abs().max() + 1e-9))


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["llama3_2_3b", "chatglm3_6b", "qwen3_32b",
                                  "mamba2_370m", "internvl2_2b",
                                  "zamba2_2_7b"])
def test_prefill_decode_matches_forward(arch, compute):
    """The reference's bound, 1e-4, at float32 compute, and at bfloat16
    where decode runs the forward's own ops a position at a time (the
    transformers: measured 0).  The SSM and the hybrid decode by the
    recurrence, not the chunked SSD: a float32 difference of ~1e-7 between
    the two can move a bfloat16 rounding downstream (the reference's XLA
    keeps float32 between fused ops; eager PyTorch rounds each op), so at
    bfloat16 they are held to the port's bfloat16 logits tolerance, 3e-2
    (measured 5.0e-3 for the SSM)."""
    err = _decode_vs_forward(arch, compute_dtype=compute)
    recurrent = arch in ("mamba2_370m", "zamba2_2_7b")
    bound = 3e-2 if (recurrent and compute == "bfloat16") else 1e-4
    assert err < bound, (arch, err)


def test_moe_consistency_with_high_capacity():
    """MoE divergence between forward and decode is ONLY capacity
    dropping."""
    err = _decode_vs_forward("mixtral_8x7b", capacity_factor=16.0)
    assert err < 1e-4, err


def test_sliding_window_ring_cache_drops_old_tokens():
    """With a ring cache, tokens beyond the window no longer affect
    logits."""
    _, tcfg = lp.cfgs("mixtral_8x7b", capacity_factor=16.0)  # window 16
    model = api.build_model(tcfg)
    mod = model.init(seed=2, device="cpu")
    toks = api.random_batch(tcfg, ShapeCfg("s", 64, 1, "train"), seed=6,
                            device="cpu")["tokens"]
    # two prompts differing ONLY at position 0, decoded at position 40:
    toks2 = toks.clone()
    toks2[:, 0] = (toks2[:, 0] + 1) % tcfg.vocab_size
    outs = []
    for t in (toks, toks2):
        _, cache = model.prefill(mod, {"tokens": t[:, :40]}, 64)
        lg2, _ = model.decode_step(mod, cache, t[:, 40:41], 40)
        outs.append(lg2)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# sampled decode
# ---------------------------------------------------------------------------

def test_sampled_tokens_follow_softmax_over_temperature():
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, 3.0, 0.25, -0.5]])
    T, n = 0.7, 40000
    gen = torch.Generator().manual_seed(0)
    tok = decode.next_token(logits.expand(n, -1), T, gen)
    assert tok.shape == (n, 1) and tok.dtype == torch.int32
    assert int(tok.min()) >= 0 and int(tok.max()) < logits.shape[1]
    freq = torch.bincount(tok[:, 0].long(), minlength=8).double() / n
    want = torch.softmax(logits[0].double() / T, -1)
    assert float((freq - want).abs().max()) < 0.02
    again = decode.next_token(logits.expand(n, -1), T,
                              torch.Generator().manual_seed(0))
    assert torch.equal(tok, again)


@pytest.mark.parametrize("arch", ["llama3_2_3b", "mamba2_370m"])
def test_sampled_generate_is_reproducible_and_in_range(arch):
    _, tcfg = lp.cfgs(arch)
    model = api.build_model(tcfg)
    mod = model.init(device="cpu")
    prompts = torch.tensor(lp.tokens(tcfg.vocab_size, 3, 8, seed=4))
    runs = [decode.generate(model, mod, prompts, max_new=12, max_len=20,
                            temperature=1.0,
                            generator=torch.Generator().manual_seed(s))[0]
            for s in (7, 7, 8)]
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    for r in runs:
        assert r.shape == (3, 12)
        assert r.min() >= 0 and r.max() < tcfg.padded_vocab


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_serve_launcher_prompts_and_metrics_match_the_reference(tmp_path):
    """``launch.serve.main`` on the CPU (the cuda ETL backend's plain
    versions): its prompts equal the reference's ``make_prompt_job``
    batch; its metrics file has the reference's lines (the integer
    counters equal, the timings positive); its tokens are the generator's
    over its prompts."""
    arch, B, S, new = "llama3_2_3b", 2, 32, 4
    out = serve.main(["--device", "cpu", "--reduced", "--arch", arch,
                      "--batch", str(B), "--prompt-len", str(S),
                      "--max-new", str(new), "--metrics-file",
                      str(tmp_path / "port.prom")])
    rcfg, _ = lp.cfgs(arch)
    job = rserve.make_prompt_job(rcfg, batch=B, prompt_len=S)
    with job.batches() as batches:
        want = next(iter(batches))["tokens"]
    np.testing.assert_array_equal(out["prompts"].numpy(), np.asarray(want))
    assert out["tokens"].shape == (B, new)
    assert out["stats"].tokens == B * new and out["etl"].consumed == 1
    again, _ = decode.generate(out["model"], out["module"], out["prompts"],
                               max_new=new, max_len=S + new)
    np.testing.assert_array_equal(again, out["tokens"])

    counters = {"prefill_seconds_total": 0.5, "decode_seconds_total": 1.25,
                "generated_tokens_total": B * new, "sequences_total": B,
                "etl_prompt_batches_total": 1}
    rserve.export_metrics(str(tmp_path / "ref.prom"), counters=counters,
                          arch=rcfg.name)
    serve.export_metrics(str(tmp_path / "same.prom"), counters=counters,
                         arch=rcfg.name)
    ref = (tmp_path / "ref.prom").read_text()
    assert (tmp_path / "same.prom").read_text() == ref
    got = (tmp_path / "port.prom").read_text().splitlines()
    ref = ref.splitlines()
    assert [ln.rsplit(" ", 1)[0] for ln in got] == \
        [ln.rsplit(" ", 1)[0] for ln in ref]
    for g, r in zip(got, ref):
        if "seconds" in g and not g.startswith("#"):
            assert float(g.rsplit(" ", 1)[1]) > 0
        else:
            assert g == r


def test_serve_launcher_numpy_backend_and_example_twin():
    """The ``numpy`` ETL backend's prompts are placed on the device and
    equal the cuda backend's; the example twin serves its default arch
    (``mamba2_370m``, as the reference's example)."""
    import importlib.util
    from pathlib import Path
    args = ["--device", "cpu", "--reduced", "--arch", "qwen3_32b",
            "--batch", "2", "--prompt-len", "16", "--max-new", "2"]
    a = serve.main(args)
    b = serve.main(args + ["--etl-backend", "numpy"])
    assert torch.equal(a["prompts"], b["prompts"])
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "torch_serve_lm.py"
    spec = importlib.util.spec_from_file_location("torch_serve_lm", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    out = ex.main(["--device", "cpu", "--max-new", "3"])
    assert out["cfg"].name == "mamba2-370m" and out["tokens"].shape == (4, 3)


def test_serve_launcher_raises_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "llama3_2_3b", "--reduced"])


def test_cache_specs_match_the_reference_at_full_width():
    """``cache_specs`` (built on the meta device) against the reference's
    ``jax.eval_shape`` of its cache, every arch at its full config and
    every shape cell (the hybrid's rings of its window, the enc-dec's
    cross cache of ``enc_seq`` frames)."""
    for arch in lp.PORTED:
        rmodel = rapi.build_model(rreg.get_config(arch))
        tmodel = api.build_model(treg.get_config(arch))
        for rs in RSHAPES:
            want = rapi.cache_specs(rmodel, rs)
            got = api.cache_specs(tmodel, ShapeCfg(rs.name, rs.seq_len,
                                                   rs.global_batch, rs.kind))
            flat = jax.tree_util.tree_leaves_with_path(want)
            for path, s in flat:
                g = got
                for p in path:
                    g = g[p.key]
                assert g[0] == s.shape and \
                    str(g[1]).removeprefix("torch.") == s.dtype.name, \
                    (arch, rs.name, path)


def test_decode_positions_stay_on_the_host(monkeypatch):
    """``generate`` never reads a device value inside its loop: no
    ``.item()`` / ``int()`` of a tensor (each would synchronize with the
    card every layer of every step)."""
    _, tcfg = lp.cfgs("mixtral_8x7b")
    model = api.build_model(tcfg)
    mod = model.init(device="cpu")
    prompts = torch.tensor(lp.tokens(tcfg.vocab_size, 2, 8))
    reads = []
    real_item, real_int = torch.Tensor.item, torch.Tensor.__int__
    monkeypatch.setattr(torch.Tensor, "item",
                        lambda t: reads.append("item") or real_item(t))
    monkeypatch.setattr(torch.Tensor, "__int__",
                        lambda t: reads.append("int") or real_int(t))
    decode.generate(model, mod, prompts, max_new=4, max_len=12)
    assert reads == []


def test_moe_decode_capacity_and_ring_length():
    """A decode step routes its B tokens as one group: capacity rounds up
    to 8 slots an expert, so nothing drops at the preset's factor; a
    sliding-window model's cache is a ring of the window."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as ttr
    _, tcfg = lp.cfgs("mixtral_8x7b")
    assert moe.capacity(4, tcfg) == 8
    cfg = dataclasses.replace(tcfg, sliding_window=0)
    assert ttr.cache_len(cfg, 40) == 40 and ttr.cache_len(tcfg, 40) == 16
