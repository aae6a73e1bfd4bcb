"""The port's serving path against the reference's, on the CPU.

``llama3.2-1b``'s smoke config (4 layers, width 64) with the reference's
weights from ``init(PRNGKey(0))``, carried into the port by
``weights.from_reference``. Prompts are made with numpy from a seed. The
logits are below 1 in magnitude. In f32 the prefill and decode logits agree
within 1e-5 (observed: 2e-7; the two frameworks sum in other orders), under
both attention paths, and greedy generation gives the reference's tokens
exactly. The bf16 twin rounds at other places in the two frameworks and is
held to 2e-2, five bf16 ulps at 0.5 (observed: 4e-3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models.transformer import get_model as jget_model
from repro.serving.engine import ServeConfig as JServeConfig
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch import configs
from repro_torch.models import weights
from repro_torch.models.transformer import get_model
from repro_torch.serving.engine import ServeConfig, ServingEngine

ARCH = "llama3.2-1b"
B, S = 2, 10
F32_ATOL = 1e-5
BF16_ATOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """The tensors here are tiny: torch's intra-op threads only contend
    with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_params():
    """The reference's smoke weights (f32 and bf16) as numpy trees."""
    out = {}
    for dt in ("float32", "bfloat16"):
        cfg = jconfigs.get_smoke_config(ARCH)
        cfg = dataclasses.replace(cfg, param_dtype=dt, compute_dtype=dt)
        params, _ = jget_model(cfg).init(jax.random.PRNGKey(0))
        out[dt] = jax.tree_util.tree_map(np.asarray, params)
    return out


def pair(impl, dtype="float32"):
    """(reference model, port model) of the smoke config."""
    kw = dict(attn_impl=impl, param_dtype=dtype, compute_dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), **kw)
    return jget_model(jcfg), get_model(configs.get_smoke_config(ARCH, **kw))


def prompts(seed=2, length=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 128, (B, length)).astype(np.int32)


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), atol=atol)


def test_config_mirrors_reference():
    for get in ("get_config", "get_smoke_config"):
        want = dataclasses.asdict(getattr(jconfigs, get)(ARCH))
        got = dataclasses.asdict(getattr(configs, get)(ARCH))
        assert got == want, get


def test_from_reference_copies_layouts_and_bits(ref_params):
    for dt, tree in ref_params.items():
        port = weights.from_reference(tree, device="cpu")
        leaves = jax.tree_util.tree_leaves_with_path(tree)
        assert leaves
        for path, a in leaves:
            x = port
            for key in path:
                x = x[key.key]
            assert tuple(x.shape) == a.shape
            assert x.dtype == getattr(torch, dt)
            if dt == "bfloat16":
                assert np.array_equal(x.view(torch.int16).numpy(),
                                      a.view(np.int16))
            else:
                assert np.array_equal(x.numpy(), a)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_prefill_and_two_decode_steps_match_reference(ref_params, impl):
    jm, tm = pair(impl)
    jp = ref_params["float32"]
    tp = weights.from_reference(jp, device="cpu")
    toks = prompts()
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=S + 3)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=S + 3)
    close(tl, jl, F32_ATOL)
    for a, b in zip(tc["stage0"], jc["stage0"]):
        close(a, b, F32_ATOL)
    for i in range(2):
        tok = np.argmax(np.asarray(jl[:, -1]), -1)[:, None].astype(np.int32)
        jl, jc = jm.decode_step(jp, jnp.asarray(tok), jc, jnp.int32(S + i))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, S + i)
        close(tl, jl, F32_ATOL)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_prefill_decode_matches_own_forward(ref_params, impl):
    """Teacher-forced decode reproduces the port's full forward logits."""
    _, tm = pair(impl)
    tp = weights.from_reference(ref_params["float32"], device="cpu")
    toks = torch.from_numpy(prompts(3))
    full = tm._forward(tp, toks)
    lp, cache = tm.prefill(tp, toks[:, :S - 2], max_len=S)
    close(lp[:, 0], full[:, S - 3], F32_ATOL)
    _, cache = tm.decode_step(tp, toks[:, S - 2:S - 1], cache, S - 2)
    l2, cache = tm.decode_step(tp, toks[:, S - 1:S], cache, S - 1)
    close(l2[:, 0], full[:, -1], F32_ATOL)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_generate_gives_reference_tokens(ref_params, impl):
    jm, tm = pair(impl)
    jp = ref_params["float32"]
    n_new = 6
    jeng = JServingEngine(jm.cfg, JServeConfig(batch=B, max_len=S + n_new + 1),
                          params=jax.tree_util.tree_map(jnp.asarray, jp))
    teng = ServingEngine(tm.cfg, ServeConfig(batch=B, max_len=S + n_new + 1),
                         params=weights.from_reference(jp, device="cpu"),
                         device="cpu")
    toks = prompts(4)
    want = jeng.generate(jnp.asarray(toks), n_new)
    got = teng.generate(torch.from_numpy(toks), n_new)
    assert got.shape == (B, n_new) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert teng.last_stats["logits_finite"]


def test_bf16_prefill_and_decode_match_reference(ref_params):
    jm, tm = pair("flash", "bfloat16")
    jp = ref_params["bfloat16"]
    tp = weights.from_reference(jp, device="cpu")
    toks = prompts(5)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), max_len=S + 1)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=S + 1)
    assert tl.dtype == torch.bfloat16
    close(tl, jl, BF16_ATOL)
    tok = np.argmax(np.asarray(jl[:, -1], np.float32), -1)[:, None]
    jl, _ = jm.decode_step(jp, jnp.asarray(tok, jnp.int32), jc, jnp.int32(S))
    tl, _ = tm.decode_step(tp, torch.from_numpy(tok.astype(np.int32)), tc, S)
    close(tl, jl, BF16_ATOL)
