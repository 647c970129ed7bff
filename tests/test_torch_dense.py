"""PyTorch port, the dense family (gemma2-27b, qwen2.5-32b, qwen1.5-4b,
glm4-9b): configs, parameter trees, forward, prefill and decode held against
the JAX package at each arch's ``smoke()`` size (the harness and its
tolerances are in torch_parity.py), the bf16 serving path against the
port's own forward, the launcher, and the sliced parameter draw.

The prompt is 96 tokens, longer than gemma2's smoke window of 64, so its
local layers see a window that bites (a test checks that they do)."""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import torch_parity as P  # noqa: E402
from repro_torch.configs.registry import get  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api, transformer  # noqa: E402
from repro_torch.models.embedding import embed  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.sharding import (ONE_DEVICE, ParamSpec,  # noqa: E402
                                           init_params)
from repro_torch.serving import decode as D  # noqa: E402

DENSE = ["gemma2-27b", "qwen2.5-32b", "qwen1.5-4b", "glm4-9b"]


@pytest.fixture(scope="module", params=DENSE)
def runs(request):
    return P.family_runs(request.param)


# --- configs and parameter trees ----------------------------------------------
@pytest.mark.parametrize("arch", DENSE)
def test_config_matches_reference(arch):
    P.assert_config_matches(arch)
    assert get(arch).family == "dense"


def test_config_sizes():
    g = get("gemma2-27b")
    assert (g.n_params(), g.vocab_padded) == (27_226_275_840, 256_000)
    q = get("qwen2.5-32b")
    assert (q.tie_embeddings, q.rope_theta, q.vocab_padded) == (False, 1e6,
                                                                152_064)
    assert get("glm4-9b").n_heads // get("glm4-9b").n_kv_heads == 16
    assert get("qwen1.5-4b").qkv_bias


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", DENSE)
def test_param_specs_match_reference(arch, size):
    P.assert_param_specs_match(arch, size)
    specs = api.param_specs(get(arch))
    assert ("lm_head" in specs) == (not get(arch).tie_embeddings)


# --- the model and its serving path against the JAX package ---------------------
def test_forward_matches_reference(runs):
    got, want = runs["forward"]
    assert got.shape == (P.B, P.FORWARD_LEN, runs["cfg"].vocab_padded)
    P.assert_logits_match(runs["cfg"], got, want, P.FORWARD_TOL)


@pytest.mark.parametrize("step", range(P.DECODE + 1))
def test_prefill_decode_logits_match_reference(runs, step):
    """Step 0 is the prefill's last position, steps 1.. the decode steps."""
    got, want = runs["steps"][step]
    assert got.shape == (P.B, runs["cfg"].vocab_padded)
    P.assert_logits_match(runs["cfg"], got, want, P.LOGIT_TOL)


@pytest.mark.parametrize("when", ["prefill", "decode"])
def test_cache_matches_reference(runs, when):
    """k, v (L, B, S + room, Hkv, hd) and len, after the prefill (the room
    still zeros) and after the decode steps."""
    got, want = runs["prefill_cache" if when == "prefill" else "cache"]
    n = P.PROMPT + (P.DECODE if when == "decode" else 0)
    P.assert_cache_matches(got, want, n)
    cfg = runs["cfg"]
    assert set(got) == {"k", "v", "len"}
    assert tuple(got["k"].shape) == (cfg.n_layers, P.B, P.PROMPT + P.DECODE,
                                     cfg.n_kv_heads, cfg.head_dim)
    if when == "prefill":
        assert not bool(got["k"][:, :, P.PROMPT:].any())


@pytest.mark.parametrize("arch", DENSE)
def test_bf16_prefill_decode_matches_forward(arch):
    P.assert_bf16_serving_matches_forward(arch)


@pytest.mark.parametrize("arch", DENSE)
def test_serve_cli_runs_on_cpu(arch, capsys):
    P.assert_serve_cli_runs(arch, capsys, prompt=80)


@pytest.mark.parametrize("arch", DENSE)
def test_entry_points_default_to_the_card(arch):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build(arch, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.init_cache(get(arch).smoke(), 1, 4)


# --- gemma2's features ------------------------------------------------------------
def test_gemma2_window_bites_at_the_test_prompt():
    """With its window, gemma2's smoke logits differ from the same model's
    with every layer global; its layers alternate local, global."""
    cfg, params = serve.build("gemma2-27b", smoke=True, device=P.CPU)
    assert [transformer.is_local(cfg, i) for i in range(4)] == \
        [True, False, True, False]
    tokens = serve.prompt_batch(cfg, 1, P.PROMPT, 0, P.CPU)["tokens"]
    local = transformer.forward(cfg, ONE_DEVICE, params, tokens)
    glob = transformer.forward(dataclasses.replace(cfg, sliding_window=None),
                               ONE_DEVICE, params, tokens)
    w = cfg.sliding_window
    assert torch.equal(local[:, :w], glob[:, :w])
    assert not torch.allclose(local[:, w:], glob[:, w:])


def test_embed_scale_rounds_to_the_tables_dtype():
    """sqrt(4608) = 67.88 is 68.0 in bf16; the factor is rounded first, as
    the reference rounds it."""
    cfg = get("gemma2-27b")
    table = torch.ones((4, 8), dtype=torch.bfloat16)
    h = embed(cfg, table, torch.tensor([[1, 2]]))
    assert h.dtype == torch.bfloat16 and bool((h == 68.0).all())
    h32 = embed(cfg, table.float(), torch.tensor([[1]]))
    assert float(h32[0, 0, 0]) == pytest.approx(np.sqrt(4608), rel=1e-7)
    assert torch.equal(embed(get("glm4-9b"), table, torch.tensor([[3]])),
                       table[[3]][None])


# --- the sliced parameter draw ------------------------------------------------------
def _whole_leaf(spec, gen):
    """The draw as it was before leaves were sliced: the whole leaf in
    float32, then cast."""
    if spec.init in ("zeros", "ones"):
        return spec.initialize(gen)
    x = torch.empty(spec.shape, dtype=torch.float32)
    if spec.init == "scaled":
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
        x.mul_(1.0 / np.sqrt(spec.shape[0]))
    else:
        x.normal_(0.0, 1.0, generator=gen).mul_(spec.scale)
    return x.to(spec.dtype)


def _leaves(tree):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k])
        else:
            yield tree[k]


def test_leaves_below_the_threshold_draw_as_before():
    """zamba2's smoke tree, bit for bit against whole-leaf draws in the same
    order from the same seed; every leaf of zamba2 at full size is below the
    threshold, so it too draws whole."""
    cfg = get("zamba2-1.2b")
    full = list(_leaves(api.param_specs(cfg)))
    assert max(int(np.prod(s.shape)) for s in full) <= sharding.SLICE_ELEMS
    specs = api.param_specs(cfg.smoke())
    got = list(_leaves(init_params(specs, torch.Generator().manual_seed(5),
                                   P.CPU)))
    gen = torch.Generator().manual_seed(5)
    want = [_whole_leaf(s, gen) for s in _leaves(specs)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("init", ["scaled", "normal"])
def test_leaf_above_the_threshold_draws_in_slices(monkeypatch, init):
    """A leaf of 12 x 64 x 96 with the threshold at 3 x 64 x 96 - 1
    elements (slices of two rows along the first axis): the leaf's shape
    and dtype, and its statistics (a normal of std 0.02, or a normal
    truncated at 2 sigma over sqrt(12), the whole leaf's fan-in)."""
    monkeypatch.setattr(sharding, "SLICE_ELEMS", 3 * 64 * 96 - 1)
    spec = ParamSpec((12, 64, 96), (None, None, None), init)
    x = spec.initialize(torch.Generator().manual_seed(2))
    assert x.shape == (12, 64, 96) and x.dtype == torch.bfloat16
    x = x.float()
    if init == "normal":
        assert abs(float(x.std()) - 0.02) < 5e-4
    else:
        s = 1 / np.sqrt(12)
        assert float(x.abs().max()) <= 2 * s * 1.01
        assert float(x.abs().max()) >= 1.9 * s
        # a standard normal truncated at +-2 has std 0.8796
        assert abs(float(x.std()) / s - 0.8796) < 0.01
    assert abs(float(x.mean())) < 0.02 * float(x.std())
    # the slices are drawn in turn, not one slice repeated
    assert not torch.equal(x[0:2], x[2:4])
