"""PyTorch port, the pure-SSM family (mamba2-780m): config, parameter tree,
forward, prefill and decode held against the JAX package at the
``smoke()`` size (the harness and its tolerances are in torch_parity.py),
the bf16 serving path against the port's own forward, and the launcher.

The prompt is 96 tokens, three SSD chunks of 32, so prefill carries the
state across chunks through ``ssd_scan``'s plain version."""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import torch_parity as P  # noqa: E402
from repro_torch.configs.registry import get  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.serving import decode as D  # noqa: E402

ARCH = "mamba2-780m"


@pytest.fixture(scope="module")
def runs():
    return P.family_runs(ARCH)


def test_config_matches_reference():
    P.assert_config_matches(ARCH)
    cfg = get(ARCH)
    assert (cfg.family, cfg.n_params(), cfg.vocab_padded) == \
        ("ssm", 779_913_984, 50_688)
    assert (cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim) == (48, 128, 64)


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_param_specs_match_reference(size):
    P.assert_param_specs_match(ARCH, size)
    assert set(api.param_specs(get(ARCH))) == {"embed", "final_norm", "layers"}


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
    """conv_x, conv_B, conv_C (L, B, K-1, C), ssm (L, B, H, N, P) and len,
    after the prefill and after the decode steps; no K/V region."""
    got, want = runs["prefill_cache" if when == "prefill" else "cache"]
    n = P.PROMPT + (P.DECODE if when == "decode" else 0)
    P.assert_cache_matches(got, want, n)
    cfg = runs["cfg"]
    assert set(got) == {"conv_x", "conv_B", "conv_C", "ssm", "len"}
    assert tuple(got["ssm"].shape) == (cfg.n_layers, P.B, cfg.ssm_heads,
                                       cfg.ssm_state, cfg.ssm_head_dim)


def test_cache_specs_match_reference():
    from repro.configs.registry import ARCHS as JARCHS
    from repro.launch.mesh import make_smoke_mesh
    from repro.parallel.sharding import Topology
    from repro.serving.decode import cache_specs as jspecs
    for arch in (ARCH, "gemma2-27b", "qwen2.5-32b"):
        cfg, cfg_j = get(arch), JARCHS[arch]
        ours = D.cache_specs(cfg, 3, 40)
        theirs = jspecs(cfg_j, Topology(make_smoke_mesh()), 3, 40)
        assert ours.keys() == theirs.keys()
        for k, (shp, ax, dt) in ours.items():
            assert shp == tuple(theirs[k][0])
            assert ax == tuple(theirs[k][1])
            assert str(dt).split(".")[-1] == np.dtype(theirs[k][2]).name


def test_bf16_prefill_decode_matches_forward():
    P.assert_bf16_serving_matches_forward(ARCH)


def test_decode_from_empty_cache():
    cfg, params = serve.build(ARCH, smoke=True, device=P.CPU)
    cache = D.init_cache(cfg, P.B, 8, device=P.CPU)
    step = D.make_decode_step(cfg)
    tok = torch.ones((P.B,), dtype=torch.int64)
    for _ in range(4):
        logits, cache = step(params, cache, tok)
        assert bool(torch.isfinite(logits).all())
        tok = logits.argmax(-1)
    assert int(cache["len"][0]) == 4
    assert bool(cache["ssm"].any())


def test_prompt_must_be_whole_chunks():
    """As in the reference, a prompt longer than one SSD chunk is a multiple
    of it."""
    cfg, params = serve.build(ARCH, smoke=True, device=P.CPU)
    tokens = serve.prompt_batch(cfg, 1, 40, 0, P.CPU)["tokens"]
    with pytest.raises(ValueError, match="multiple of the chunk"):
        D.make_prefill(cfg, 40)(params, {"tokens": tokens})


def test_serve_cli_runs_on_cpu(capsys):
    P.assert_serve_cli_runs(ARCH, capsys, prompt=64)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build(ARCH, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.init_cache(get(ARCH).smoke(), 1, 4)
