"""PyTorch port, serving zamba2-1.2b (prefill, then decode with the hybrid
cache), held against the JAX package at the ``smoke()`` size: B 2, a prompt
of 64 (two SSD chunks of 32), 4 decode steps.

The JAX side is ``make_prefill`` + ``make_decode_step`` on a Topology built
with ``repro.launch.mesh.make_smoke_mesh()`` (Auto axes; see ROADMAP.md
section 3).  The slice is compared in float32 weights, where only the order
of sums differs, so logits and caches agree to ~1e-4 of their range; in
bf16 one-ulp differences grow through the chained random layers (see
test_torch_models.py), so the bf16 path is held to its own teacher-forced
forward with the JAX package's serving-test tolerances."""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_parity as P  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.data.pipeline import DataConfig, synthetic_tokens  # noqa: E402
from repro.launch.mesh import make_smoke_mesh  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models.transformer import RunOptions as JOpts  # noqa: E402
from repro.parallel.sharding import Topology, init_params as jinit  # noqa: E402
from repro.serving.decode import make_decode_step as jstep  # noqa: E402
from repro.serving.decode import make_prefill as jprefill  # noqa: E402
from repro_torch.configs.registry import get  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.parallel.sharding import ONE_DEVICE  # noqa: E402
from repro_torch.models import zamba  # noqa: E402
from repro_torch.serving import decode as D  # noqa: E402

ARCH = "zamba2-1.2b"
CPU = "cpu"
B, PROMPT, DECODE = 2, 64, 4
LOGIT_TOL = dict(atol=1e-3, rtol=1e-3)     # float32 weights, range ~1.3
CACHE_RTOL = 5e-4                          # of the largest |value| per entry


def assert_greedy(got, want):
    """argmax must agree unless the reference's own top-2 margin is within
    4x the observed deviation (tests/test_serving.py's rule)."""
    margin = np.sort(want, -1)[:, -1] - np.sort(want, -1)[:, -2]
    flip = np.argmax(got, -1) != np.argmax(want, -1)
    dev = np.abs(got - want).max()
    assert not np.any(flip & (margin > 4 * dev)), (margin, dev)


@pytest.fixture(scope="module")
def slice_runs():
    """Prefill + DECODE steps of both packages on the same float32 weights
    and tokens: per step (port logits, JAX logits), and the final caches."""
    cfg_j, cfg = JARCHS[ARCH].smoke(), get(ARCH).smoke()
    topo = Topology(make_smoke_mesh())
    pj = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jinit(japi.param_specs(cfg_j), jax.random.key(0)))
    pt = params_from_numpy(jax.device_get(pj), CPU)
    toks = synthetic_tokens(DataConfig(), 0, B, PROMPT + DECODE,
                            cfg.vocab_size)
    opts_j = JOpts(q_block=16, kv_block=16, remat=False)
    lj, cj = jax.jit(jprefill(cfg_j, topo, PROMPT, opts_j))(
        pj, {"tokens": jnp.asarray(toks[:, :PROMPT])})
    lt, ct = D.make_prefill(cfg, PROMPT, room=DECODE)(
        pt, {"tokens": torch.from_numpy(toks[:, :PROMPT]).long()})
    steps = [(lt.numpy(), np.asarray(lj))]
    cj = P.pad_kv(cj, DECODE)
    sj, st = jax.jit(jstep(cfg_j, topo)), D.make_decode_step(cfg)
    for i in range(PROMPT, PROMPT + DECODE):
        lj, cj = sj(pj, cj, jnp.asarray(toks[:, i]))
        lt, ct = st(pt, ct, torch.from_numpy(toks[:, i]).long())
        steps.append((lt.numpy(), np.asarray(lj)))
    return cfg, steps, ct, jax.device_get(cj)


@pytest.mark.parametrize("step", range(DECODE + 1))
def test_slice_logits_match_reference(slice_runs, step):
    """Step 0 is the prefill's last position, steps 1.. the decode steps."""
    cfg, steps, _, _ = slice_runs
    got, want = steps[step]
    V = cfg.vocab_size
    assert got.shape == want.shape == (B, cfg.vocab_padded)
    np.testing.assert_allclose(got[:, :V], want[:, :V], **LOGIT_TOL)
    assert_greedy(got[:, :V], want[:, :V])


@pytest.mark.parametrize("name", ["conv_x", "conv_B", "conv_C", "ssm",
                                  "shared_k", "shared_v", "len"])
def test_slice_cache_matches_reference(slice_runs, name):
    _, _, ct, cj = slice_runs
    got, want = ct[name], np.asarray(cj[name])
    assert tuple(got.shape) == want.shape
    if name == "len":
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        assert int(got[0]) == PROMPT + DECODE
        return
    g = got.float().numpy()
    w = want.astype(np.float32)
    assert np.abs(g - w).max() <= CACHE_RTOL * np.abs(w).max()


def test_cache_specs_match_reference():
    from repro.serving.decode import cache_specs as jspecs
    cfg_j, cfg = JARCHS[ARCH].smoke(), get(ARCH).smoke()
    ours = D.cache_specs(cfg, 3, 40)
    theirs = jspecs(cfg_j, Topology(make_smoke_mesh()), 3, 40)
    assert ours.keys() == theirs.keys()
    for k, (shp, ax, dt) in ours.items():
        assert shp == tuple(theirs[k][0])
        assert ax == tuple(theirs[k][1])
        assert str(dt).split(".")[-1] == np.dtype(theirs[k][2]).name
    assert ours["shared_k"][0][0] == cfg.n_layers // cfg.shared_attn_every


def test_bf16_prefill_decode_matches_forward():
    """The port's bf16 serving path against its own teacher-forced forward
    (tests/test_serving.py's check, with its prompt of 24 and tolerances)."""
    cfg, params = serve.build(ARCH, smoke=True, device=CPU)
    prompt, decode = 24, 4
    tokens = serve.prompt_batch(cfg, B, prompt, decode, CPU)["tokens"]
    ref = zamba.forward(cfg, params, tokens)
    logits, cache = D.make_prefill(cfg, prompt, room=decode)(
        params, {"tokens": tokens[:, :prompt]})
    np.testing.assert_allclose(logits.numpy(), ref[:, prompt - 1].numpy(),
                               atol=0.3, rtol=0.1)
    step = D.make_decode_step(cfg)
    for i in range(prompt, prompt + decode):
        logits, cache = step(params, cache, tokens[:, i])
        got, want = logits.numpy(), ref[:, i].numpy()
        np.testing.assert_allclose(got, want, atol=0.12, rtol=0.05)
        assert_greedy(got, want)


def test_decode_from_empty_cache():
    cfg, params = serve.build(ARCH, smoke=True, device=CPU)
    cache = D.init_cache(cfg, B, 8, device=CPU)
    step = D.make_decode_step(cfg)
    tok = torch.ones((B,), dtype=torch.int64)
    for _ in range(4):
        logits, cache = step(params, cache, tok)
        assert bool(torch.isfinite(logits).all())
        tok = logits.argmax(-1)
    assert int(cache["len"][0]) == 4


def test_serve_cli_runs_on_cpu(capsys):
    ids = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt", "32", "--decode", "3"])
    assert tuple(ids.shape) == (2, 3)
    assert bool(((ids >= 0) & (ids < get(ARCH).vocab_size)).all())
    out = capsys.readouterr().out
    assert "prefill: 2x32 tokens" in out and "tok/s greedy" in out


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build(ARCH, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.init_cache(get(ARCH).smoke(), 1, 4)


@pytest.mark.parametrize("family", ["moe", "vlm", "audio"])
def test_other_families_are_refused(family):
    """What stays unported of the other families is refused, naming
    ROADMAP.md (the dense, MoE, SSM, audio and VLM families are served: see
    test_torch_dense.py, test_torch_moe.py, test_torch_ssm.py and
    test_torch_audio_vlm.py), and nothing of them is refused: the MoE
    cache is the dense one and on one device every dispatch mode of its
    expert layer is the local path (the sharded modes run on a mesh of
    ranks, tests/test_torch_mesh.py); the VLM cache is the dense one, the
    audio cache adds the cross K/V over the frames, and the decode step is
    made."""
    import dataclasses
    if family == "moe":
        from repro_torch.models import moe
        cfg = get("granite-moe-1b-a400m").smoke()
        dense = dataclasses.replace(cfg, family="dense", n_experts=0)
        assert D.cache_specs(cfg, 1, 4) == D.cache_specs(dense, 1, 4)
        D.make_decode_step(cfg)
        d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff
        w = [torch.zeros(s) for s in ((d, E), (E, d, f), (E, d, f),
                                      (E, f, d))]
        x = torch.ones((2, 1, d))
        assert torch.equal(moe.moe_ffn(cfg, ONE_DEVICE, x, *w, mode="rpc"),
                           moe.moe_ffn(cfg, ONE_DEVICE, x, *w, mode="local"))
        return
    arch = {"vlm": "llava-next-mistral-7b", "audio": "whisper-medium"}[family]
    cfg = get(arch).smoke()
    dense = dataclasses.replace(cfg, family="dense")
    specs = D.cache_specs(cfg, 1, 4)
    extra = set(specs) - set(D.cache_specs(dense, 1, 4))
    assert extra == (set() if family == "vlm" else {"xk", "xv"})
    if family == "audio":
        assert specs["xk"][0] == (cfg.n_layers, 1, cfg.encoder_seq,
                                  cfg.n_kv_heads, cfg.head_dim)
    assert callable(D.make_decode_step(cfg))


@pytest.mark.cuda
def test_cuda_slice_matches_cpu():
    """The smoke config's prefill and decode on the card (through both
    kernels) against the CPU run, in float32 weights."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    cfg, params = serve.build(ARCH, smoke=True, device=CPU)
    params = {k: ({kk: vv.float() for kk, vv in v.items()}
                  if isinstance(v, dict) else v.float())
              for k, v in params.items()}
    tokens = serve.prompt_batch(cfg, B, PROMPT, DECODE, CPU)["tokens"]
    runs = []
    for dev in (CPU, "cuda"):
        p = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(dev))
             for k, v in params.items()}
        before = (fa.launches, ss.launches)
        ids, st = serve.serve(cfg, p, {"tokens": tokens.to(dev)}, PROMPT,
                              DECODE)
        runs.append((ids.cpu(), st["last_logits"].cpu()))
        if dev == "cuda":
            assert (fa.launches - before[0], ss.launches - before[1]) == \
                (1, cfg.n_layers)
    V = cfg.vocab_size
    torch.testing.assert_close(runs[1][1][:, :V], runs[0][1][:, :V],
                               atol=1e-3, rtol=1e-3)
