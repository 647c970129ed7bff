"""PyTorch port, the audio and VLM families (whisper-medium,
llava-next-mistral-7b): configs and ``n_params`` for all ten archs,
parameter trees leaf for leaf, the sinusoid table and the stub inputs bit
for bit, ``layer_norm`` and ``gelu_mlp``, then each arch's forward, prefill
and decode at its ``smoke()`` size (the harness and its tolerances are in
torch_parity.py), one float32 train step's moments, and the launcher.

The reference's whisper runs with float32 weights only with its encoder's
scan as a loop (torch_parity.reference_scan_as_loop); a test holds that
loop to the scan in bf16, where the scan runs."""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_parity as P  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.launch.mesh import make_smoke_mesh  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import whisper as jW  # noqa: E402
from repro.models.transformer import RunOptions as JOpts  # noqa: E402
from repro.optim import adamw as jA  # noqa: E402
from repro.parallel.sharding import Topology, init_params as jinit  # noqa: E402
from repro.train import step as jS  # noqa: E402
from repro_torch.configs.registry import ARCHS, get  # noqa: E402
from repro_torch.convert import (params_from_numpy, tensor_from_numpy,  # noqa: E402
                                 tensor_to_numpy, train_state_from_numpy)
from repro_torch.data.pipeline import DataConfig, synthetic_batch  # noqa: E402
from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api, transformer, whisper  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.transformer import RunOptions  # noqa: E402
from repro_torch.optim import adamw as A  # noqa: E402
from repro_torch.parallel.sharding import ONE_DEVICE  # noqa: E402
from repro_torch.serving import decode as D  # noqa: E402
from repro_torch.train import step as S  # noqa: E402

FAMILIES = {"whisper-medium": "audio", "llava-next-mistral-7b": "vlm"}
ARCH_LIST = sorted(FAMILIES)
BF16_ULP = 2.0 ** -8
F32_RTOL = 1e-5
# the train step's limits: test_torch_train.py's (the readings are in
# CHANGES.md)
GRAD_REL, LOSS_REL = 5e-3, 1e-5
# leaves and parameters of the full trees, counted from param_specs
TREES = {"whisper-medium": (44, 758_837_248),
         "llava-next-mistral-7b": (11, 7_111_708_672)}


@pytest.fixture(scope="module", params=ARCH_LIST)
def runs(request):
    return P.family_runs(request.param)


@pytest.fixture(scope="module")
def topo():
    return Topology(make_smoke_mesh())


def _leaves(tree):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k])
        else:
            yield tree[k]


# --- configs and parameter trees ---------------------------------------------
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_config_matches_reference(arch):
    P.assert_config_matches(arch)
    assert get(arch).family == FAMILIES[arch]


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_n_params_matches_reference(arch):
    """The reference's approximate formula, for every arch, full and smoke."""
    for c, r in ((get(arch), JARCHS[arch]),
                 (get(arch).smoke(), JARCHS[arch].smoke())):
        assert c.n_params() == r.n_params()
    assert set(ARCHS) == set(JARCHS)


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_param_specs_match_reference(arch, size):
    """Names, shapes, init kinds, scales and dtypes, leaf for leaf."""
    P.assert_param_specs_match(arch, size)


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_full_trees_counted_from_specs(arch):
    """Leaves and parameters of the full trees (nothing allocated), the
    reference's the same; against the formula: whisper's decoder MLPs are
    two-matrix GELUs where the formula prices SwiGLUs (24 x d x f too
    many), and the padded vocab rows, norms and biases it leaves out
    take back part of that; llava's tree has the 256 padded vocab rows and
    65 norm vectors of 4,096 more."""
    cfg = get(arch)
    ours = [s.shape for s in _leaves(api.param_specs(cfg))]
    theirs = [tuple(s.shape) for s in _leaves(japi.param_specs(JARCHS[arch]))]
    count = sum(int(np.prod(s)) for s in ours)
    assert ours == theirs
    assert (len(ours), count) == TREES[arch]
    d = cfg.d_model
    if arch == "whisper-medium":
        # norm weights and biases: the leaves of at most two axes, but the
        # embedding
        small = sum(int(np.prod(s)) for s in ours
                    if len(s) <= 2 and s != (cfg.vocab_padded, d))
        assert count - cfg.n_params() == (
            (cfg.vocab_padded - cfg.vocab_size) * d + small
            - cfg.n_layers * d * cfg.d_ff) == -99_578_880
    else:
        assert count - cfg.n_params() == 256 * d + 65 * d == 1_314_816


# --- the model's parts against the reference -----------------------------------
@pytest.mark.parametrize("S,d", [(1500, 1024), (448, 1024), (24, 64),
                                 (4096, 1024)])
def test_sinusoid_bit_for_bit(S, d):
    got = whisper.sinusoid(S, d, device="cpu")
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (S, d)
    want = np.asarray(jW.sinusoid(S, d))
    np.testing.assert_array_equal(tensor_to_numpy(got).view(np.uint16),
                                  want.view(np.uint16))
    # row p does not depend on the table's length
    assert torch.equal(whisper.sinusoid(S + 7, d, device="cpu")[:S], got)


@pytest.mark.parametrize("arch", ARCH_LIST)
@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5)])
def test_stub_inputs_bit_for_bit(arch, seed, step):
    """The synthetic batch's tokens, labels, frames / patch embeddings, at
    the full width (llava's patches cut by a short sequence)."""
    from repro.configs.base import ShapeConfig as JShape
    from repro.data import pipeline as jp
    cfg = get(arch)
    jb = jp.synthetic_batch(JARCHS[arch], JShape("t", 40, 2, "train"),
                            jp.DataConfig(seed=seed), step)
    tb = synthetic_batch(cfg, ShapeConfig("t", 40, 2, "train"),
                         DataConfig(seed=seed), step, device="cpu")
    assert set(jb) == set(tb)
    for k in jb:
        want = np.asarray(jb[k])
        got = tensor_to_numpy(tb[k])
        assert got.shape == want.shape, k
        if tb[k].dtype == torch.bfloat16:
            np.testing.assert_array_equal(got.view(np.uint16),
                                          want.view(np.uint16))
        else:
            np.testing.assert_array_equal(got, want)
    key = "frames" if FAMILIES[arch] == "audio" else "patch_embeds"
    n = cfg.encoder_seq if key == "frames" else min(cfg.n_patches, 40)
    assert tuple(tb[key].shape) == (2, n, cfg.d_model)


def _rand(rng, shape, dtype):
    a = rng.randn(*shape).astype(np.float32)
    return jnp.asarray(a, dtype), tensor_from_numpy(
        np.asarray(jnp.asarray(a, dtype)), "cpu")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_layer_norm_matches_reference(dtype):
    rng = np.random.RandomState(0)
    xj, xt = _rand(rng, (3, 5, 64), dtype)
    xj, xt = xj * 3 + 1, xt * 3 + 1
    wj, wt = _rand(rng, (64,), dtype)
    bj, bt = _rand(rng, (64,), dtype)
    got = L.layer_norm(xt, wt, bt)
    want = np.asarray(jL.layer_norm(xj, wj, bj), np.float32)
    assert got.dtype == xt.dtype
    tol = F32_RTOL if dtype == jnp.float32 else 2 * BF16_ULP
    assert np.abs(got.float().numpy() - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_gelu_mlp_matches_reference(dtype):
    """The tanh approximation; in float32 torch's default erf GELU is a
    negative control that misses the same limit (in bf16 the two differ by
    less than a rounding).  w_in is scaled so that the pre-activations are
    of order one, where the two differ most."""
    rng = np.random.RandomState(1)
    xj, xt = _rand(rng, (2, 7, 64), dtype)
    w1j, w1t = _rand(rng, (64, 128), dtype)
    w1j, w1t = w1j / 8, w1t / 8
    b1j, b1t = _rand(rng, (128,), dtype)
    w2j, w2t = _rand(rng, (128, 64), dtype)
    b2j, b2t = _rand(rng, (64,), dtype)
    want = np.asarray(jL.gelu_mlp(xj, w1j, b1j, w2j, b2j), np.float32)
    tol = (F32_RTOL if dtype == jnp.float32 else 2 * BF16_ULP) * \
        np.abs(want).max()
    got = L.gelu_mlp(xt, w1t, b1t, w2t, b2t)
    assert got.dtype == xt.dtype
    assert np.abs(got.float().numpy() - want).max() <= tol
    if dtype == jnp.float32:
        h = torch.nn.functional.gelu(xt @ w1t + b1t)
        assert np.abs((h @ w2t + b2t).numpy() - want).max() > 10 * tol


def test_loop_scan_is_the_reference_scan(topo):
    """In bf16, where the reference's scan runs, its whisper forward with
    the scans as loops is bit for bit the forward with the scans."""
    cfg_j = JARCHS["whisper-medium"].smoke()
    pj = jinit(japi.param_specs(cfg_j), jax.random.key(3))
    batch = dict({k: jnp.asarray(v) for k, v in P.stub_inputs(cfg_j).items()},
                 tokens=jnp.ones((P.B, 16), jnp.int32))
    opts = JOpts(q_block=16, kv_block=16, remat=False)
    f = lambda p, b: japi.forward(cfg_j, topo, p, b, opts=opts)
    scanned = np.asarray(P.jit(f)(pj, batch))
    with P.reference_scan_as_loop():
        looped = np.asarray(P.jit(f)(pj, batch))
    np.testing.assert_array_equal(looped, scanned)


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
    """k, v (L, B, S + room, Hkv, hd), whisper's xk, xv (L, B, frames, Hkv,
    hd) and len, after the prefill (the room still zeros) and after the
    decode steps (the cross K/V unchanged)."""
    got, want = runs["prefill_cache" if when == "prefill" else "cache"]
    n = P.PROMPT + (P.DECODE if when == "decode" else 0)
    P.assert_cache_matches(got, want, n)
    cfg = runs["cfg"]
    audio = cfg.family == "audio"
    assert set(got) == ({"k", "v", "xk", "xv", "len"} if audio
                        else {"k", "v", "len"})
    assert tuple(got["k"].shape) == (cfg.n_layers, P.B, P.PROMPT + P.DECODE,
                                     cfg.n_kv_heads, cfg.head_dim)
    if when == "prefill":
        assert not bool(got["k"][:, :, P.PROMPT:].any())
    elif audio:
        assert torch.equal(got["xk"], runs["prefill_cache"][0]["xk"])
        assert tuple(got["xk"].shape) == (cfg.n_layers, P.B, cfg.encoder_seq,
                                          cfg.n_kv_heads, cfg.head_dim)


def test_patches_take_the_first_positions():
    """llava's logits differ with and without its patch embeddings from
    the first position on (position 0 is a patch), and ``api.forward``
    passes them as ``transformer.forward(extra_embeds=)``; whisper's differ
    with other frames, and a batch without frames takes zeros."""
    cfg, params = serve.build("llava-next-mistral-7b", smoke=True, device="cpu")
    batch = serve.prompt_batch(cfg, 1, 16, 0, "cpu")
    P_ = batch["patch_embeds"].shape[1]
    assert P_ == cfg.n_patches == 8
    with_p = api.forward(cfg, params, batch)
    without = api.forward(cfg, params, {"tokens": batch["tokens"]})
    assert not torch.allclose(with_p[:, 0], without[:, 0])
    same = transformer.forward(cfg, ONE_DEVICE, params, batch["tokens"],
                               extra_embeds=batch["patch_embeds"])
    assert torch.equal(same, with_p)
    cfg, params = serve.build("whisper-medium", smoke=True, device="cpu")
    batch = serve.prompt_batch(cfg, 1, 16, 0, "cpu")
    a = api.forward(cfg, params, batch)
    b = api.forward(cfg, params, {"tokens": batch["tokens"]})
    assert not torch.allclose(a, b)
    assert torch.equal(b, api.forward(cfg, params, dict(
        batch, frames=whisper.no_frames(cfg, 1, "cpu"))))


def test_chip_smoke_float64_witness_is_the_reference_forward():
    """chip_smoke.plain_dense_logits, the float64 forward that llava's
    float32 runs on the card and the CPU are measured against, computes the
    reference's forward (float32 weights, its patch embeddings) at smoke
    size within the whole-sequence float32 tolerance."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    arch = "llava-next-mistral-7b"
    cfg_j, cfg = JARCHS[arch].smoke(), get(arch).smoke()
    pj = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jinit(japi.param_specs(cfg_j), jax.random.key(0)))
    toks = P.synthetic_tokens(P.DataConfig(), 0, P.B, P.FORWARD_LEN,
                              cfg.vocab_size)
    extra = P.stub_inputs(cfg_j)
    opts = JOpts(q_block=16, kv_block=16, remat=False)
    want = np.asarray(P.jit(lambda p, b: japi.forward(
        cfg_j, Topology(make_smoke_mesh()), p, b, opts=opts))(
            pj, dict(extra, tokens=jnp.asarray(toks))))
    got = chip_smoke.plain_dense_logits(
        cfg, params_from_numpy(jax.device_get(pj), "cpu"),
        torch.from_numpy(toks), tensor_from_numpy(extra["patch_embeds"],
                                                  "cpu"), torch.float64)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want[..., :cfg.vocab_size],
                               **P.FORWARD_TOL)


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_bf16_prefill_decode_matches_forward(arch):
    P.assert_bf16_serving_matches_forward(arch)


# --- one train step against the reference's ------------------------------------
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_float32_train_step_matches_reference(arch, topo):
    """One float32 step of ``make_train_step`` from the reference's state
    (AdamW with eps 1, lr 0.1, no decay, as test_torch_train.py's): the
    loss within LOSS_REL, the gradient norm and each leaf's first and
    second moments (the gradient and its square, scaled) within GRAD_REL
    of the leaf's largest value."""
    cfg_j, cfg = JARCHS[arch].smoke(), get(arch).smoke()
    pj = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jinit(japi.param_specs(cfg_j), jax.random.key(0)))
    adam = dict(lr=0.1, eps=1.0, warmup_steps=1, weight_decay=0.0)
    hpj = jS.TrainHparams(opts=JOpts(q_block=32, kv_block=32, remat=False),
                          optimizer=jA.AdamWConfig(**adam))
    hpt = S.TrainHparams(opts=RunOptions(q_block=32, kv_block=32, remat=False),
                         optimizer=A.AdamWConfig(**adam))
    sj = {"params": pj, "opt": jA.init_opt_state(pj)}
    st = train_state_from_numpy(jax.device_get(sj), "cpu")
    toks = P.synthetic_tokens(P.DataConfig(), 0, 4, 97, cfg.vocab_size)
    extra = P.stub_inputs(cfg_j, n=4, seq=96)
    jb = dict({k: jnp.asarray(v) for k, v in extra.items()},
              tokens=jnp.asarray(toks[:, :-1]), labels=jnp.asarray(toks[:, 1:]))
    tb = dict(params_from_numpy(extra, "cpu"),
              tokens=torch.from_numpy(toks[:, :-1]).long(),
              labels=torch.from_numpy(toks[:, 1:]).long())
    with P.reference_scan_as_loop():
        sj, mj = P.jit(jS.make_train_step(cfg_j, topo, hpj))(sj, jb)
    st, mt = S.make_train_step(cfg, hpt)(st, tb)
    rel = lambda a, b: abs(a - b) / abs(b)
    assert rel(float(mt["loss"]), float(mj["loss"])) <= LOSS_REL
    assert rel(float(mt["grad_norm"]), float(mj["grad_norm"])) <= GRAD_REL
    worst = 0.0
    for part in ("m", "v"):
        for a, b in zip(_leaves(st["opt"][part]),
                        _leaves(jax.device_get(sj["opt"][part]))):
            b = np.asarray(b)
            assert np.abs(b).max() > 0
            err = np.abs(a.numpy() - b).max() / np.abs(b).max()
            assert err <= GRAD_REL, part
            worst = max(worst, err)
    print(f"{arch}: loss {rel(float(mt['loss']), float(mj['loss'])):.3e} "
          f"apart; worst moment {worst:.3e} of its leaf's largest")


# --- the launcher -------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCH_LIST)
def test_serve_cli_runs_on_cpu(arch, capsys):
    P.assert_serve_cli_runs(arch, capsys, prompt=40)


@pytest.mark.parametrize("arch", ARCH_LIST)
def test_entry_points_default_to_the_card(arch):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build(arch, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.init_cache(get(arch).smoke(), 1, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.prompt_batch(get(arch).smoke(), 1, 4, 0)


def test_whisper_encoder_dtypes():
    """The encoder's output is float32 with float32 weights (the stream
    turns float32 at the first residual) and bf16 with bf16 weights,
    whatever the frames' dtype.  (Its input's rounding to bf16 is held by
    the forward test: without it whisper's smoke logits move by ~0.1.)"""
    cfg, params = serve.build("whisper-medium", smoke=True, device="cpu")
    for dt in (torch.bfloat16, torch.float32):
        p = {k: ({kk: vv.to(dt) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(dt))
             for k, v in params.items()}
        for fdt in (torch.bfloat16, torch.float32):
            frames = torch.full((1, cfg.encoder_seq, cfg.d_model), 1 / 3,
                                dtype=fdt)
            assert whisper.encode(cfg, p, frames).dtype == dt
