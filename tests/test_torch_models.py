"""PyTorch port, the model stack of zamba2-1.2b (configs, parameter trees,
layers, Mamba2, the shared block, the hybrid forward), held against the JAX
package on the same weights and inputs at the ``smoke()`` size.

Weights come from the JAX package's ``init_params`` and cross with
``convert.params_from_numpy``.  Tolerances: in bf16 (the working type) a
single module may differ by a rounding or two, because XLA and PyTorch round
some float32 intermediates differently (``rsqrt`` in ``rms_norm``); the
tolerance is a few bf16 ulps (2^-8 relative) of the largest value.  Through
seven chained random layers those one-ulp differences grow about twofold per
layer, so the whole model is held in float32 weights, where only the order
of sums differs."""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.launch.mesh import make_smoke_mesh  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import mamba2 as jM  # noqa: E402
from repro.models import zamba as jZ  # noqa: E402
from repro.models.transformer import RunOptions as JOpts  # noqa: E402
from repro.parallel.sharding import Topology, init_params as jinit  # noqa: E402
from repro_torch.configs.registry import get  # noqa: E402
from repro_torch.convert import (params_from_numpy, params_to_numpy,  # noqa: E402
                                 tensor_from_numpy)
from repro_torch.models import api, moe, zamba  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba2 as M  # noqa: E402
from repro_torch.parallel.sharding import (ONE_DEVICE, ParamSpec,  # noqa: E402
                                           init_params)

ARCH = "zamba2-1.2b"
CPU = "cpu"
BF16_ULP = 2.0 ** -8


def t(a):
    return tensor_from_numpy(np.asarray(a), CPU)


def close_bf16(got, want, ulps=3):
    """|got - want| <= ulps bf16 roundings of the largest |want|."""
    w = np.asarray(want, np.float32)
    g = got.float().numpy()
    tol = ulps * BF16_ULP * max(float(np.abs(w).max()), 1e-6)
    assert np.abs(g - w).max() <= tol, (np.abs(g - w).max(), tol)


@pytest.fixture(scope="module")
def smoke():
    """The smoke config (both packages), its JAX weights and the port's."""
    cfg_j, cfg = JARCHS[ARCH].smoke(), get(ARCH).smoke()
    pj = jinit(japi.param_specs(cfg_j), jax.random.key(0))
    return cfg_j, cfg, pj, params_from_numpy(jax.device_get(pj), CPU)


@pytest.fixture(scope="module")
def topo():
    return Topology(make_smoke_mesh())


# --- configs and parameter trees ----------------------------------------------
def test_config_matches_reference():
    full, ref = get(ARCH), JARCHS[ARCH]
    for c, r in ((full, ref), (full.smoke(), ref.smoke())):
        assert dataclasses.asdict(c) == dataclasses.asdict(r)
        assert (c.vocab_padded, c.d_inner, c.ssm_heads) == \
            (r.vocab_padded, r.d_inner, r.ssm_heads)
    assert full.vocab_padded == 32256
    assert full.n_params() == ref.n_params() == 1_104_693_376


UNPORTED = [("granite-moe-1b-a400m", "moe"), ("deepseek-moe-16b", "moe"),
            ("llava-next-mistral-7b", "vlm"), ("whisper-medium", "audio")]


@pytest.mark.parametrize("name,family", UNPORTED)
def test_registry_and_api_refuse_what_is_not_ported(name, family, topo):
    """What is still unported is refused, naming ROADMAP.md.  The MoE, audio
    and VLM archs are registered and served (test_torch_moe.py,
    test_torch_audio_vlm.py) and have nothing refused: on one device every
    MoE dispatch mode is the local path, as in the reference (the sharded
    modes and the sequence-sharded decode attention run on a mesh of
    ranks, tests/test_torch_mesh.py); their parameter trees and caches are
    the reference's and their decode step is made."""
    from repro.serving import decode as jD
    from repro_torch.serving import decode as D
    assert JARCHS[name].family == family == get(name).family
    if family == "moe":
        cfg = get(name).smoke()
        assert "router" in api.param_specs(cfg)["layers"]
        d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff
        w = [torch.zeros(s) for s in ((d, E), (E, d, f), (E, d, f),
                                      (E, f, d))]
        x = torch.ones((1, 4, d))
        local = moe.moe_ffn(cfg, ONE_DEVICE, x, *w, mode="local")
        for mode in ("rpc", "onesided", "replicated"):
            assert torch.equal(moe.moe_ffn(cfg, ONE_DEVICE, x, *w, mode=mode),
                               local)
        return
    cfg = get(name)
    assert set(api.param_specs(cfg)) == set(japi.param_specs(JARCHS[name]))
    small = cfg.smoke()
    ours = {k: (tuple(shp), str(dt).removeprefix("torch."))
            for k, (shp, _, dt) in D.cache_specs(small, 2, 8).items()}
    ref = {k: (tuple(shp), jnp.dtype(dt).name)
           for k, (shp, _, dt) in jD.cache_specs(JARCHS[name].smoke(), topo,
                                                 2, 8).items()}
    assert ours == ref
    assert callable(D.make_decode_step(small))


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_param_specs_match_reference(size):
    cfg, cfg_j = get(ARCH), JARCHS[ARCH]
    if size == "smoke":
        cfg, cfg_j = cfg.smoke(), cfg_j.smoke()

    def shapes(tree, leaf):
        return {k: shapes(v, leaf) if isinstance(v, dict) else leaf(v)
                for k, v in tree.items()}
    ours = shapes(api.param_specs(cfg), lambda s: (s.shape, s.init, s.scale))
    theirs = shapes(japi.param_specs(cfg_j),
                    lambda s: (tuple(s.shape), s.init, s.scale))
    assert ours == theirs


def test_params_from_numpy_round_trips_bit_exact(smoke):
    _, _, pj, pt = smoke
    ref = jax.device_get(pj)
    back = params_to_numpy(pt)

    def walk(a, b, p):
        if isinstance(a, dict):
            assert a.keys() == b.keys(), p
            for k in a:
                walk(a[k], b[k], p + "/" + k)
        else:
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape, p
            assert a.tobytes() == b.tobytes(), p
    walk(ref, back, "")
    assert pt["embed"].dtype == torch.bfloat16


def test_init_params_is_seeded_and_shaped():
    cfg = get(ARCH).smoke()
    mk = lambda seed: init_params(api.param_specs(cfg),
                                  torch.Generator().manual_seed(seed), CPU)
    a, b, c = mk(0), mk(0), mk(1)
    assert torch.equal(a["layers"]["wz"], b["layers"]["wz"])
    assert not torch.equal(a["layers"]["wz"], c["layers"]["wz"])
    assert bool((a["layers"]["D"] == 1).all())
    assert bool((a["layers"]["A_log"] == 0).all())
    # "scaled": a normal truncated at 2 sigma, over sqrt(shape[0]) (the
    # reference's fan_in, which for stacked layers is the layer count)
    w = a["shared"]["wq"].float()
    assert float(w.abs().max()) <= 2 / np.sqrt(cfg.d_model) * 1.01
    x = ParamSpec((4096,), (None,), "normal", scale=0.02).initialize(
        torch.Generator().manual_seed(3)).float()
    assert abs(float(x.std()) - 0.02) < 2e-3


# --- layers --------------------------------------------------------------------
def _layer_cases():
    rng = np.random.RandomState(4)
    x = jnp.asarray(rng.randn(2, 8, 4, 16), jnp.bfloat16)
    h = jnp.asarray(rng.randn(2, 8, 64) * 3, jnp.bfloat16)
    w = jnp.asarray(rng.randn(64) * 0.1, jnp.bfloat16)
    pos = jnp.arange(8, dtype=jnp.int32)
    cos, sin = jL.rope_tables(pos, 16, 10000.0)
    kc = jnp.asarray(rng.randn(2, 12, 2, 16), jnp.bfloat16)
    vc = jnp.asarray(rng.randn(2, 12, 2, 16), jnp.bfloat16)
    q1 = jnp.asarray(rng.randn(2, 4, 16), jnp.bfloat16)
    lens = jnp.asarray([5, 12], jnp.int32)
    wg, wu = (jnp.asarray(rng.randn(64, 128) * 0.1, jnp.bfloat16) for _ in "gu")
    wd = jnp.asarray(rng.randn(128, 64) * 0.1, jnp.bfloat16)
    cw = jnp.asarray(rng.randn(4, 64) * 0.3, jnp.bfloat16)
    cb = jnp.asarray(rng.randn(64) * 0.1, jnp.bfloat16)
    st = jnp.asarray(rng.randn(2, 3, 64), jnp.bfloat16)
    logits = jnp.asarray(rng.randn(2, 512), jnp.float32)
    return {
        "rms_norm": (lambda: jL.rms_norm(h, w), lambda: L.rms_norm(t(h), t(w))),
        "rope_tables": (lambda: jL.rope_tables(pos, 16, 10000.0)[1],
                        lambda: L.rope_tables(t(pos), 16, 10000.0)[1]),
        "apply_rope": (lambda: jL.apply_rope(x, cos, sin),
                       lambda: L.apply_rope(t(x), t(cos), t(sin))),
        "softcap": (lambda: jL.softcap(logits, 30.0),
                    lambda: L.softcap(t(logits), 30.0)),
        "mask_pad_logits": (lambda: jL.mask_pad_logits(logits, 503),
                            lambda: L.mask_pad_logits(t(logits), 503)),
        "decode_attention": (
            lambda: jL.decode_attention(q1, kc, vc, lens, window=7),
            lambda: L.decode_attention(t(q1), t(kc), t(vc), t(lens), window=7)),
        "swiglu": (lambda: jL.swiglu(h, wg, wu, wd),
                   lambda: L.swiglu(t(h), t(wg), t(wu), t(wd))),
        "causal_conv": (lambda: jM.causal_conv(h, cw, cb, st)[0],
                        lambda: M.causal_conv(t(h), t(cw), t(cb), t(st))[0]),
        "attention_ref": (
            lambda: jL.attention_ref(x, x, x, window=3, attn_softcap=20.0),
            lambda: L.attention_ref(t(x), t(x), t(x), window=3,
                                    attn_softcap=20.0)),
    }


@pytest.mark.parametrize("name", sorted(_layer_cases()))
def test_layer_matches_reference(name):
    ref_fn, port_fn = _layer_cases()[name]
    want, got = ref_fn(), port_fn()
    assert got.dtype == t(np.asarray(want)[:0]).dtype
    if got.dtype == torch.bfloat16:
        close_bf16(got, want, ulps=2)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


# --- modules that hold a kernel --------------------------------------------------
def _layer0(cfg_j, pj, pt):
    return (jax.tree.map(lambda a: a[0], pj["layers"]),
            {k: v[0] for k, v in pt["layers"].items()})


@pytest.mark.parametrize("mode", ["prefill", "decode"])
def test_mamba_block_matches_reference(smoke, topo, mode):
    """One Mamba2 layer (prefill through ssd_scan, or one decode step),
    returning its conv and SSM states."""
    cfg_j, cfg, pj, pt = smoke
    lj, lt = _layer0(cfg_j, pj, pt)
    rng = np.random.RandomState(6)
    S = 64 if mode == "prefill" else 1           # two chunks of 32
    h = jnp.asarray(rng.randn(2, S, cfg.d_model), jnp.bfloat16)
    K, di, GN = cfg.conv_width, cfg.d_inner, cfg.ssm_state
    if mode == "prefill":
        cs = tuple(jnp.zeros((2, K - 1, c), jnp.bfloat16) for c in (di, GN, GN))
        ss = None
    else:
        cs = tuple(jnp.asarray(rng.randn(2, K - 1, c), jnp.bfloat16)
                   for c in (di, GN, GN))
        ss = jnp.asarray(rng.randn(2, cfg.ssm_heads, GN, cfg.ssm_head_dim),
                         jnp.float32)
    hj, (csj, ssj) = jM.mamba_block(cfg_j, topo, lj, h, conv_state=cs,
                                    ssm_state=ss, decode=mode == "decode")
    ht, (cst, sst) = M.mamba_block(cfg, lt, t(h), conv_state=tuple(map(t, cs)),
                                   ssm_state=None if ss is None else t(ss),
                                   decode=mode == "decode")
    close_bf16(ht, hj)
    for a, b in zip(cst, csj):
        close_bf16(a, b)
    np.testing.assert_allclose(sst.numpy(), np.asarray(ssj), rtol=0,
                               atol=3 * BF16_ULP * float(np.abs(ssj).max()))


def test_shared_block_matches_reference(smoke, topo):
    """The shared decoder layer (attention through flash_attention, then the
    SwiGLU FFN)."""
    cfg_j, cfg, pj, pt = smoke
    rng = np.random.RandomState(7)
    S = 40                  # ragged against the reference's blocks of 16
    h = jnp.asarray(rng.randn(2, S, cfg.d_model), jnp.bfloat16)
    cos, sin = jL.rope_tables(jnp.arange(S, dtype=jnp.int32), cfg.head_dim,
                              cfg.rope_theta)
    want = jZ.shared_block(cfg_j, topo, pj["shared"], h, cos, sin,
                           JOpts(q_block=16, kv_block=16, remat=False))
    got = zamba.shared_block(cfg, pt["shared"], t(h), t(cos), t(sin))
    close_bf16(got, want)


def test_zamba_forward_matches_reference(smoke, topo):
    """The hybrid forward's logits, in float32 weights; api.forward is
    zamba.forward."""
    cfg_j, cfg, pj, _ = smoke
    pj32 = jax.tree.map(lambda a: a.astype(jnp.float32), pj)
    pt32 = params_from_numpy(jax.device_get(pj32), CPU)
    from repro.data.pipeline import DataConfig, synthetic_tokens
    toks = synthetic_tokens(DataConfig(), 0, 2, 64, cfg.vocab_size)
    want = japi.forward(cfg_j, topo, pj32, {"tokens": jnp.asarray(toks)},
                        opts=JOpts(q_block=16, kv_block=16, remat=False))
    tt = torch.from_numpy(toks).long()
    got = api.forward(cfg, pt32, {"tokens": tt})
    V = cfg.vocab_size
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got[..., :V].numpy(), np.asarray(want)[..., :V],
                               atol=2e-3, rtol=1e-3)
    assert bool((got[..., V:] == -1e30).all())
    assert torch.equal(zamba.forward(cfg, pt32, tt), got)
