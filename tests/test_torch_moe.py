"""PyTorch port, the MoE family (granite-moe-1b-a400m, deepseek-moe-16b):
configs, parameter trees, the cost model, the MoE layer's router, routing,
combine and FFN against the JAX package's functions on the same numpy
inputs, then each arch's forward, prefill and decode at its ``smoke()`` size
(the harness and its tolerances are in torch_parity.py), and the launcher.

Routing decisions (the experts chosen, each assignment's cell, which
assignments are kept) must be bit-equal to the reference's; outputs agree
within 1e-5 relative in float32 and within 2 bf16 ulps of the largest value
in bf16.  Cases force ties in the top-k (equal router columns, a zero hidden
row), a capacity that drops assignments, and decode's capacity of 1."""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

import torch_parity as P  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.core import cost_model as jcost  # noqa: E402
from repro.core import nic as jnic  # noqa: E402
from repro.launch.mesh import make_smoke_mesh  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.parallel.sharding import Topology, init_params as jinit  # noqa: E402
from repro_torch.configs.registry import get  # noqa: E402
from repro_torch.convert import (params_from_numpy, params_to_numpy,  # noqa: E402
                                 tensor_from_numpy)
from repro_torch.core import cost_model, nic  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api, moe  # noqa: E402
from repro_torch.parallel.sharding import (ONE_DEVICE,  # noqa: E402
                                           AbstractMesh)
from repro_torch.parallel.sharding import Topology as PTopology  # noqa: E402
from repro_torch.serving import decode as D  # noqa: E402

MOE = ["granite-moe-1b-a400m", "deepseek-moe-16b"]
BF16_ULP = 2.0 ** -8
F32_RTOL = 1e-5


@pytest.fixture(scope="module", params=MOE)
def runs(request):
    return P.family_runs(request.param)


@pytest.fixture(scope="module")
def topo():
    return Topology(make_smoke_mesh())


# --- configs and parameter trees ---------------------------------------------
@pytest.mark.parametrize("arch", MOE)
def test_config_matches_reference(arch):
    P.assert_config_matches(arch)
    for c, r in ((get(arch), JARCHS[arch]),
                 (get(arch).smoke(), JARCHS[arch].smoke())):
        assert c.n_active_params() == r.n_active_params()
    assert get(arch).family == "moe"


def test_config_sizes():
    d = get("deepseek-moe-16b")
    assert (d.n_params(), d.n_active_params()) == (16_669_736_960,
                                                   2_620_915_712)
    assert (d.n_experts, d.top_k, d.n_shared_experts, d.router_renorm,
            d.capacity_factor) == (64, 6, 2, True, 1.25)
    g = get("granite-moe-1b-a400m")
    assert (g.n_params(), g.n_active_params()) == (1_334_578_176, 428_608_512)
    assert (g.n_experts, g.top_k, g.n_shared_experts, g.router_renorm) == \
        (32, 8, 0, False)


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", MOE)
def test_param_specs_match_reference(arch, size):
    P.assert_param_specs_match(arch, size)
    layers = api.param_specs(get(arch))["layers"]
    assert "w_gate" not in layers and "router" in layers
    assert ("ws_gate" in layers) == bool(get(arch).n_shared_experts)


@pytest.mark.parametrize("arch", MOE)
def test_convert_round_trips_the_moe_tree_bit_exact(arch):
    """The reference's bf16 MoE tree (router, stacked experts, shared
    experts) into the port and back, bit for bit."""
    cfg_j = JARCHS[arch].smoke()
    pj = jax.device_get(jinit(japi.param_specs(cfg_j), jax.random.key(3)))
    back = params_to_numpy(params_from_numpy(pj, P.CPU))
    flat_j = jax.tree_util.tree_leaves_with_path(pj)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, a in flat_j:
        b = flat_b[path]
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert np.array_equal(a.view(np.uint16), b.view(np.uint16)), path
    assert pj["layers"]["we_gate"].shape == (cfg_j.n_layers, cfg_j.n_experts,
                                             cfg_j.d_model, cfg_j.d_ff)


# --- the MoE layer against the reference's functions -------------------------
def _layer_cfg(arch, **kw):
    return (dataclasses.replace(get(arch).smoke(), **kw),
            dataclasses.replace(JARCHS[arch].smoke(), **kw))


def _inputs(cfg, T, seed, dtype=np.float32, router_scale=1.0):
    r = np.random.RandomState(seed)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    x = r.randn(T, d).astype(np.float32)
    rw = (r.randn(d, E) * router_scale / np.sqrt(d)).astype(np.float32)
    wg = (r.randn(E, d, f) / np.sqrt(d)).astype(np.float32)
    wu = (r.randn(E, d, f) / np.sqrt(d)).astype(np.float32)
    wd = (r.randn(E, f, d) / np.sqrt(f)).astype(np.float32)
    return [a.astype(dtype) for a in (x, rw, wg, wu, wd)]


def _t(a):
    return tensor_from_numpy(np.asarray(a), P.CPU)


def _routing(cfg, cfg_j, x, rw):
    """Both packages' router and route at the local path's capacity:
    (port (topv, topi, meta), reference (topv, topi, meta), capacity)."""
    T = x.shape[0]
    C = moe.capacity(cfg, T)
    tv, ti = moe._router(cfg, _t(x), _t(rw))
    _, meta = moe._route(_t(x), tv, ti, cfg.n_experts, 0, C)
    jv, ji = jmoe._router(cfg_j, jnp.asarray(x), jnp.asarray(rw))
    _, jmeta = jmoe._route(jnp.asarray(x), jv, ji, cfg_j.n_experts,
                           jnp.int32(0), C)
    return (tv, ti, meta), (np.asarray(jv), np.asarray(ji), jmeta), C


def _assert_routing_equal(ours, theirs):
    (tv, ti, meta), (jv, ji, jmeta) = ours, theirs
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=F32_RTOL, atol=1e-7)
    for name, a, b in zip(("dst_e", "dst_c", "tok", "w", "keep"), meta,
                          jmeta):
        b = np.asarray(b)
        if name == "w":
            np.testing.assert_allclose(a.numpy(), b, rtol=F32_RTOL, atol=1e-7)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def _ffn_both(cfg, cfg_j, topo, x3, ws):
    got = moe.moe_ffn(cfg, ONE_DEVICE, _t(x3), *map(_t, ws))
    want = jmoe.moe_ffn(cfg_j, topo, jnp.asarray(x3),
                        *map(jnp.asarray, ws))
    return got, np.asarray(want.astype(jnp.float32))


def _close(got, want, dtype):
    g = got.float().numpy()
    scale = float(np.abs(want).max())
    if dtype == "float32":
        tol = F32_RTOL * scale
    else:
        tol = 2 * BF16_ULP * scale
    assert np.abs(g - want).max() <= tol, (np.abs(g - want).max(), tol)


def test_top_k_breaks_ties_to_the_lower_index():
    """lax.top_k's order: the lowest index first among equal values."""
    for row, k in (([1, 3, 3, 2, 3, 0], 2), ([0.0] * 64, 6),
                   ([2, 2, 1, 2, 2, 2, 0, 2], 5)):
        x = np.asarray([row], np.float32)
        jv, ji = lax.top_k(jnp.asarray(x), k)
        v, i = moe._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_layer_matches_reference(arch, dtype, topo):
    """B 2 x S 48 tokens at the smoke widths: routing bit-equal, the layer's
    output within tolerance."""
    import ml_dtypes
    cfg, cfg_j = _layer_cfg(arch)
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    x, *ws = _inputs(cfg, 96, seed=1, dtype=dt)
    ours, theirs, C = _routing(cfg, cfg_j, x, ws[0])
    _assert_routing_equal(ours, theirs)
    got, want = _ffn_both(cfg, cfg_j, topo, x.reshape(2, 48, -1), ws)
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 48,
                                                                cfg.d_model)
    _close(got, want, dtype)


@pytest.mark.parametrize("arch", MOE)
def test_route_and_combine_match_reference(arch):
    """_route's buffer and _combine's output from the same routing, and
    _expert_ffn on that buffer, each against the reference's."""
    cfg, cfg_j = _layer_cfg(arch)
    x, rw, wg, wu, wd = _inputs(cfg, 40, seed=2)
    C = moe.capacity(cfg, 40)
    jv, ji = jmoe._router(cfg_j, jnp.asarray(x), jnp.asarray(rw))
    jbuf, jmeta = jmoe._route(jnp.asarray(x), jv, ji, cfg.n_experts,
                              jnp.int32(0), C)
    buf, meta = moe._route(_t(x), _t(jv), _t(ji), cfg.n_experts, 0, C)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    jout = jmoe._expert_ffn(jbuf, *map(jnp.asarray, (wg, wu, wd)))
    out = moe._expert_ffn(buf, *map(_t, (wg, wu, wd)))
    _close(out, np.asarray(jout), "float32")
    got = moe._combine(_t(jout), meta, 40, cfg.d_model)
    want = np.asarray(jmoe._combine(jout, jmeta, 40, cfg.d_model))
    _close(got, want, "float32")


@pytest.mark.parametrize("case", ["equal_columns", "zero_row"])
@pytest.mark.parametrize("arch", MOE)
def test_forced_ties_pick_the_reference_experts(arch, case, topo):
    """Equal router columns (experts 1 = 2 and 0 = 3) tie every token's
    logits; a zero hidden row ties all of that token's experts.  The port
    picks the reference's experts, so the layer's output agrees too."""
    cfg, cfg_j = _layer_cfg(arch)
    x, rw, *ws = _inputs(cfg, 32, seed=3)
    if case == "equal_columns":
        rw[:, 2] = rw[:, 1]
        rw[:, 3] = rw[:, 0]
    else:
        x[5] = 0.0
        x[17] = 0.0
    ours, theirs, _ = _routing(cfg, cfg_j, x, rw)
    tv = ours[0].numpy()
    assert (np.diff(tv, axis=-1) == 0).any(), "no tie was forced"
    _assert_routing_equal(ours, theirs)
    if case == "zero_row":          # all experts tie: the lowest k win
        np.testing.assert_array_equal(ours[1][5].numpy(),
                                      np.arange(cfg.top_k))
    got, want = _ffn_both(cfg, cfg_j, topo, x.reshape(2, 16, -1), [rw] + ws)
    _close(got, want, "float32")


@pytest.mark.parametrize("arch", MOE)
def test_capacity_drops_as_the_reference_drops(arch, topo):
    """A router biased towards expert 0: more assignments than its capacity,
    so some are dropped (their weight zeroed), the same ones as the
    reference drops."""
    cfg, cfg_j = _layer_cfg(arch)
    x, rw, *ws = _inputs(cfg, 64, seed=4)
    x[:, 0] = np.abs(x[:, 0]) + 2.0
    rw[0, 0] = 8.0
    ours, theirs, C = _routing(cfg, cfg_j, x, rw)
    keep = ours[2][4].numpy()
    dst_e = ours[2][0].numpy()
    assert not keep.all(), "nothing was dropped"
    assert (ours[1].numpy().reshape(-1)[~keep] == 0).all()
    assert (dst_e[~keep] == cfg.n_experts).all()
    _assert_routing_equal(ours, theirs)
    got, want = _ffn_both(cfg, cfg_j, topo, x.reshape(4, 16, -1), [rw] + ws)
    _close(got, want, "float32")


def test_decode_capacity_of_one(topo):
    """deepseek-moe-16b's decode at B 8: 64 experts, top 6, so each expert
    takes one of the 48 assignments a step (capacity
    max(1, ceil(8 * 6 / 64 * 1.25)) = 1) and the rest are dropped, as in the
    reference; the layer runs on (B, 1, d) as the decode step calls it."""
    cfg, cfg_j = _layer_cfg("deepseek-moe-16b", n_experts=64, top_k=6)
    assert moe.capacity(cfg, 8) == 1
    x, rw, *ws = _inputs(cfg, 8, seed=5, router_scale=4.0)
    ours, theirs, C = _routing(cfg, cfg_j, x, rw)
    assert C == 1
    keep = ours[2][4].numpy()
    assert 0 < keep.sum() < keep.size
    _assert_routing_equal(ours, theirs)
    got, want = _ffn_both(cfg, cfg_j, topo, x[:, None], [rw] + ws)
    assert got.shape == (8, 1, cfg.d_model)
    _close(got, want, "float32")


# --- dispatch modes and the cost model ---------------------------------------
class _AxisSizes:
    """A stand-in for the reference's Topology: only ``axis_sizes``."""

    def __init__(self, tp):
        self.axis_sizes = {"model": tp}


@pytest.mark.parametrize("arch", MOE)
def test_dispatch_mode_matches_reference(arch):
    cfg, cfg_j = get(arch), JARCHS[arch]
    for tokens in (8, 512, 4096, 32768):
        assert moe.moe_dispatch_mode(cfg, ONE_DEVICE, tokens) == "local"
        for tp in (2, 3, 4, 8, 16):
            topo = PTopology(AbstractMesh(("data", "model"), (1, tp)))
            assert moe.moe_dispatch_mode(cfg, topo, tokens) == \
                jmoe.moe_dispatch_mode(cfg_j, _AxisSizes(tp), tokens), (tp,
                                                                       tokens)


@pytest.mark.parametrize("mode", ["rpc", "onesided", "replicated"])
def test_sharded_modes_wait_for_the_mesh(mode):
    """At tp 1 the sharded modes are the local path, as in the reference
    (over a larger model axis they run on a mesh of ranks:
    tests/test_torch_mesh.py)."""
    cfg, _ = _layer_cfg("granite-moe-1b-a400m")
    x, *ws = _inputs(cfg, 8, seed=6)
    x3 = _t(x.reshape(2, 4, -1))
    local = moe.moe_ffn(cfg, ONE_DEVICE, x3, *map(_t, ws), mode="local")
    assert torch.equal(moe.moe_ffn(cfg, ONE_DEVICE, x3, *map(_t, ws),
                                   mode=mode), local)
    with pytest.raises(ValueError):
        moe.moe_ffn(cfg, ONE_DEVICE, x3, *map(_t, ws), mode="nearest")


def _fields(c):
    return dataclasses.astuple(c) + (c.ratio,)


def test_cost_model_matches_reference():
    """Every choice on a grid, field for field (pure Python floats)."""
    fabrics = [(cost_model.Fabric(), jcost.Fabric())]
    for mode in nic.MODES:
        for n in (4, 96):
            fabrics.append((
                cost_model.Fabric().with_nic(nic.ConnTable(n, 20, mode)),
                jcost.Fabric().with_nic(jnic.ConnTable(n, 20, mode))))
    assert dataclasses.asdict(cost_model.Fabric()) == \
        dataclasses.asdict(jcost.Fabric())
    n = 0
    for fab, jfab in fabrics:
        assert dataclasses.asdict(fab) == dataclasses.asdict(jfab)
        for shards in (2, 4, 16):
            for tokens in (1, 8, 4096, 32768):
                for arch in MOE:
                    c = get(arch)
                    kw = dict(tokens_per_shard=tokens, d_model=c.d_model,
                              d_ff=c.d_ff, n_experts=c.n_experts,
                              top_k=c.top_k, shards=shards)
                    assert _fields(cost_model.moe_dispatch_choice(
                        **kw, fabric=fab)) == _fields(
                        jcost.moe_dispatch_choice(**kw, fabric=jfab))
                    kw = dict(tokens_per_shard=tokens, d_model=c.d_model,
                              vocab=c.vocab_padded, shards=shards)
                    assert _fields(cost_model.embedding_lookup_choice(
                        **kw, fabric=fab)) == _fields(
                        jcost.embedding_lookup_choice(**kw, fabric=jfab))
                    kw = dict(seq_len=tokens, n_kv_heads=c.n_kv_heads,
                              n_q_heads=c.n_heads, head_dim=c.head_dim,
                              batch_per_shard=8, shards=shards)
                    assert _fields(cost_model.decode_attention_choice(
                        **kw, fabric=fab)) == _fields(
                        jcost.decode_attention_choice(**kw, fabric=jfab))
                    n += 3
        for a, b in ((1e6, 2e6), (3e9, 1e3), (0.0, 0.0)):
            for rounds in (1.0, 3.0):
                assert _fields(cost_model.choose(
                    a, b, rounds, 1.0, fab, 1e12)) == _fields(
                    jcost.choose(a, b, rounds, 1.0, jfab, 1e12))
    assert n == 7 * 3 * 4 * 2 * 3


# --- the model and its serving path against the JAX package ------------------
def test_forward_matches_reference(runs):
    got, want = runs["forward"]
    assert got.shape == (P.B, P.FORWARD_LEN, runs["cfg"].vocab_padded)
    P.assert_logits_match(runs["cfg"], got, want, P.FORWARD_TOL)


@pytest.mark.parametrize("step", range(P.DECODE + 1))
def test_prefill_decode_logits_match_reference(runs, step):
    """Step 0 is the prefill's last position, steps 1.. the decode steps
    (each routes the batch's B tokens at capacity 1 or more)."""
    got, want = runs["steps"][step]
    assert got.shape == (P.B, runs["cfg"].vocab_padded)
    P.assert_logits_match(runs["cfg"], got, want, P.LOGIT_TOL)


@pytest.mark.parametrize("when", ["prefill", "decode"])
def test_cache_matches_reference(runs, when):
    got, want = runs["prefill_cache" if when == "prefill" else "cache"]
    n = P.PROMPT + (P.DECODE if when == "decode" else 0)
    P.assert_cache_matches(got, want, n)
    cfg = runs["cfg"]
    assert set(got) == {"k", "v", "len"}
    assert tuple(got["k"].shape) == (cfg.n_layers, P.B, P.PROMPT + P.DECODE,
                                     cfg.n_kv_heads, cfg.head_dim)


@pytest.mark.parametrize("arch", MOE)
def test_serve_cli_runs_on_cpu(arch, capsys):
    P.assert_serve_cli_runs(arch, capsys, prompt=96)


@pytest.mark.parametrize("arch", MOE)
def test_entry_points_default_to_the_card(arch):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal where there is no CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.build(arch, smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        D.init_cache(get(arch).smoke(), 1, 4)
