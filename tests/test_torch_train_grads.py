"""PyTorch port, training: the kernels' gradients on the CPU (flash
attention and the SSD scan against ``jax.grad`` of the reference's plain
functions, MoE capacity drops, the autograd wrappers); limits in
``tests/torch_train_common.py``."""

import torch_threads  # noqa: F401  (first: pins torch's threads)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from torch_train_common import (fa, get, JARCHS, jL, jM, jnp, L, M, ONE_DEVICE,
    ops, rel_err, smoke_topology, ss)  # noqa: E402


@pytest.fixture(scope="module")
def topo():
    return smoke_topology()


# --- the kernels' gradients on the CPU ------------------------------------------------
ATTN_CASES = [
    # (B, Sq, Hq, Hkv, D, causal, window, softcap, q_block, kv_block)
    (2, 96, 4, 4, 16, True, None, None, 32, 32),
    (1, 80, 4, 2, 16, True, 24, None, 32, 16),        # window, GQA, ragged
    (2, 64, 2, 2, 32, True, None, 20.0, 16, 32),      # softcap
    (1, 48, 8, 2, 16, False, None, None, 16, 16),     # not causal, GQA 4
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_gradients_match_jax(case):
    """Gradients of ``block_attention_jnp`` against ``jax.grad`` of the
    reference's jnp ``block_attention``, float32, with the Function (the
    kernel's dispatch, the plain version on the CPU) giving the same
    gradients as ``block_attention_jnp``."""
    Bn, Sq, Hq, Hkv, D, causal, window, cap, qb, kb = case
    rng = np.random.RandomState(1)
    q, w = (rng.randn(Bn, Sq, Hq, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(Bn, Sq, Hkv, D).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, attn_softcap=cap)

    def jf(q, k, v):
        o = jL.block_attention(q, k, v, q_block=qb, kv_block=kb, **kw)
        return jnp.sum(o * w)
    want = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    def grads(fn):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = fn(*leaves)
        return out, torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                        leaves)
    out_j, got = grads(lambda *a: L.block_attention_jnp(
        *a, q_block=qb, kv_block=kb, **kw))
    launched = fa.launches
    out_f, through = grads(lambda *a: L.block_attention(
        *a, q_block=qb, kv_block=kb, **kw))
    assert fa.launches == launched            # the CPU launches nothing
    for a, b, c in zip(got, through, want):
        assert rel_err(a.numpy(), np.asarray(c)) <= 1e-5
        assert torch.equal(a, b)
        assert float(a.abs().max()) > 0
    ref = jL.attention_ref(*map(jnp.asarray, (q, k, v)), **kw)
    assert rel_err(out_j.detach().numpy(), ref) <= 1e-5
    assert rel_err(out_f.detach().numpy(), ref) <= 1e-5


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_gradients_match_jax(with_state):
    """Gradients of ``mamba2.ssd_chunked`` (through ``ops.ssd_scan``'s
    Function, whose backward differentiates ``ssd_scan_plain``) against
    ``jax.grad`` of the reference's ``ssd_chunked``, float32."""
    rng = np.random.RandomState(2)
    Bn, Sn, H, P, N, Q = 2, 96, 4, 8, 16, 32
    xh = rng.randn(Bn, Sn, H, P).astype(np.float32)
    dt = (np.log1p(np.exp(rng.randn(Bn, Sn, H))) * 0.5).astype(np.float32)
    Av = -np.exp(rng.randn(H) * 0.3).astype(np.float32)
    Bm, Cm = (rng.randn(Bn, Sn, N).astype(np.float32) for _ in range(2))
    s0 = rng.randn(Bn, H, N, P).astype(np.float32) if with_state else None
    wy = rng.randn(Bn, Sn, H, P).astype(np.float32)
    ws = rng.randn(Bn, H, N, P).astype(np.float32)
    ins = [xh, dt, Av, Bm, Cm] + ([s0] if with_state else [])

    def jf(xh, dt, Av, Bm, Cm, *s):
        y, st = jM.ssd_chunked(xh, dt, Av, Bm, Cm, Q,
                               init_state=s[0] if s else None)
        return jnp.sum(y * wy) + jnp.sum(st * ws)
    want = jax.grad(jf, argnums=tuple(range(len(ins))))(*map(jnp.asarray, ins))
    leaves = [torch.from_numpy(x).requires_grad_() for x in ins]
    launched = ss.launches
    y, st = M.ssd_chunked(*leaves[:5], Q,
                          init_state=leaves[5] if with_state else None)
    assert ss.launches == launched
    got = torch.autograd.grad((y * torch.from_numpy(wy)).sum()
                              + (st * torch.from_numpy(ws)).sum(), leaves)
    for a, b in zip(got, want):
        assert rel_err(a.numpy(), np.asarray(b)) <= 1e-5
        assert float(a.abs().max()) > 0


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-moe-16b"])
def test_moe_capacity_drops_carry_no_gradient(arch, topo):
    """At a capacity of 2 slots an expert most assignments are dropped: the
    MoE layer's gradients (input, router, experts) equal ``jax.grad`` of the
    reference's in float32, and a token whose every assignment was dropped
    gets no gradient through the layer (the scatter's backward is a gather
    that never reads the sentinel cell)."""
    import dataclasses
    from repro.models import moe as jmoe
    from repro_torch.models import moe
    cfg_j = dataclasses.replace(JARCHS[arch].smoke(), capacity_factor=0.05)
    cfg = dataclasses.replace(get(arch).smoke(), capacity_factor=0.05)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    rng = np.random.RandomState(4)
    ins = [rng.randn(4, 16, d), rng.randn(d, E) * 0.3,
           rng.randn(E, d, f) * 0.2, rng.randn(E, d, f) * 0.2,
           rng.randn(E, f, d) * 0.2]
    ins = [a.astype(np.float32) for a in ins]
    w = rng.randn(4, 16, d).astype(np.float32)

    def jf(*a):
        return jnp.sum(jmoe.moe_ffn(cfg_j, topo, *a) * w)
    want = jax.grad(jf, argnums=tuple(range(5)))(*map(jnp.asarray, ins))
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    got = torch.autograd.grad((moe.moe_ffn(cfg, ONE_DEVICE, *leaves)
                               * torch.from_numpy(w)).sum(), leaves)
    for a, b in zip(got, want):
        assert rel_err(a.numpy(), np.asarray(b)) <= 1e-5
    _, _, meta = moe.route(cfg, leaves[0].detach(), leaves[1].detach())
    dropped = ~meta[4].reshape(-1, cfg.top_k).any(-1)
    assert moe.capacity(cfg, 64) == 2 and dropped.sum() >= 32
    assert float(got[0].reshape(-1, d)[dropped].abs().max()) == 0.0
    assert float(got[0].reshape(-1, d)[~dropped].abs().max()) > 0


def test_functions_only_under_grad():
    """Without grad, or with no input requiring it, the wrappers return
    what the kernels' dispatch returns, with no autograd node."""
    q = torch.randn(1, 32, 2, 16, requires_grad=True)
    with torch.no_grad():
        assert ops.flash_attention(q, q, q).grad_fn is None
    assert ops.flash_attention(q.detach(), q.detach(), q.detach()).grad_fn is None
    assert type(ops.flash_attention(q, q, q).grad_fn).__name__ == \
        "FlashAttentionBackward"
    x = torch.randn(1, 1, 8, 2, 16, requires_grad=True)
    dA, Bc = -torch.rand(1, 1, 8, 2), torch.randn(1, 1, 8, 16)
    y, _ = ops.ssd_scan(x, dA, Bc, Bc, h_tile=1)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    with torch.no_grad():
        assert ops.ssd_scan(x, dA, Bc, Bc, h_tile=1)[0].grad_fn is None
