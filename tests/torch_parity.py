"""Shared harness of the family tests (tests/test_torch_dense.py,
test_torch_ssm.py, test_torch_moe.py, test_torch_audio_vlm.py): one arch of
the port against the JAX package at its ``smoke()`` size.

``family_runs(arch)`` runs both packages on the same float32 weights (the
JAX package's ``init_params``, carried across by
``convert.params_from_numpy``), the same seeded tokens and, for the audio
and VLM families, the same frames or patch embeddings (the reference's
``synthetic_batch``): the forward logits, the prefill's last-position
logits and cache, ``DECODE`` decode steps and the final cache.  The
reference's whisper encoder rounds its input to bf16, so with float32
weights its scanned carry would turn float32 after the first layer, which
``lax.scan`` refuses; ``reference_scan_as_loop`` runs that module's scans as
Python loops (the same arithmetic; tested equal to the scan in bf16).  The
JAX side is compiled with XLA's excess precision off (``jit``): by default
XLA may skip a rounding to bf16 that the code writes (the encoder's
``astype``, ``layer_norm``'s cast back), which moves whisper's smoke logits
by ~0.1 from the eager reference's; with it off the jitted and eager
reference agree to ~2e-6.  The JAX side is jitted (``make_prefill``,
``make_decode_step``, ``api.forward``) on a Topology built with
``repro.launch.mesh.make_smoke_mesh()`` (Auto axes; see ROADMAP.md section
3).  In float32 weights only the order of sums differs; in bf16 one-ulp
differences grow through chained random layers (see test_torch_models.py),
so the bf16 path is held to the port's own teacher-forced forward.
"""
import contextlib
import dataclasses
import types

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs.registry import ARCHS as JARCHS
from repro.configs.base import ShapeConfig as JShape
from repro.data.pipeline import DataConfig, synthetic_batch, synthetic_tokens
from repro.launch.mesh import make_smoke_mesh
from repro.models import api as japi
from repro.models.transformer import RunOptions as JOpts
from repro.parallel.sharding import Topology, init_params as jinit
from repro.serving.decode import make_decode_step as jstep
from repro.serving.decode import make_prefill as jprefill
from repro_torch.configs.registry import get
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import api
from repro_torch.serving import decode as D

CPU = "cpu"
# a prompt of 96: longer than gemma2's smoke window of 64, so its local
# layers differ from its global ones, and three SSD chunks of 32; the
# forward runs over 128 tokens (whole SSD chunks), which cover the prompt and
# the decode steps' tokens
B, PROMPT, DECODE, FORWARD_LEN = 2, 96, 4, 128
LOGIT_TOL = dict(atol=1e-3, rtol=1e-3)     # float32 weights, serving
FORWARD_TOL = dict(atol=2e-3, rtol=1e-3)   # float32 weights, whole sequence
CACHE_RTOL = 5e-4                          # of the largest |value| per entry


def assert_greedy(got, want):
    """argmax must agree unless the reference's own top-2 margin is within
    4x the observed deviation (tests/test_serving.py's rule)."""
    margin = np.sort(want, -1)[..., -1] - np.sort(want, -1)[..., -2]
    flip = np.argmax(got, -1) != np.argmax(want, -1)
    dev = np.abs(got - want).max()
    assert not np.any(flip & (margin > 4 * dev)), (margin, dev)


def assert_config_matches(arch):
    full, ref = get(arch), JARCHS[arch]
    for c, r in ((full, ref), (full.smoke(), ref.smoke())):
        assert dataclasses.asdict(c) == dataclasses.asdict(r)
        assert c.vocab_padded == r.vocab_padded
        assert c.n_params() == r.n_params()


def spec_tree(tree, leaf):
    return {k: spec_tree(v, leaf) if isinstance(v, dict) else leaf(v)
            for k, v in tree.items()}


def assert_param_specs_match(arch, size):
    cfg, cfg_j = get(arch), JARCHS[arch]
    if size == "smoke":
        cfg, cfg_j = cfg.smoke(), cfg_j.smoke()
    ours = spec_tree(api.param_specs(cfg), lambda s: (s.shape, s.init, s.scale,
                                                      str(s.dtype)))
    theirs = spec_tree(japi.param_specs(cfg_j),
                       lambda s: (tuple(s.shape), s.init, s.scale,
                                  "torch." + np.dtype(s.dtype).name))
    assert ours == theirs


KV_CACHE = ("k", "v", "shared_k", "shared_v")
STUB_INPUTS = ("frames", "patch_embeds")


def jit(f):
    """``jax.jit`` with every bf16 rounding the code writes kept."""
    return jax.jit(f, compiler_options={"xla_allow_excess_precision": False})


def loop_scan(f, init, xs):
    """``lax.scan`` as a Python loop over the leading axis of xs: the same
    steps, but the carry may change dtype."""
    n = jax.tree.leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in range(n):
        carry, y = f(carry, jax.tree.map(lambda a: a[i], xs))
        ys.append(y)
    if ys[0] is None:
        return carry, None
    return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)


@contextlib.contextmanager
def reference_scan_as_loop():
    """While tracing, the reference's ``repro.models.whisper`` scans as
    :func:`loop_scan`."""
    from repro.models import whisper as jw
    saved = jw.lax
    jw.lax = types.SimpleNamespace(scan=loop_scan)
    try:
        yield
    finally:
        jw.lax = saved


def stub_inputs(cfg_j, n=B, seq=FORWARD_LEN, step=0):
    """The reference's frames (audio) or patch embeddings (VLM) of its
    synthetic batch, as numpy (bf16), {} for the other families."""
    b = synthetic_batch(cfg_j, JShape("t", seq, n, "train"), DataConfig(),
                        step)
    return {k: jax.device_get(b[k]) for k in STUB_INPUTS if k in b}


def pad_kv(cache, extra):
    """The reference's cache with ``extra`` zero positions on its K/V
    regions (the port's prefill leaves that room itself)."""
    pad = ((0, 0), (0, 0), (0, extra), (0, 0), (0, 0))
    return {k: jnp.pad(v, pad) if k in KV_CACHE else v
            for k, v in cache.items()}


def family_runs(arch):
    """Both packages on one arch's smoke config, in float32 weights."""
    cfg_j, cfg = JARCHS[arch].smoke(), get(arch).smoke()
    topo = Topology(make_smoke_mesh())
    pj = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jinit(japi.param_specs(cfg_j), jax.random.key(0)))
    pt = params_from_numpy(jax.device_get(pj), CPU)
    toks = synthetic_tokens(DataConfig(), 0, B, FORWARD_LEN, cfg.vocab_size)
    tt = torch.from_numpy(toks).long()
    opts = JOpts(q_block=16, kv_block=16, remat=False)
    extra = stub_inputs(cfg_j)
    xj = {k: jnp.asarray(v) for k, v in extra.items()}
    xt = params_from_numpy(extra, CPU)

    with reference_scan_as_loop():
        fj = jit(lambda p, b: japi.forward(cfg_j, topo, p, b, opts=opts))(
            pj, dict(xj, tokens=jnp.asarray(toks)))
        lj, cj = jit(jprefill(cfg_j, topo, PROMPT, opts))(
            pj, dict(xj, tokens=jnp.asarray(toks[:, :PROMPT])))
    forward = (api.forward(cfg, pt, dict(xt, tokens=tt)).numpy(),
               np.asarray(fj))
    lt, ct = D.make_prefill(cfg, PROMPT, room=DECODE)(
        pt, dict(xt, tokens=tt[:, :PROMPT]))
    cj = pad_kv(cj, DECODE)
    prefill_cache = ({k: v.clone() for k, v in ct.items()},
                     jax.device_get(cj))
    steps = [(lt.numpy(), np.asarray(lj))]
    sj, st = jit(jstep(cfg_j, topo)), D.make_decode_step(cfg)
    for i in range(PROMPT, PROMPT + DECODE):
        lj, cj = sj(pj, cj, jnp.asarray(toks[:, i]))
        lt, ct = st(pt, ct, tt[:, i])
        steps.append((lt.numpy(), np.asarray(lj)))
    return {"cfg": cfg, "forward": forward, "steps": steps,
            "prefill_cache": prefill_cache,
            "cache": (ct, jax.device_get(cj))}


def assert_logits_match(cfg, got, want, tol):
    V = cfg.vocab_size
    assert got.shape == want.shape and got.shape[-1] == cfg.vocab_padded
    assert got.dtype == np.float32
    np.testing.assert_allclose(got[..., :V], want[..., :V], **tol)
    assert_greedy(got[..., :V], want[..., :V])
    assert bool((got[..., V:] == -1e30).all())


def assert_cache_matches(got, want, length):
    """Every entry: shape, and values within CACHE_RTOL of its largest
    |value|; ``len`` exactly."""
    assert got.keys() == want.keys()
    for name in got:
        g, w = got[name], np.asarray(want[name])
        assert tuple(g.shape) == w.shape, name
        if name == "len":
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w)
            assert int(g[0]) == length
            continue
        g, w = g.float().numpy(), w.astype(np.float32)
        assert np.abs(g - w).max() <= CACHE_RTOL * np.abs(w).max(), name


def assert_bf16_serving_matches_forward(arch):
    """The port's bf16 prefill + decode against its own teacher-forced
    forward (``api.forward``) over the same batch
    (tests/test_torch_serving.py's check and tolerances)."""
    cfg, params = serve.build(arch, smoke=True, device=CPU)
    batch = serve.prompt_batch(cfg, B, PROMPT, FORWARD_LEN - PROMPT, CPU)
    tokens = batch["tokens"]
    ref = api.forward(cfg, params, batch)
    logits, cache = D.make_prefill(cfg, PROMPT, room=DECODE)(
        params, serve.prompt_inputs(batch, PROMPT))
    assert ref.shape == (B, FORWARD_LEN, cfg.vocab_padded)
    np.testing.assert_allclose(logits.numpy(), ref[:, PROMPT - 1].numpy(),
                               atol=0.3, rtol=0.1)
    step = D.make_decode_step(cfg)
    for i in range(PROMPT, PROMPT + DECODE):
        logits, cache = step(params, cache, tokens[:, i])
        got, want = logits.numpy(), ref[:, i].numpy()
        np.testing.assert_allclose(got, want, atol=0.12, rtol=0.05)
        assert_greedy(got, want)
    for name, (shape, dt) in D.cache_specs(cfg, B, PROMPT + DECODE).items():
        assert cache[name].dtype == dt and tuple(cache[name].shape) == shape


def assert_serve_cli_runs(arch, capsys, prompt):
    ids = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt", str(prompt), "--decode", "3"])
    assert tuple(ids.shape) == (2, 3)
    assert bool(((ids >= 0) & (ids < get(arch).vocab_size)).all())
    out = capsys.readouterr().out
    assert f"prefill: 2x{prompt} tokens" in out and "tok/s greedy" in out
