"""PyTorch port, the kernels.  On the CPU their wrappers run the plain
PyTorch versions, which are held here against the JAX package: for
hash_probe, the TPU kernel's contract (``ops.hash_probe``) against
``ref.hash_probe_ref`` and the Pallas kernel in interpret mode, and the
dataplane's contract (``probe_lines``) against a one-sided read followed by
``lookup_end``; flash_attention and ssd_scan against their Pallas kernels in
interpret mode and their oracles in ``ref``.  The tests marked ``cuda`` hold
each CUDA kernel against its plain version on the card and skip where there
is none."""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import regions as jrg  # noqa: E402
from repro.core import rpc as JR  # noqa: E402
from repro.core import slots as jsl  # noqa: E402
from repro.core.datastructs import hashtable as jht  # noqa: E402
from repro.core.transport import SimTransport as JSim  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.convert import to_numpy, words  # noqa: E402
from repro_torch.kernels import hash_probe as hp  # noqa: E402
from repro_torch.kernels import ops as pops  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module", params=[1, 2, 4])
def table(request):
    """A populated one-node table (reference-built) per bucket width."""
    width = request.param
    n = 48 * width
    cfg = jht.HashTableConfig(n_nodes=1, n_buckets=32, bucket_width=width,
                              n_overflow=n)
    layout = jht.build_layout(cfg)
    rng = np.random.RandomState(width)
    klo = rng.randint(0, 2**31, size=n).astype(np.uint32)
    khi = rng.randint(0, 2**31, size=n).astype(np.uint32)
    vals = jsl._mix32(jnp.asarray(klo)[:, None]
                      + jnp.arange(jsl.VALUE_WORDS, dtype=jnp.uint32))
    state, rep, _, _ = JR.rpc_call(
        JSim(1), jht.init_cluster_state(cfg), jnp.zeros((1, n), jnp.int32),
        jht.make_record(JR.OP_INSERT, jnp.asarray(klo)[None],
                        jnp.asarray(khi)[None], value=vals[None]),
        jht.make_rpc_handler(cfg, layout))
    assert np.all(np.asarray(rep[..., 0]) == JR.ST_OK)
    _, bucket = jht.home_of(cfg, jnp.asarray(klo), jnp.asarray(khi))
    return width, np.asarray(state["arena"][0]), np.asarray(bucket, np.int32), \
        klo, khi


def test_hash_probe_tpu_contract_matches_reference(table):
    width, arena, bucket, klo, khi = table
    b = bucket.copy()
    b[:6] = [-3, -1, 32, 33, 1 << 25, -(1 << 30)]      # clamped starts
    for lo in (klo, klo + 1):                          # hits, then misses
        got = to_numpy(pops.hash_probe(words(arena, CPU), words(b, CPU),
                                       words(lo, CPU), words(khi, CPU),
                                       width=width))
        want = np.asarray(jref.hash_probe_ref(
            jnp.asarray(arena), jnp.asarray(b), jnp.asarray(lo),
            jnp.asarray(khi), width=width))
        np.testing.assert_array_equal(got, want)
    hits = to_numpy(pops.hash_probe(words(arena, CPU), words(bucket, CPU),
                                    words(klo, CPU), words(khi, CPU),
                                    width=width))[:, 0]
    assert 0 < hits.sum() < len(klo)                   # hits and chained keys


def test_hash_probe_matches_pallas_interpret(table):
    width, arena, bucket, klo, khi = table
    sel = slice(0, 8)
    want = np.asarray(jops.hash_probe(
        jnp.asarray(arena), jnp.asarray(bucket[sel]), jnp.asarray(klo[sel]),
        jnp.asarray(khi[sel]), width=width, use_pallas=True, interpret=True))
    got = to_numpy(pops.hash_probe(words(arena, CPU), words(bucket[sel], CPU),
                                   words(klo[sel], CPU), words(khi[sel], CPU),
                                   width=width))
    np.testing.assert_array_equal(got, want)


def _path_case(width, seed, M=256, N=3, n_words=900):
    rng = np.random.RandomState(seed)
    arenas = rng.randint(0, 2**32, size=(N, n_words), dtype=np.uint64).astype(
        np.uint32)
    dest = rng.randint(0, N, size=M).astype(np.int32)
    off = rng.randint(0, n_words, size=M).astype(np.uint32)
    kind = rng.randint(0, 4, size=M)
    off[kind == 1] = n_words - rng.randint(0, 40, size=(kind == 1).sum())
    off[kind == 2] = rng.randint(2**31, 2**32, size=(kind == 2).sum(),
                                 dtype=np.uint64).astype(np.uint32)
    off[kind == 3] = (off[kind == 3] // 32) * 32
    s = rng.randint(0, width, size=M)
    base = off.astype(np.int64) + 32 * s
    plant = (kind == 3) & (base + 32 <= n_words) & (rng.rand(M) < 0.6)
    arenas[dest[plant], base[plant] + 2] &= ~np.uint32(1)      # even version
    arenas[dest[plant], base[plant] + 3] = 0                    # unlocked
    klo = rng.randint(0, 2**32, size=M, dtype=np.uint64).astype(np.uint32)
    khi = rng.randint(0, 2**32, size=M, dtype=np.uint64).astype(np.uint32)
    klo[plant] = arenas[dest[plant], base[plant]]
    khi[plant] = arenas[dest[plant], base[plant] + 1]
    live = rng.rand(M) < 0.85
    hit = rng.rand(M) < 0.3
    return arenas, dest, off, klo, khi, live, hit


@pytest.mark.parametrize("width", [1, 2, 4])
def test_probe_lines_matches_read_then_lookup_end(width):
    arenas, dest, off, klo, khi, live, hit = _path_case(width, width + 10)
    cfg = jht.HashTableConfig(n_nodes=3, n_buckets=8, bucket_width=width)
    # reference: the owner's gather (a one-sided read; undelivered lanes read
    # zeros), then lookup_end and probe_end's version pick
    buf = jax.vmap(lambda d, o: jrg.arena_read(jnp.asarray(arenas)[d], o,
                                               width * 32))(
        jnp.asarray(dest), jnp.asarray(off))
    buf = jnp.where(jnp.asarray(live)[:, None], buf, 0)
    found, value, local = jht.lookup_end(cfg, buf, jnp.asarray(klo),
                                         jnp.asarray(khi), jnp.asarray(hit))
    ver = jnp.take_along_axis(buf.reshape(-1, width, 32)[..., 2],
                              local[:, None].astype(jnp.int32), axis=1)[:, 0]
    got = pops.probe_lines(words(arenas, CPU), torch.from_numpy(dest),
                           words(off, CPU), words(klo, CPU), words(khi, CPU),
                           torch.from_numpy(live), torch.from_numpy(hit),
                           width=width)
    for g, w in zip(got, (found, ver, value, local)):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
    assert np.asarray(found).any() and not np.asarray(found).all()


def test_plain_version_counts_no_launch():
    arenas, dest, off, klo, khi, live, hit = _path_case(1, 3, M=16)
    before = hp.launches
    hp.probe_lines(words(arenas, CPU), torch.from_numpy(dest), words(off, CPU),
                   words(klo, CPU), words(khi, CPU), torch.from_numpy(live),
                   torch.from_numpy(hit), width=1)
    assert hp.launches == before


def test_lanes_per_cta_by_width():
    """The kernel's tile: 128 lanes at width 1, halving as the line doubles,
    so a CTA's lines stay near 16 KB and 32,768 lanes at width 1 are 256
    CTAs."""
    lanes = [hp.lanes_per_cta(w) for w in range(1, hp.MAX_WIDTH + 1)]
    assert lanes == [128, 64, 32, 32, 16, 16, 16, 16]
    for w, L in zip(range(1, hp.MAX_WIDTH + 1), lanes):
        assert 10_000 <= L * (w * 128 + 16) <= 20_000


@pytest.mark.parametrize("width", [0, -1, 9, 16])
def test_probe_lines_rejects_unsupported_width(width):
    arenas, dest, off, klo, khi, live, hit = _path_case(1, 5, M=8)
    with pytest.raises(ValueError, match="width"):
        hp.probe_lines(words(arenas, CPU), torch.from_numpy(dest),
                       words(off, CPU), words(klo, CPU), words(khi, CPU),
                       torch.from_numpy(live), torch.from_numpy(hit),
                       width=width)


def _edge_case(width, seed, M, N, n_words):
    """Lanes over random arenas with every edge the kernel's paths split on:
    offsets that end exactly at the arena's last word, cross it, wrap
    through 0 in 32 bits or cross the int32 maximum; dest -1 and N; matches
    planted in slot-aligned lanes; a whole CTA of dead lanes."""
    rng = np.random.RandomState(seed)
    line = 32 * width
    arenas = rng.randint(0, 2**32, size=(N, n_words), dtype=np.uint64).astype(
        np.uint32)
    dest = rng.randint(-1, N + 1, size=M).astype(np.int32)
    off = rng.randint(0, n_words, size=M).astype(np.int64)
    kind = rng.randint(0, 6, size=M)
    edges = {1: n_words - line, 2: n_words - line + rng.randint(1, line, M),
             3: 2**32 - rng.randint(1, line + 1, M),
             4: 2**31 - rng.randint(1, line + 1, M), 5: (off // 32) * 32}
    for k, o in edges.items():
        off = np.where(kind == k, o, off)
    s = rng.randint(0, width, size=M)
    base = off + 32 * s
    plant = (kind == 5) & (dest >= 0) & (dest < N) & (base + 32 <= n_words) \
        & (rng.rand(M) < 0.6)
    arenas[dest[plant], base[plant] + 2] &= ~np.uint32(1)      # even version
    arenas[dest[plant], base[plant] + 3] = 0                    # unlocked
    klo = rng.randint(0, 2**32, size=M, dtype=np.uint64).astype(np.uint32)
    khi = rng.randint(0, 2**32, size=M, dtype=np.uint64).astype(np.uint32)
    klo[plant] = arenas[dest[plant], base[plant]]
    khi[plant] = arenas[dest[plant], base[plant] + 1]
    live = rng.rand(M) < 0.85
    L = hp.lanes_per_cta(width)
    if M > 2 * L:
        live[L:2 * L] = False
    return arenas, dest, off.astype(np.uint32), klo, khi, live, \
        rng.rand(M) < 0.3


# --- on the card -------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_words", [4096 + 5, 4096 + 6, 4096 + 7, 4096 + 8])
@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_cuda_kernel_matches_plain(cuda, width, n_words):
    """Both contracts bit for bit at n_words 0..3 mod 4, arena bases 0, 4
    and 8 B past 16 B, and M = 1, one CTA and a lane, 4096 and 2**18; the
    kernel's own count of lanes it copied whole covers every lane whose
    line lies 16 B inside its row and none that needs a clamp."""
    N = 4
    line = 32 * width
    for M in (1, hp.lanes_per_cta(width) + 1, 4096, 2**18):
        args = _edge_case(width, 40 + width, M, N, n_words)
        skew = n_words % 3
        store = torch.empty(N * n_words + skew, dtype=torch.int32, device=cuda)
        arenas = store[skew:].view(N, n_words)
        arenas.copy_(words(args[0], cuda))
        t = [arenas, torch.from_numpy(args[1]).to(cuda), words(args[2], cuda),
             words(args[3], cuda), words(args[4], cuda),
             torch.from_numpy(args[5]).to(cuda),
             torch.from_numpy(args[6]).to(cuda)]
        before = hp.launches
        got = hp.probe_lines(*t, width=width)
        assert hp.launches == before + 1
        want = hp.probe_lines_plain(*t, width=width)
        n_fast = torch.zeros(1, dtype=torch.int32, device=cuda)
        again = hp._launch(*t, width=width, zero_miss=False, n_fast=n_fast)
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, w) and torch.equal(a, w)
        off = args[2].astype(np.int64)
        may = args[5] & (args[1] >= 0) & (args[1] < N) & (off < 2**31) \
            & (off + line <= n_words)
        must = may & (off >= 4) & (off + line <= n_words - 4)
        assert must.sum() <= int(n_fast) <= may.sum()
        bucket = (t[2] // 32).to(torch.int32)
        tpu = hp.hash_probe(t[0][1], bucket, t[3], t[4], width=width)
        assert torch.equal(tpu, hp.hash_probe_plain(t[0][1], bucket, t[3],
                                                    t[4], width=width))
    torch.cuda.synchronize()


# --- flash_attention ---------------------------------------------------------
# (B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, dtype); blocks of 16 so
# that several blocks, skipped blocks and padded tails occur
FLASH_CASES = [
    (1, 48, 48, 2, 2, 64, True, None, None, "bfloat16"),
    (2, 40, 40, 4, 2, 128, True, None, None, "float32"),      # GQA 2, D 128
    (1, 40, 40, 4, 1, 64, True, 20, None, "float32"),         # GQA 4, window
    (1, 32, 32, 2, 2, 64, True, None, 30.0, "float32"),       # softcap
    (1, 24, 40, 2, 2, 64, False, None, None, "bfloat16"),     # ragged, cross
]
# the bf16 kernel's 128 x 128 tiles at their edges: Sq and Sk not multiples
# of 128, Sk below one tile, a window narrower than a tile, GQA 2 and 4,
# D 16 to 128
FLASH_TILE_CASES = [
    (1, 200, 200, 4, 2, 64, True, None, None, "bfloat16"),      # GQA 2
    (1, 130, 257, 2, 2, 32, False, None, None, "bfloat16"),     # ragged, cross
    (1, 300, 300, 2, 1, 64, True, 37, None, "bfloat16"),        # window, GQA 2
    (1, 90, 90, 2, 2, 128, True, None, 20.0, "bfloat16"),       # Sk < tile
    (1, 160, 160, 4, 1, 16, True, None, None, "bfloat16"),      # GQA 4
]
# bf16 outputs: a few ulps of values ~0.5; float32: summation order only
FLASH_ATOL = {"bfloat16": 2e-2, "float32": 2e-5}


def _flash_case(case, seed=0):
    B, Sq, Sk, Hq, Hkv, D, causal, window, cap, dt = case
    rng = np.random.RandomState(seed)
    mk = lambda n, S: (rng.randn(n, S, D) * 0.5).astype(np.float32)
    arrs = (mk(B * Hq, Sq), mk(B * Hkv, Sk), mk(B * Hkv, Sk))
    jx = tuple(jnp.asarray(a, getattr(jnp, dt)) for a in arrs)
    tt = tuple(torch.from_numpy(a).to(getattr(torch, dt)) for a in arrs)
    kw = dict(causal=causal, window=window, softcap=cap)
    return jx, tt, kw, Hq // Hkv, dt


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_plain_matches_pallas_and_ref(case):
    from repro.kernels import flash_attention as jfa
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref as pref
    (jq, jk, jv), (q, k, v), kw, group, dt = _flash_case(case)
    got = fa.flash_attention_plain(q, k, v, q_block=16, kv_block=16,
                                   group=group, **kw)
    assert got.dtype == q.dtype and got.shape == q.shape
    pallas = jfa.flash_attention_bhsd(jq, jk, jv, q_block=16, kv_block=16,
                                      group=group, interpret=True, **kw)
    want = jref.attention_ref_bhsd(jq, jk, jv, **kw)
    g = got.float().numpy()
    atol = FLASH_ATOL[dt]
    np.testing.assert_allclose(g, np.asarray(pallas, np.float32), atol=atol,
                               rtol=1e-2)
    np.testing.assert_allclose(g, np.asarray(want, np.float32), atol=atol,
                               rtol=1e-2)
    # the wrapper, on the CPU, is the plain version at the CUDA kernel's tiles
    wrapped = fa.flash_attention_bhsd(q, k, v, group=group, **kw)
    tile = fa.tile(q.dtype)
    assert torch.equal(wrapped, fa.flash_attention_plain(
        q, k, v, q_block=tile, kv_block=tile, group=group, **kw))
    np.testing.assert_allclose(wrapped.float().numpy(),
                               np.asarray(pallas, np.float32), atol=atol,
                               rtol=1e-2)
    # the port's own oracle agrees with the JAX package's
    np.testing.assert_allclose(pref.attention_ref_bhsd(q, k, v, **kw).float()
                               .numpy(), np.asarray(want, np.float32),
                               atol=atol, rtol=1e-2)


def test_flash_attention_tiles_follow_the_dtype():
    from repro_torch.kernels import flash_attention as fa
    assert fa.tile(torch.bfloat16) == fa.TC_BLOCK == 128
    assert fa.tile(torch.float32) == fa.BLOCK == 64


@pytest.mark.parametrize("case", FLASH_TILE_CASES)
def test_flash_attention_plain_at_kernel_tiles_matches_pallas_and_ref(case):
    """The plain version at the bf16 kernel's 128 x 128 tiles (the CPU
    wrapper's default for bf16) against the Pallas kernel at the same tiles
    in interpret mode and attention_ref."""
    from repro.kernels import flash_attention as jfa
    from repro_torch.kernels import flash_attention as fa
    (jq, jk, jv), (q, k, v), kw, group, dt = _flash_case(case, seed=3)
    got = fa.flash_attention_bhsd(q, k, v, group=group, **kw)
    assert torch.equal(got, fa.flash_attention_plain(
        q, k, v, q_block=fa.TC_BLOCK, kv_block=fa.TC_BLOCK, group=group,
        **kw))
    pallas = jfa.flash_attention_bhsd(jq, jk, jv, q_block=fa.TC_BLOCK,
                                      kv_block=fa.TC_BLOCK, group=group,
                                      interpret=True, **kw)
    want = jref.attention_ref_bhsd(jq, jk, jv, **kw)
    g = got.float().numpy()
    for ref in (pallas, want):
        np.testing.assert_allclose(g, np.asarray(ref, np.float32),
                                   atol=FLASH_ATOL[dt], rtol=1e-2)


def test_flash_attention_model_layout_matches_block_attention():
    """ops.flash_attention in the (B, S, H, D) layout against the JAX
    package's pair-scheduled block_attention."""
    from repro.models import layers as jL
    rng = np.random.RandomState(5)
    q = rng.randn(2, 40, 4, 16).astype(np.float32) * 0.5
    k = rng.randn(2, 40, 2, 16).astype(np.float32) * 0.5
    v = rng.randn(2, 40, 2, 16).astype(np.float32) * 0.5
    want = jL.block_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, q_block=16, kv_block=16)
    got = pops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=1e-5)


# --- ssd_scan ----------------------------------------------------------------
# (B, nc, Q, H, P, N, h_tile): several chunks, h_tile dividing H, the serving
# test's chunks of 24 and 32
SSD_CASES = [
    (1, 3, 24, 4, 16, 16, 2),
    (2, 2, 32, 8, 16, 32, 4),
]
# Q not a multiple of the kernels' 64-row tile, one chunk, head counts that
# are not powers of two
SSD_EDGE_CASES = [
    (2, 1, 100, 8, 64, 64, 2),
    (1, 1, 24, 4, 32, 16, 4),
    (2, 3, 72, 6, 16, 32, 2),
]
SSD_TOL = dict(atol=1e-4, rtol=1e-4)   # float32, summation order only


def _ssd_case(case, seed=2):
    B, nc, Q, H, P, N, h_tile = case
    rng = np.random.RandomState(seed)
    arrs = ((rng.randn(B, nc, Q, H, P) * 0.1).astype(np.float32),
            (-rng.rand(B, nc, Q, H) * 0.5).astype(np.float32),
            (rng.randn(B, nc, Q, N) * 0.3).astype(np.float32),
            (rng.randn(B, nc, Q, N) * 0.3).astype(np.float32))
    return arrs, h_tile


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_scan_plain_matches_pallas_and_ref(case):
    from repro.kernels import ssd_scan as jss
    from repro_torch.kernels import ref as pref
    arrs, h_tile = _ssd_case(case)
    y, st = pops.ssd_scan(*map(torch.from_numpy, arrs), h_tile=h_tile)
    jy, jst = jss.ssd_scan(*map(jnp.asarray, arrs), h_tile=h_tile,
                           interpret=True)
    ry, rst = jref.ssd_scan_ref(*map(jnp.asarray, arrs))
    for want_y, want_st in ((jy, jst), (ry, rst)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **SSD_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_st), **SSD_TOL)
    py, pst = pref.ssd_scan_ref(*map(torch.from_numpy, arrs))
    np.testing.assert_allclose(py.numpy(), np.asarray(ry), **SSD_TOL)
    np.testing.assert_allclose(pst.numpy(), np.asarray(rst), **SSD_TOL)


def _ssd_model_case(case, seed):
    """Model-layout inputs (xh f32, dt, A, Bm, Cm, an initial state) and the
    same values folded and cut into chunks as ssd_scan takes them."""
    B, nc, Q, H, P, N, _ = case
    S = nc * Q
    rng = np.random.RandomState(seed)
    xh = (rng.randn(B, S, H, P) * 0.2).astype(np.float32)
    dt = (rng.rand(B, S, H) * 0.5 + 0.1).astype(np.float32)
    A = (-rng.rand(H) - 0.1).astype(np.float32)
    Bm = (rng.randn(B, S, N) * 0.3).astype(np.float32)
    Cm = (rng.randn(B, S, N) * 0.3).astype(np.float32)
    s0 = (rng.randn(B, H, N, P) * 0.1).astype(np.float32)
    chunks = ((xh * dt[..., None]).reshape(B, nc, Q, H, P),
              (dt * A).reshape(B, nc, Q, H), Bm.reshape(B, nc, Q, N),
              Cm.reshape(B, nc, Q, N))
    return (xh, dt, A, Bm, Cm, s0), chunks


@pytest.mark.parametrize("with_init", [False, True])
@pytest.mark.parametrize("case", SSD_CASES + SSD_EDGE_CASES)
def test_ssd_scan_phased_matches_plain_and_reference(case, with_init):
    """ssd_scan_phased (the CUDA kernels' algorithm: chunk-local states,
    state passing over chunks, outputs with the carry-in) against the
    chunk-by-chunk plain version and the JAX package: the Pallas kernel in
    interpret mode without an initial state, mamba2.ssd_chunked (the
    package's path that takes one) with it."""
    from repro.kernels import ssd_scan as jss
    from repro.models import mamba2 as jM
    from repro_torch.kernels import ssd_scan as ss
    (xh, dt, A, Bm, Cm, s0), chunks = _ssd_model_case(case, seed=4)
    B, nc, Q, H, P, N, h_tile = case
    x = [torch.from_numpy(a) for a in chunks]
    init = torch.from_numpy(s0) if with_init else None
    y, st = ss.ssd_scan_phased(*x, init_state=init)
    yp, sp = ss.ssd_scan_plain(*x, init_state=init)
    torch.testing.assert_close(y, yp, **SSD_TOL)
    torch.testing.assert_close(st, sp, **SSD_TOL)
    if with_init:
        jy, jst = jM.ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bm, Cm)), Q,
                                 init_state=jnp.asarray(s0))
        jy = np.asarray(jy).reshape(B, nc, Q, H, P)
    else:
        jy, jst = jss.ssd_scan(*map(jnp.asarray, chunks), h_tile=h_tile,
                               interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SSD_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **SSD_TOL)


def test_ssd_chunked_matches_reference_with_initial_state():
    """mamba2.ssd_chunked (fold-in + ssd_scan + bf16 cast) against the JAX
    package's, from a non-zero initial state."""
    from repro.models import mamba2 as jM
    from repro_torch.convert import tensor_from_numpy
    from repro_torch.models import mamba2 as M
    B, S, H, P, N = 2, 64, 4, 16, 16
    rng = np.random.RandomState(3)
    xh = jnp.asarray(rng.randn(B, S, H, P) * 0.2, jnp.bfloat16)
    dt = jnp.asarray(rng.rand(B, S, H) * 0.5 + 0.1, jnp.float32)
    A = jnp.asarray(-rng.rand(H) - 0.1, jnp.float32)
    Bm = jnp.asarray(rng.randn(B, S, N) * 0.3, jnp.bfloat16)
    Cm = jnp.asarray(rng.randn(B, S, N) * 0.3, jnp.bfloat16)
    s0 = jnp.asarray(rng.randn(B, H, N, P) * 0.1, jnp.float32)
    jy, jst = jM.ssd_chunked(xh, dt, A, Bm, Cm, 32, init_state=s0)
    t = lambda a: tensor_from_numpy(np.asarray(a), CPU)
    y, st = M.ssd_chunked(t(xh), t(dt), t(A), t(Bm), t(Cm), 32,
                          init_state=t(s0))
    assert y.dtype == torch.bfloat16
    # y is rounded to bf16 in both: one ulp of values below 2
    np.testing.assert_allclose(y.float().numpy(), np.asarray(jy, np.float32),
                               atol=8e-3, rtol=0)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **SSD_TOL)


def test_plain_versions_count_no_launch():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    before = (fa.launches, ss.launches)
    _, (q, k, v), kw, group, _ = _flash_case(FLASH_CASES[0])
    fa.flash_attention_bhsd(q, k, v, group=group, **kw)
    arrs, h_tile = _ssd_case(SSD_CASES[0])
    ss.ssd_scan(*map(torch.from_numpy, arrs), h_tile=h_tile)
    assert (fa.launches, ss.launches) == before


def test_wrappers_reject_bad_arguments():
    """Bad arguments and devices refused; meta tensors shape-only."""
    import types
    from repro_torch.core import slots as sl
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.kernels import ssd_scan as ss
    arrs, _ = _ssd_case(SSD_CASES[0])
    with pytest.raises(ValueError, match="h_tile"):
        ss.ssd_scan(*map(torch.from_numpy, arrs), h_tile=3)
    _, (q, k, v), kw, group, _ = _flash_case(FLASH_CASES[0])
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_bhsd(q, k, v, causal=True, window=0)
    # a device that is neither cpu, cuda nor meta is refused by all three
    # wrappers (a stand-in with the shape and device the wrapper reads)
    other = lambda t: types.SimpleNamespace(shape=tuple(t.shape),
                                            device=torch.device("xpu"))
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_bhsd(other(q), other(k), other(v))
    with pytest.raises(ValueError, match="unsupported device"):
        ss.ssd_scan(*(other(torch.from_numpy(a)) for a in arrs))
    with pytest.raises(ValueError, match="unsupported device"):
        hp.probe_lines(*(other(torch.zeros(2, 4)) for _ in range(7)),
                       width=1)
    # meta tensors (the dry run's) take a shape-only path: outputs of the
    # kernels' shapes and dtypes, nothing computed
    out = fa.flash_attention_bhsd(q.to("meta"), k.to("meta"), v.to("meta"),
                                  group=group, **kw)
    assert out.device.type == "meta" and out.shape == q.shape
    y, st = ss.ssd_scan(*(torch.from_numpy(a).to("meta") for a in arrs))
    B, nc, Q, H, P = arrs[0].shape
    assert y.device.type == st.device.type == "meta"
    assert y.shape == (B, nc, Q, H, P) and st.shape == (
        B, H, arrs[2].shape[-1], P) and st.dtype == torch.float32
    M = 5
    lanes = [torch.zeros(M, dtype=torch.int32, device="meta")] * 4
    flags = [torch.zeros(M, dtype=torch.bool, device="meta")] * 2
    f, ver, val, loc = hp.probe_lines(
        torch.zeros(2, 64, dtype=torch.int32, device="meta"), *lanes,
        *flags, width=1)
    assert (f.shape, ver.shape, val.shape, loc.shape) == (
        (M,), (M,), (M, sl.VALUE_WORDS), (M,))
    assert (f.dtype, ver.dtype, val.dtype, loc.dtype) == (
        torch.bool, torch.int32, torch.int32, torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES + FLASH_TILE_CASES)
def test_cuda_flash_attention_matches_plain(cuda, case):
    from repro_torch.kernels import flash_attention as fa
    _, tt, kw, group, dt = _flash_case(case, seed=7)
    q, k, v = (t.to(cuda) for t in tt)
    before = fa.launches
    got = fa.flash_attention_bhsd(q, k, v, group=group, **kw)
    assert fa.launches == before + 1
    want = fa.flash_attention_plain(q, k, v, group=group, **kw).float()
    torch.cuda.synchronize()
    # same tiles as the plain version: element by element within a few ulps
    # of |want| plus its row's rms (bf16: the output's rounding and a p that
    # rounds the other way; float32: the order of sums)
    ulps = {"bfloat16": 2 * 2.0 ** -8, "float32": 128 * 2.0 ** -23}[dt]
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    assert bool(((got.float() - want).abs() <= ulps * (want.abs() + rms)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD_CASES + SSD_EDGE_CASES)
def test_cuda_ssd_scan_matches_plain(cuda, case):
    from repro_torch.kernels import ssd_scan as ss
    arrs, h_tile = _ssd_case(case, seed=8)
    x = [torch.from_numpy(a).to(cuda) for a in arrs]
    s0 = torch.randn(x[0].shape[0], x[0].shape[3], x[2].shape[-1],
                     x[0].shape[-1], device=cuda) * 0.1
    before = ss.launches
    y, st = ss.ssd_scan(*x, h_tile=h_tile, init_state=s0)
    assert ss.launches == before + 1
    yp, stp = ss.ssd_scan_plain(*x, init_state=s0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, yp, **SSD_TOL)
    torch.testing.assert_close(st, stp, **SSD_TOL)
