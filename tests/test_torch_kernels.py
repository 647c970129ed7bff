"""PyTorch port, the hash_probe kernel.  On the CPU its wrappers run the plain
PyTorch version, which is held here against the JAX package: the TPU
kernel's contract (``ops.hash_probe``) against ``ref.hash_probe_ref`` and the
Pallas kernel in interpret mode, and the dataplane's contract
(``probe_lines``) against a one-sided read followed by ``lookup_end``.  The
tests marked ``cuda`` hold the CUDA kernel against the plain version on the
card and skip where there is none."""
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


# --- on the card -------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2, 4, 8])
def test_cuda_kernel_matches_plain(cuda, width):
    args = _path_case(width, 40 + width, M=4096, N=4, n_words=4096 + 5)
    t = [words(args[0], cuda), torch.from_numpy(args[1]).to(cuda),
         words(args[2], cuda), words(args[3], cuda), words(args[4], cuda),
         torch.from_numpy(args[5]).to(cuda), torch.from_numpy(args[6]).to(cuda)]
    before = hp.launches
    got = hp.probe_lines(*t, width=width)
    assert hp.launches == before + 1
    want = hp.probe_lines_plain(*t, width=width)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    tpu = hp.hash_probe(t[0][0], t[2] // 32, t[3], t[4], width=width)
    assert torch.equal(tpu, hp.hash_probe_plain(t[0][0], t[2] // 32, t[3],
                                                t[4], width=width))
