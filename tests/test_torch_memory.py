"""PyTorch port, memory layer: slots, wire protocol, regions and the word
conversion, held against the JAX package on the same numpy inputs; and the
port's independence from the reference (no module imports jax or repro)."""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import ast
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import regions as jrg  # noqa: E402
from repro.core import slots as jsl  # noqa: E402
from repro.core import wireproto as jwp  # noqa: E402
from repro_torch.convert import (state_from_numpy, state_to_numpy,  # noqa: E402
                                 to_numpy, words)
from repro_torch.core import regions as prg  # noqa: E402
from repro_torch.core import slots as psl  # noqa: E402
from repro_torch.core import wireproto as pwp  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"


def u32(rng, shape):
    a = rng.randint(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)
    a.flat[:4] = [0, 1, 0x7FFFFFFF, 0xFFFFFFFF][:a.size]
    return a


def test_mix32_and_hash_key_match_reference():
    rng = np.random.RandomState(0)
    lo, hi = u32(rng, 4096), u32(rng, 4096)
    hi[:4] = [0xFFFFFFFF, 0, 0xFFFFFFFF, 0x9E3779B9]
    np.testing.assert_array_equal(to_numpy(psl._mix32(words(lo, CPU))),
                                  np.asarray(jsl._mix32(jnp.asarray(lo))))
    ph1, ph2 = psl.hash_key(words(lo, CPU), words(hi, CPU))
    jh1, jh2 = jsl.hash_key(jnp.asarray(lo), jnp.asarray(hi))
    np.testing.assert_array_equal(ph1.numpy(), np.asarray(jh1, np.int64))
    np.testing.assert_array_equal(ph2.numpy(), np.asarray(jh2, np.int64))


def test_pack_slot_and_matches():
    rng = np.random.RandomState(1)
    val = u32(rng, (5, psl.VALUE_WORDS))
    head = u32(rng, (5, 5))
    head[:, 2] &= ~np.uint32(1)
    head[1, 2] |= 1                      # odd version
    head[:, 3] = 0
    head[2, 3] = 7                       # locked
    args = [head[:, i] for i in range(5)]
    js = jsl.pack_slot(*[jnp.asarray(a) for a in args], jnp.asarray(val))
    ps = psl.pack_slot(*[words(a, CPU) for a in args], words(val, CPU))
    np.testing.assert_array_equal(to_numpy(ps), np.asarray(js))
    klo = head[:, 0].copy()
    klo[3] ^= 1                          # key mismatch
    np.testing.assert_array_equal(
        psl.slot_matches(ps, words(klo, CPU), words(head[:, 1], CPU)).numpy(),
        np.asarray(jsl.slot_matches(js, jnp.asarray(klo),
                                    jnp.asarray(head[:, 1]))))
    np.testing.assert_array_equal(to_numpy(psl.make_empty_slot()),
                                  np.asarray(jsl.make_empty_slot()))


def test_wireproto_is_a_copy():
    names = [n for n in dir(jwp) if n.startswith(("OP_", "ST_"))]
    assert names
    for n in names:
        assert getattr(pwp, n) == getattr(jwp, n), n
    pwp.assert_unique_opcodes()


def _region_table(rg):
    tbl = rg.RegionTable()
    tbl.register("a", 64)
    tbl.register("b", 96)
    tbl.register("scratch", 1)
    return tbl


@pytest.mark.parametrize("paged", [False, True])
def test_arena_read_write_match_reference(paged):
    rng = np.random.RandomState(2 + paged)
    jt, pt = _region_table(jrg), _region_table(prg)
    n = jt.total_words
    arena = u32(rng, n)
    offs = rng.randint(0, n + 8, size=40).astype(np.uint32)
    offs[:4] = [0xFFFFFFF0, 0x80000000, n - 2, 60]     # wrap, clamp, cross
    vals = u32(rng, (40, 5))
    en = rng.rand(40) < 0.7
    jmode = jrg.AddressMode("paged", page_words=16) if paged else None
    pmode = prg.AddressMode("paged", page_words=16) if paged else None
    perm = rng.permutation(-(-n // 16)).astype(np.uint32)
    jpt = jnp.asarray(perm) if paged else None
    ppt = words(perm, CPU) if paged else None
    for region in (None, "b"):
        jr = None if region is None else jt[region]
        pr = None if region is None else pt[region]
        np.testing.assert_array_equal(
            to_numpy(prg.arena_read(words(arena, CPU), words(offs, CPU), 5,
                                    pmode, ppt, pr)),
            np.asarray(jrg.arena_read(jnp.asarray(arena), jnp.asarray(offs), 5,
                                      jmode, jpt, jr)))
        # distinct, non-overlapping write targets (duplicate scatter targets
        # have no defined order in either framework)
        woffs = (rng.permutation(n // 5)[:20] * 5).astype(np.uint32)
        woffs[0] = 0xFFFFFFFE                          # dropped out of bounds
        np.testing.assert_array_equal(
            to_numpy(prg.arena_write(words(arena, CPU), words(woffs, CPU),
                                     words(vals[:20], CPU), pmode, ppt,
                                     torch.from_numpy(en[:20]), pr)),
            np.asarray(jrg.arena_write(jnp.asarray(arena), jnp.asarray(woffs),
                                       jnp.asarray(vals[:20]), jmode, jpt,
                                       jnp.asarray(en[:20]), jr)))
    np.testing.assert_array_equal(
        prg.in_region(pt["b"], words(offs, CPU), 5).numpy(),
        np.asarray(jrg.in_region(jt["b"], jnp.asarray(offs), 5)))
    np.testing.assert_array_equal(
        to_numpy(prg.slot_offset(pt["b"], words(offs[:8], CPU))),
        np.asarray(jrg.slot_offset(jt["b"], jnp.asarray(offs[:8]))))


def test_cluster_arena_read_matches_per_node_reference():
    rng = np.random.RandomState(4)
    arenas = u32(rng, (3, 300))
    offs = rng.randint(0, 320, size=(3, 7)).astype(np.uint32)
    got = prg.arena_read(words(arenas, CPU), words(offs, CPU), 6)
    want = jax.vmap(lambda a, o: jrg.arena_read(a, o, 6))(
        jnp.asarray(arenas), jnp.asarray(offs))
    np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


def test_state_conversion_round_trip():
    rng = np.random.RandomState(5)
    st = {"arena": u32(rng, (2, 33))}
    back = state_to_numpy(state_from_numpy(st, CPU))
    assert back["arena"].dtype == np.uint32
    np.testing.assert_array_equal(back["arena"], st["arena"])


def test_entry_points_need_cuda_unless_cpu_is_asked():
    from repro_torch.core.datastructs import hashtable as ht
    cfg = ht.HashTableConfig(n_nodes=2, n_buckets=4, n_overflow=4)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ht.init_cluster_state(cfg)
    assert ht.init_cluster_state(cfg, device="cpu")["arena"].device.type == "cpu"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    list((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]))
def test_port_imports_neither_jax_nor_the_reference(path):
    for mod in _imports(ROOT / path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {mod}"
