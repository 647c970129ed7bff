"""PyTorch port, checkpoints: the counterparts of
tests/test_checkpoint_data.py (atomic commit, restore onto a given device,
gc, the resumable token stream), the Storm commit record word for word
against the JAX package's manager, and checkpoints that cross between the
two packages array for array."""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.checkpoint.manager import CheckpointManager as JManager  # noqa: E402
from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import synthetic_batch as jbatch  # noqa: E402
from repro.train.step import init_train_state as jinit_state  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get  # noqa: E402
from repro_torch.convert import tensor_to_numpy, train_state_from_numpy  # noqa: E402
from repro_torch.data.pipeline import DataConfig, synthetic_batch, synthetic_tokens  # noqa: E402
from repro_torch.train.step import init_train_state, make_train_state_specs  # noqa: E402

CPU = "cpu"


def state_of(arch, seed=0):
    return init_train_state(get(arch).smoke(),
                            torch.Generator().manual_seed(seed), CPU)


def flat(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{pre}/{k}"))
        return out
    return {pre: tree}


def assert_same_tree(a, b):
    fa, fb = flat(a), flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        x, y = fa[k], fb[k]
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x, y), k


def test_save_restore_roundtrip(tmp_path):
    state = state_of("qwen1.5-4b")
    mgr = CheckpointManager(tmp_path / "ck", device=CPU)
    mgr.save(10, state)
    assert mgr.latest_committed_step() == 10
    step, restored = mgr.restore()
    assert step == 10
    assert_same_tree(state, restored)


def test_commit_is_atomic_under_partial_write(tmp_path):
    """A leftover .tmp dir (a crash mid-write) must not shadow the last good
    checkpoint."""
    state = state_of("qwen1.5-4b")
    mgr = CheckpointManager(tmp_path / "ck", device=CPU)
    mgr.save(1, state)
    (tmp_path / "ck" / "step_00000002.tmp").mkdir()
    step, _ = mgr.restore()
    assert step == 1
    assert mgr.latest_committed_step() == 1


def test_elastic_restore_to_given_device(tmp_path):
    """Restore puts the arrays on the device asked for (the one-card
    counterpart of a restore onto another Topology), with the train
    state's shapes and dtypes."""
    cfg = get("granite-moe-1b-a400m").smoke()
    state = state_of("granite-moe-1b-a400m", seed=1)
    mgr = CheckpointManager(tmp_path / "ck", device=CPU)
    mgr.save(5, state)
    step, restored = CheckpointManager(tmp_path / "ck", device=CPU).restore(
        device="cpu")
    assert step == 5
    leaf = restored["params"]["embed"]
    assert tuple(leaf.shape) == (cfg.vocab_padded, cfg.d_model)
    assert leaf.device.type == "cpu" and leaf.dtype == torch.bfloat16
    specs = flat(make_train_state_specs(cfg))
    got = flat(restored)
    assert set(specs) == set(got)
    for k, s in specs.items():
        assert tuple(got[k].shape) == s.shape and got[k].dtype == s.dtype, k


def test_checkpoint_gc_keeps_last_k(tmp_path):
    state = state_of("qwen1.5-4b")
    mgr = CheckpointManager(tmp_path / "ck", keep=2, device=CPU)
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    kept = sorted(p.name for p in (tmp_path / "ck").glob("step_*"))
    assert kept == ["step_00000003", "step_00000004"]
    assert mgr.latest_committed_step() == 4


def test_data_pipeline_deterministic_and_resumable():
    cfg = get("glm4-9b").smoke()
    shape = ShapeConfig("t", 64, 4, "train")
    dc = DataConfig(seed=3)
    a = synthetic_batch(cfg, shape, dc, 7, device=CPU)
    b = synthetic_batch(cfg, shape, dc, 7, device=CPU)
    assert torch.equal(a["tokens"], b["tokens"])
    c = synthetic_batch(cfg, shape, dc, 8, device=CPU)
    assert not torch.equal(a["tokens"], c["tokens"])
    toks = synthetic_tokens(dc, 0, 2, 128, cfg.vocab_size)
    assert toks.min() >= 1 and toks.max() < cfg.vocab_size
    # the reference's train batch, token for token
    j = jbatch(JARCHS["glm4-9b"].smoke(), shape, JDataConfig(seed=3), step=7)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(a[k].numpy(), np.asarray(j[k]))


def test_commit_record_matches_reference_word_for_word(tmp_path):
    """After the same saves, the metadata arena (the Storm hash table that
    holds the commit record) equals the JAX manager's bit for bit, and so
    does latest_committed_step."""
    cfg_j = JARCHS["qwen1.5-4b"].smoke()
    sj = jinit_state(cfg_j, jax.random.key(0))
    st = train_state_from_numpy(jax.device_get(sj), CPU)
    jm = JManager(tmp_path / "j", keep=2)
    tm = CheckpointManager(tmp_path / "t", keep=2, device=CPU)
    assert tm.latest_committed_step() is jm.latest_committed_step() is None
    for step in (3, 7, 2**20 + 5):
        jm.save(step, sj)
        tm.save(step, st)
        ja = np.asarray(jax.device_get(jm._meta_state["arena"]))
        ta = tm._meta_state["arena"].numpy().view(np.uint32)
        np.testing.assert_array_equal(ta, ja)
        assert tm.latest_committed_step() == jm.latest_committed_step() == step
    np.testing.assert_array_equal(
        tm._meta_state["arena"].numpy().view(np.uint32),
        np.asarray(jax.device_get(jm._meta_state["arena"])))
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir())


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A checkpoint the JAX manager wrote restores in the port array for
    array, and one the port wrote restores in the JAX manager."""
    cfg_j = JARCHS["granite-moe-1b-a400m"].smoke()
    sj = jinit_state(cfg_j, jax.random.key(4))
    JManager(tmp_path / "j").save(6, sj)
    step, st = CheckpointManager(tmp_path / "j", device=CPU).restore()
    assert step == 6
    fj = flat(jax.device_get(sj))
    ft = flat(st)
    assert set(fj) == set(ft)
    for k in fj:
        got = tensor_to_numpy(ft[k])
        assert got.dtype == np.asarray(fj[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      np.asarray(fj[k], np.float32))
    # and back: the port's own state through the JAX manager
    mine = state_of("granite-moe-1b-a400m", seed=5)
    CheckpointManager(tmp_path / "t", device=CPU).save(9, mine)
    step, back = JManager(tmp_path / "t").restore()
    assert step == 9
    fb = flat(jax.device_get(back))
    for k, x in flat(mine).items():
        got = np.asarray(fb[k])
        assert got.dtype == tensor_to_numpy(x).dtype, k
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      x.float().numpy())


def test_manager_runs_on_the_card_by_default(tmp_path):
    """Like every entry point of the port, the manager's device is the card
    unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CheckpointManager(tmp_path / "ck")
