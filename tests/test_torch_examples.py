"""PyTorch port, the four examples (``examples/torch_*.py``) held against
the JAX package's examples (``examples/quickstart.py``, ``kvstore_tx.py``,
``serve_decode.py``, ``train_moe.py``), which run unchanged with
``runpy.run_path`` in subprocesses started when this module starts
(``tests/torch_examples_oracle.py``).

  * quickstart: the printed lines equal, the arena and the transaction
    result bit for bit;
  * kvstore_tx: the same, the port's ``tx_loop`` fed the reference's
    backoff permutations (``main(perms=)``): per-round counts by cause,
    WireStats, round trips;
  * serve_decode: each arch from the reference's parameters (its
    ``init_params`` as the example calls it, carried across with
    ``convert.params_from_numpy``), in float32 for granite and mamba2 (in
    bf16 granite's first greedy token sits at a near tie: a top-2 margin of
    8.2e-4 against a bf16 deviation of 3.8e-2, and mamba2's eighth at
    1.7e-3 against 1.1e-2, so the continuations part by the greedy rule;
    float32 leaves only the order of sums) and bf16 for whisper (the
    reference's encoder refuses float32 weights): every greedy id equal,
    the printed mode and continuation equal, each step's logits holding the
    greedy choice as ``tests/test_torch_serving.py`` holds it;
  * train_moe: ``--steps 3`` from the reference's initial state, its
    parameters in float32 and bf16 as the example ships: the printed step 0
    and step 2 losses against the reference's (step 0 within ``LOSS_REL``
    in float32, ``BF16_LOSS_REL`` in bf16; step 2 within
    ``TRAIN_MOE_LOSS_REL``), plus half their last printed digit; the
    closing line's form and its warning alike.  The grad norms are not
    held: at this config's initial state the float32 gradients are chaotic
    in both packages (1e-7 on the embeddings moves the reference's grad
    norm between 2,296 and 4,730 and the port's between 830 and 9,054
    over three steps), while the step-0 loss moves at most 2.0e-6 and the
    step-2 loss 1.3e-3 (the port's float32 run, four draws);
  * no ``examples/torch_*.py`` imports JAX or the JAX package, each
    imports only torch, numpy and the port beside the standard library,
    and each asks for the card by default.
"""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import ast
import importlib.util
import os
import pathlib
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_train_common import BF16_LOSS_REL, LOSS_REL
from repro_torch.convert import params_from_numpy, to_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]
ORACLE = pathlib.Path(__file__).with_name("torch_examples_oracle.py")
ORACLE_S = 240            # every oracle subprocess
# the oracle subprocesses, by the examples each runs
GROUPS = (("quickstart", "kvstore_tx"), ("serve_decode",),
          ("train_f32", "train_bf16"))
PORTED = ("quickstart", "kvstore_tx", "serve_decode", "train_moe")
CPU = "cpu"
# the train_moe example's step-2 loss, after two updates from its
# ill-conditioned initial gradients: over 4x the 1.3e-3 that 1e-7 on the
# embeddings moves it (the port's float32 run, four draws); read 7.6e-4
# float32, card-free
TRAIN_MOE_LOSS_REL = 6e-3


class Oracles:
    """The reference's examples in GROUPS subprocesses side by side, the
    names of a group one after the other."""
    def __init__(self, d):
        self.d, self.procs, self.outs = d, {}, {}
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        env.pop("XLA_FLAGS", None)
        for group in GROUPS:
            p = subprocess.Popen(
                [sys.executable, str(ORACLE), str(d), *group], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            self.procs.update((name, p) for name in group)
        self.t0 = time.monotonic()

    def get(self, name):
        if name not in self.outs:
            p = self.procs[name]
            if p.returncode is None:
                left = ORACLE_S - (time.monotonic() - self.t0)
                try:
                    p.so, p.se = p.communicate(timeout=max(left, 1))
                except subprocess.TimeoutExpired:
                    p.kill()
                    raise
            assert "ORACLE_OK" in p.so, p.se[-3000:]
            self.outs[name] = dict(np.load(self.d / f"{name}.npz"))
        return self.outs[name]

    def close(self):
        for p in set(self.procs.values()):
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module", autouse=True)
def oracles(tmp_path_factory):
    o = Oracles(tmp_path_factory.mktemp("example_oracles"))
    yield o
    o.close()


@pytest.fixture(scope="module", autouse=True)
def _one_rank_group():
    """The examples join a world of one (``make_smoke_mesh``) as the
    reference's do; leave the worker as it was."""
    had = dist.is_initialized()
    yield
    if dist.is_initialized() and not had:
        dist.destroy_process_group()


def example(name):
    """The port's ``examples/torch_<name>.py`` as a module."""
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lines_of(o):
    return str(o["stdout"]).splitlines()


def tree(o, prefix):
    """The oracle's flattened tree under ``prefix`` as nested dicts (bf16
    leaves come back from ``np.savez`` as 2-byte voids)."""
    import ml_dtypes
    out = {}
    for k, v in o.items():
        if not k.startswith(prefix + "/"):
            continue
        if v.dtype.kind == "V" and v.dtype.itemsize == 2:
            v = v.view(ml_dtypes.bfloat16)
        *path, leaf = k[len(prefix) + 1:].split("/")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


def same_fields(got, o, prefix):
    """A port result dataclass against the oracle's fields, words as bit
    images and int32 fields (``commit_round``'s -1) as signed."""
    import dataclasses
    for f in dataclasses.fields(got):
        v = getattr(got, f.name)
        if dataclasses.is_dataclass(v):
            same_fields(v, o, f"{prefix}/{f.name}")
            continue
        want = o[f"{prefix}/{f.name}"]
        g = v.cpu().numpy()
        if want.dtype == np.uint32:
            g = g.view(np.uint32)
        np.testing.assert_array_equal(g, want, err_msg=f.name)


def test_quickstart_matches_reference(oracles, capsys):
    """The port's quickstart on the CPU prints the reference's three lines
    (32 keys, 30/32 lookups by one one-sided read, 4,840 wire bytes, 32/32
    committed in 4 round trips); its arena and transaction result are the
    reference's bit for bit."""
    o = oracles.get("quickstart")
    got = example("quickstart").main(device=CPU)
    assert got["lines"] == lines_of(o)
    assert capsys.readouterr().out.splitlines() == lines_of(o)
    assert got["lines"][0] == "inserted 32 keys"
    np.testing.assert_array_equal(to_numpy(got["state"]["arena"]), o["arena"])
    same_fields(got["result"], o, "res")


def test_kvstore_tx_matches_reference(oracles):
    """The port's kvstore_tx fed the reference's backoff permutations: its
    lines (per-round commits [8 3 1 0 0 0 0 0], lock aborts [4 1 0 ...],
    final versions [4 2 4 8 4 6 2 4 0 2], the last four accounts never
    inserted, so their lookups return slot 0's reply words), its arena and
    every field of the ``tx_loop`` result bit for bit."""
    o = oracles.get("kvstore_tx")
    got = example("kvstore_tx").main(device=CPU,
                                     perms=torch.from_numpy(o["perms"]))
    assert got["lines"] == lines_of(o)
    np.testing.assert_array_equal(to_numpy(got["state"]["arena"]), o["arena"])
    same_fields(got["result"], o, "res")
    assert got["lines"][1].endswith("[8 3 1 0 0 0 0 0]")


def assert_greedy(got, want):
    """argmax agrees unless the reference's own top-2 margin is within 4x
    the observed deviation (tests/test_torch_serving.py's rule)."""
    srt = np.sort(want, -1)
    margin = srt[:, -1] - srt[:, -2]
    flip = np.argmax(got, -1) != np.argmax(want, -1)
    dev = np.abs(got - want).max()
    assert not np.any(flip & (margin > 4 * dev)), (margin, dev)


def continuation(line):
    return line.split("continuation", 1)[1].strip()


@pytest.mark.parametrize("i,arch", enumerate(
    ("granite-moe-1b-a400m", "mamba2-780m", "whisper-medium")))
def test_serve_decode_matches_reference(i, arch, oracles):
    """Each arch served from the reference's parameters (float32 but
    whisper's bf16): the B x DECODE greedy ids equal to the reference's,
    its printed mode and continuation equal, each step's logits holding
    the greedy choice."""
    o = oracles.get("serve_decode")
    assert int(o["n_archs"]) == 3
    mod = example("serve_decode")
    got = mod.serve(arch, CPU, params=params_from_numpy(
        tree(o, f"params{i}"), CPU))
    n = mod.DECODE
    want_ids = np.stack([o[f"tok{i * n + j}"] for j in range(n)], 1)
    np.testing.assert_array_equal(got["ids"], want_ids)
    for j in range(n):
        assert_greedy(got["logits"][j].float().numpy(),
                      o[f"logits{i * n + j}"].astype(np.float32))
    ref = lines_of(o)[i]
    assert ref.startswith(arch)
    assert continuation(got["line"]) == continuation(ref)
    mode = lambda s: s.split("[", 1)[1].split("]", 1)[0]
    assert mode(got["line"]) == mode(ref)


def _printed(lines):
    """{step: (loss, gnorm)} of the example's step lines."""
    pat = re.compile(r"step\s+(\d+)\s+loss ([\d.]+)\s+acc [\d.]+\s+gnorm "
                     r"([\d.]+)")
    return {int(m.group(1)): (float(m.group(2)), float(m.group(3)))
            for m in map(pat.match, lines) if m}


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
def test_train_moe_matches_reference(dtype, oracles):
    """``--steps 3`` from the reference's initial state (its parameters in
    float32, or bf16 as the example ships): the printed steps 0 and 2, the
    step-0 loss within LOSS_REL (bf16: BF16_LOSS_REL) and the step-2 loss
    within TRAIN_MOE_LOSS_REL of the reference's printed value plus half
    its last digit; the closing line in the reference's form, the warning
    alike.  The grad norms are chaotic at this state (the module's
    docstring) and not held."""
    from repro_torch.convert import train_state_from_numpy
    o = oracles.get("train_f32" if dtype == "float32" else "train_bf16")
    state = train_state_from_numpy(tree(o, "state"), CPU)
    got = example("train_moe").main(["--steps", "3"], device=CPU,
                                    state=state)
    want, mine = _printed(lines_of(o)), _printed(got["lines"])
    assert sorted(want) == sorted(mine) == [0, 2]
    for s, rel in ((0, LOSS_REL if dtype == "float32" else BF16_LOSS_REL),
                   (2, TRAIN_MOE_LOSS_REL)):
        assert abs(got["losses"][s] - want[s][0]) <= rel * want[s][0] + 5e-5
    assert all(np.isfinite(got["grad_norms"]))
    closing = re.compile(r"loss [\d.]+ -> [\d.]+ over 3 steps \(\d+s\); MoE "
                         r"dispatched via the Storm hybrid \(mode chosen by "
                         r"the cost model at trace time\)")
    ref_tail = [s for s in lines_of(o) if s and not s.startswith("step")]
    got_tail = [s for s in "\n".join(got["lines"]).splitlines()
                if s and not s.startswith("step")]
    assert closing.fullmatch(ref_tail[0]) and closing.fullmatch(got_tail[0])
    assert [s.startswith("WARNING") for s in ref_tail[1:]] == \
        [s.startswith("WARNING") for s in got_tail[1:]]


@pytest.mark.parametrize("name", PORTED)
def test_example_imports_only_the_port(name):
    """``examples/torch_<name>.py`` imports torch, numpy and repro_torch
    beside the standard library, never jax or the JAX package."""
    src = (ROOT / "examples" / f"torch_{name}.py").read_text()
    roots = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add((node.module or "").split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro"}, roots
    assert roots - set(sys.stdlib_module_names) <= {"torch", "numpy",
                                                    "repro_torch"}, roots
    assert "repro_torch" in roots


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", PORTED)
def test_example_asks_for_the_card(name):
    """Run with no arguments, each example takes ``--device cuda``, and on a
    host without a card it raises rather than fall back to the CPU."""
    mod = example(name)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if name == "serve_decode":
            mod.serve(mod.ARCHS[0])
        else:
            mod.main([])
