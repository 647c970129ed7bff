"""The JAX package's examples, run as they ship, for
tests/test_torch_examples.py to hold the port's examples against.  Run as a
script in a subprocess (the examples take ~20 s each of JAX's own time, so
the test starts them side by side):

    python tests/torch_examples_oracle.py OUTDIR NAME [NAME ...]

NAME is ``quickstart``, ``kvstore_tx``, ``serve_decode``, ``train_bf16``
(``train_moe.py --steps 3``) or ``train_f32`` (the same with the initial
parameters in float32); the names run one after the other.  Each runs
``examples/<file>.py`` with ``runpy.run_path`` as ``__main__``, its
printed lines captured, and records what its lines do not show:

  * quickstart: the arena and the transaction result (the module's
    ``state`` and ``res``);
  * kvstore_tx: the arena, the ``tx_loop`` result and the backoff
    permutations ``tx_loop`` draws from its default key;
  * serve_decode: each arch's parameters (``init_params`` as the example
    calls it, cast to float32 but whisper's: in bf16 a greedy step can sit
    at a near tie, and the reference's whisper encoder refuses float32
    weights) and every greedy step's logits and tokens (the example's own
    ``jnp.argmax`` calls on concrete arrays);
  * train: the initial train state (``init_train_state`` as the example
    calls it; float32 parameters for ``train_f32``).

Each name's record goes to OUTDIR/NAME.npz, its lines as ``stdout``.
"""
import contextlib
import io
import os
import pathlib
import runpy
import sys

OUTDIR, NAMES = sys.argv[1], sys.argv[2:]
# no Eigen thread pool inside an op: the oracle runs beside the suite's
# workers
os.environ["XLA_FLAGS"] = "--xla_cpu_multi_thread_eigen=false"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
FILES = {"quickstart": "quickstart.py", "kvstore_tx": "kvstore_tx.py",
         "serve_decode": "serve_decode.py", "train_bf16": "train_moe.py",
         "train_f32": "train_moe.py"}


def flat(tree, prefix):
    """Nested dicts of arrays as {prefix/path: numpy}."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in flat(v, f"{prefix}/{k}").items()}
    return {prefix: np.asarray(jax.device_get(tree))}


def fields(obj, prefix):
    """A result dataclass's array fields (nested ones too) as numpy."""
    import dataclasses
    got = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            got.update(fields(v, f"{prefix}/{f.name}"))
        else:
            got[f"{prefix}/{f.name}"] = np.asarray(v)
    return got


def jax_perms(key, max_rounds, N, B):
    """The backoff permutations tx_loop draws (repro/core/txloop.py:114-131;
    tests/test_torch_txloop.py's helper)."""
    rows = []
    for _ in range(max_rounds):
        key, sub = jax.random.split(key)
        rows.append(np.asarray(jax.vmap(lambda k: jax.random.permutation(
            k, B))(jax.random.split(sub, N)), np.int64))
    return np.stack(rows)


@contextlib.contextmanager
def patched(mod, name, fn):
    inner = getattr(mod, name)
    setattr(mod, name, fn(inner))
    try:
        yield
    finally:
        setattr(mod, name, inner)


def run(name):
    """Run one example; returns its record."""
    out, stack = {}, contextlib.ExitStack()
    steps, calls = [], []
    if name == "serve_decode":
        from repro.parallel import sharding as S

        def init_params(inner):
            def call(specs, key):
                p = inner(specs, key)
                if "dec_layers" not in specs:          # not whisper
                    p = jax.tree.map(lambda a: a.astype(jnp.float32), p)
                out.update(flat(p, f"params{len(calls)}"))
                calls.append(None)
                return p
            return call

        def argmax(inner):
            def call(x, *a, **k):
                y = inner(x, *a, **k)
                if not isinstance(x, jax.core.Tracer):
                    steps.append((np.asarray(x), np.asarray(y)))
                return y
            return call
        stack.enter_context(patched(S, "init_params", init_params))
        stack.enter_context(patched(jnp, "argmax", argmax))
    if name.startswith("train"):
        from repro.train import step as T

        def init_train_state(inner):
            def call(cfg, key):
                st = inner(cfg, key)
                if name == "train_f32":
                    st = dict(st, params=jax.tree.map(
                        lambda a: a.astype(jnp.float32), st["params"]))
                out.update(flat(st, "state"))
                return st
            return call
        stack.enter_context(patched(T, "init_train_state", init_train_state))
    argv = sys.argv
    sys.argv = [FILES[name]] + (["--steps", "3"] if name.startswith("train")
                                else [])
    buf = io.StringIO()
    with stack, contextlib.redirect_stdout(buf):
        g = runpy.run_path(str(EXAMPLES / FILES[name]), run_name="__main__")
    sys.argv = argv
    out["stdout"] = np.asarray(buf.getvalue())
    if name in ("quickstart", "kvstore_tx"):
        out["arena"] = np.asarray(g["state"]["arena"])
        out.update(fields(g["res"], "res"))
    if name == "kvstore_tx":
        out["perms"] = jax_perms(jax.random.PRNGKey(0x5707), g["ROUNDS"],
                                 g["N_NODES"], g["LANES"])
    if name == "serve_decode":
        out["n_archs"] = np.asarray(len(calls))
        for i, (x, y) in enumerate(steps):
            out[f"logits{i}"], out[f"tok{i}"] = x, y
    return out


for name in NAMES:
    np.savez(pathlib.Path(OUTDIR) / f"{name}.npz", **run(name))
print("ORACLE_OK")
