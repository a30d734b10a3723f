"""The port's FDR classifier against the JAX package's flax classifier, on
the CPU.

- weights carried across (``convert.classifier_from_jax``): the packaged
  ``constants/classifier/ea4b0fe1c1f77109.pkl`` and a fresh flax init give
  ``predict_proba`` within 1e-6 of JAX's;
- training: from the same JAX-initialised variables and the same
  ``random_state``, dropout 0, 2 epochs, the port's fit ends at JAX's
  parameters, BatchNorm running statistics and per-epoch losses within
  atol 1e-4 / rtol 1e-3 (an unbiased running variance, another
  initialisation or another order of the numpy draws fails it);
- a state dict saved by either package loads in the other with the same
  probabilities (1e-6);
- JAX's random stream (``utils/jax_random``): ``PRNGKey``, ``split``,
  ``fold_in``, bits, ``uniform``, ``bernoulli`` exactly, ``truncated_normal``
  within 4 ulps; the port's fresh weights are
  flax's ``model.init`` for seeds 0-2 (Dense kernels within 4 float32 ulps:
  XLA's ``erfinv`` takes its own ``log1p``; biases zero), its dropout masks
  are the ones flax's Dropout modules draw per step, and a fit at the
  default dropout, fresh or from the packaged warm start, ends within 1e-4
  of flax's ``predict_proba``.
"""

import pickle
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphadia_torch.convert import classifier_to_jax
from alphadia_torch.models.classifier import BinaryClassifier, FeedForwardNN
from alphadia_torch.utils import jax_random
from alphadia_tpu.models.classifier import BinaryClassifier as JaxBinaryClassifier
from alphadia_tpu.models.classifier import FeedForwardNN as JaxFeedForwardNN

pytest_plugins = ("torch_port_plugin",)

REPO = Path(__file__).resolve().parents[1]
PACKAGED = "constants/classifier/ea4b0fe1c1f77109.pkl"


def _data(n=3000, d=10, seed=1):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(1.5, 1, (n, d)), rng.normal(0, 1, (n, d))]).astype(np.float32)
    y = np.concatenate([np.zeros(n), np.ones(n)]).astype(np.float32)
    return x, y


def _flax_variables(d, seed=3, dropout=0.0):
    v = JaxFeedForwardNN(dropout=dropout).init(jax.random.PRNGKey(seed), jnp.zeros((2, d)), train=False)
    return {k: jax.tree_util.tree_map(np.asarray, dict(v[k])) for k in ("params", "batch_stats")}


def _jax_classifier(variables, d, **kw):
    clf = JaxBinaryClassifier(**kw)
    clf.variables, clf.input_dim, clf._fitted = variables, d, True
    return clf


def test_packaged_weights_give_jax_probabilities():
    theirs = JaxBinaryClassifier.from_state_dict(pickle.loads((REPO / "alphadia_tpu" / PACKAGED).read_bytes()))
    ours = BinaryClassifier.from_state_dict(pickle.loads((REPO / "alphadia_torch" / PACKAGED).read_bytes()), "cpu")
    assert ours.fitted and ours.input_dim == 53
    x = np.random.default_rng(0).normal(size=(256, 53)).astype(np.float32)
    np.testing.assert_allclose(ours.predict_proba(x), theirs.predict_proba(x), rtol=0, atol=1e-6)


def test_fresh_flax_init_gives_jax_probabilities():
    x, _ = _data(n=200)
    theirs = _jax_classifier(_flax_variables(x.shape[1]), x.shape[1])
    ours = BinaryClassifier.from_state_dict(theirs.to_state_dict(), "cpu")
    np.testing.assert_allclose(ours.predict_proba(x), theirs.predict_proba(x), rtol=0, atol=1e-6)


def test_training_matches_jax():
    x, y = _data()
    d = x.shape[1]
    theirs = _jax_classifier(_flax_variables(d), d, random_state=0, epochs=2, dropout=0.0)
    ours = BinaryClassifier.from_state_dict(theirs.to_state_dict(), "cpu")
    ours.random_state, ours.epochs = 0, 2
    theirs.fit(x, y)
    ours.fit(x, y)
    assert ours.n_steps == 2 * ((len(x) - 6) // 128)  # 6 test rows, batches of 128
    want = jax.tree_util.tree_map(np.asarray, theirs.variables)
    got = classifier_to_jax(ours.model.state_dict())
    for group in ("params", "batch_stats"):
        for layer, arrays in want[group].items():
            for name, a in arrays.items():
                np.testing.assert_allclose(got[group][layer][name], a, rtol=1e-3, atol=1e-4, err_msg=f"{layer}/{name}")
    np.testing.assert_allclose(ours.metrics["train_loss"], theirs.metrics["train_loss"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(ours.predict_proba(x), theirs.predict_proba(x), rtol=1e-3, atol=1e-4)


def test_state_dicts_load_across_packages():
    x, y = _data(n=400)
    ours = BinaryClassifier(random_state=1, epochs=2, device="cpu")
    ours.fit(x, y)
    theirs = JaxBinaryClassifier.from_state_dict(ours.to_state_dict())
    np.testing.assert_allclose(theirs.predict_proba(x), ours.predict_proba(x), rtol=0, atol=1e-6)
    back = BinaryClassifier.from_state_dict(theirs.to_state_dict(), "cpu")
    np.testing.assert_allclose(back.predict_proba(x), ours.predict_proba(x), rtol=0, atol=1e-6)
    # pickling a classifier keeps its weights (the FDR manager's store)
    again = pickle.loads(pickle.dumps(ours))
    np.testing.assert_allclose(again.predict_proba(x), ours.predict_proba(x), rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
def test_random_primitives_are_jax(seed):
    key, ours = jax.random.PRNGKey(seed), jax_random.prng_key(seed)
    assert (np.asarray(key) == ours).all()
    assert (np.asarray(jax.random.split(key, 5)) == jax_random.split(ours, 5)).all()
    subs, k = [], key
    for _ in range(4):
        k, sub = jax.random.split(k)
        subs.append(np.asarray(sub))
    assert (np.stack(subs) == jax_random.split_chain(ours, 4)).all()
    assert (np.asarray(jax.random.fold_in(key, 3_000_000_000)) == jax_random.fold_in(ours, 3_000_000_000)).all()
    assert (np.asarray(jax.random.bits(key, (7, 9))) == jax_random.random_bits(ours, (7, 9))).all()
    assert (np.asarray(jax.random.uniform(key, (7, 9))) == jax_random.uniform(ours, (7, 9))).all()
    assert (np.asarray(jax.random.uniform(key, (50,), minval=-0.3, maxval=2.5))
            == jax_random.uniform(ours, (50,), -0.3, 2.5)).all()
    assert (np.asarray(jax.random.bernoulli(key, 0.3, (40, 3))) == jax_random.bernoulli(ours, 0.3, (40, 3))).all()
    uniform = jax_random.uniform_torch(torch.from_numpy(jax_random.split(ours, 3).astype(np.int64)), (4, 6)).numpy()
    for j, sub in enumerate(jax.random.split(key, 3)):
        assert (uniform[j] == np.asarray(jax.random.uniform(sub, (4, 6)))).all()
    want = np.asarray(jax.random.truncated_normal(key, -2, 2, (300, 40)))
    assert _ulps(jax_random.truncated_normal(ours, (300, 40)), want).max() <= 4


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fresh_weights_are_flax_init(seed):
    d = 17
    want = _flax_variables(d, seed=seed, dropout=0.001)["params"]
    model = FeedForwardNN(d)
    model.init_like_flax(jax_random.prng_key(seed))
    got = classifier_to_jax(model.state_dict())["params"]
    for k in range(5):
        w, g = want[f"Dense_{k}"]["kernel"], got[f"Dense_{k}"]["kernel"]
        assert w.shape == g.shape
        assert _ulps(g, w).max() <= 4, f"Dense_{k}"
        assert (g == w).mean() > 0.95
        assert not got[f"Dense_{k}"]["bias"].any()


class _Masks(nn.Module):
    """Dropout modules named as FeedForwardNN's (Dropout_0..3 at the root)."""

    rate: float

    @nn.compact
    def __call__(self, xs):
        return [nn.Dropout(self.rate, deterministic=False)(x) for x in xs]


def test_dropout_masks_are_flax_masks():
    bs, layers, rate, seed = 16, (100, 50, 20, 5), 0.5, 4
    key = jax.random.PRNGKey(seed)
    subs = jax_random.split_chain(jax_random.prng_key(seed), 3)
    keys = torch.from_numpy(FeedForwardNN(7, layers, dropout=rate).dropout_keys(subs).astype(np.int64))
    for t in range(3):
        key, sub = jax.random.split(key)
        assert (np.asarray(sub) == subs[t]).all()
        want = _Masks(rate).apply({}, [jnp.ones((bs, h)) for h in layers], rngs={"dropout": sub})
        for i, h in enumerate(layers):
            got = jax_random.uniform_torch(keys[t, i], (bs, h)).numpy() < 1.0 - rate
            np.testing.assert_array_equal(got, np.asarray(want[i]) > 0, err_msg=f"step {t} layer {i}")


@pytest.mark.parametrize("start", ["fresh", "packaged"])
def test_default_dropout_fit_matches_flax(start):
    if start == "fresh":
        x, y = _data(n=1500)
        theirs = JaxBinaryClassifier(random_state=0, epochs=2)
        ours = BinaryClassifier(random_state=0, epochs=2, device="cpu")
    else:
        x, y = _data(n=1500, d=53)
        theirs = JaxBinaryClassifier.from_state_dict(pickle.loads((REPO / "alphadia_tpu" / PACKAGED).read_bytes()))
        ours = BinaryClassifier.from_state_dict(pickle.loads((REPO / "alphadia_torch" / PACKAGED).read_bytes()), "cpu")
        for clf in (theirs, ours):
            clf.random_state, clf.epochs = 0, 2
    assert ours.dropout == theirs.dropout == 0.001
    theirs.fit(x, y)
    ours.fit(x, y)
    np.testing.assert_allclose(ours.predict_proba(x), theirs.predict_proba(x), rtol=0, atol=1e-4)
