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
  probabilities (1e-6).
"""

import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from alphadia_torch.convert import classifier_to_jax
from alphadia_torch.models.classifier import BinaryClassifier
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
