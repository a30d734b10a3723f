"""scikit-learn's ``StandardScaler`` and ``MLPClassifier`` (its defaults:
one hidden layer of 100 ReLU units, a logistic output, Adam) in numpy
float64, draw for draw, for the protein FDR (the card machine has no
scikit-learn).

What has to match scikit-learn, and how:

- the scaler: the mean and the variance (``ddof=0``) in its two-pass
  form, ``sum((x - T)^2) - sum(x - T)^2 / n`` over ``n`` with ``T`` the
  mean; a feature whose variance is within the two-pass error bound of a
  constant gets scale 1;
- the draws: one ``np.random.RandomState(random_state)`` per fit; per
  layer a Glorot-uniform ``coef_`` then ``intercept_`` on ``[-b, b]`` with
  ``b = sqrt(6 / (fan_in + fan_out))`` (the factor 2 applies only to a
  logistic *hidden* activation); per epoch one ``shuffle`` of the running
  sample order (``RandomState.shuffle`` of ``arange(n)``, applied to it);
- batches of ``min(200, n)`` in that order, the last one shorter;
- the loss: binary log loss on the output clipped to ``[eps, 1 - eps]``,
  plus ``alpha / 2 * sum(coef^2)`` over the batch size; gradients
  ``(a^T delta + alpha * W) / n`` and ``sum(delta) / n``;
- Adam: ``lr_t = lr * sqrt(1 - b2^t) / (1 - b1^t)``, the update
  ``-lr_t * m / (sqrt(v) + eps)``;
- stopping: after an epoch whose mean loss is not below the best by
  ``tol`` for more than ``n_iter_no_change`` epochs in a row, or after
  ``max_iter`` epochs.
"""

from __future__ import annotations

import numpy as np
from scipy.special import expit, xlogy


class StandardScaler:
    def fit(self, x: np.ndarray) -> "StandardScaler":
        x = np.asarray(x, np.float64)
        n = float(x.shape[0])
        total = x.sum(axis=0)
        self.mean_ = total / n
        temp = x - total / n
        correction = temp.sum(axis=0)
        temp **= 2
        var = (temp.sum(axis=0) - correction**2 / n) / n
        self.var_ = var
        eps = np.finfo(np.float64).eps
        constant = var <= n * eps * var + (n * self.mean_ * eps) ** 2
        scale = np.sqrt(var)
        scale[constant] = 1.0
        self.scale_ = scale
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        x = np.array(x, np.float64, copy=True)
        x -= self.mean_
        x /= self.scale_
        return x

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        return self.fit(x).transform(x)


class MLPClassifier:
    """Binary classifier; ``predict_proba`` gives [P(class 0), P(class 1)]
    for the labels 0 and 1."""

    def __init__(
        self,
        hidden_layer_sizes=(100,),
        alpha: float = 1e-4,
        learning_rate_init: float = 1e-3,
        max_iter: int = 200,
        tol: float = 1e-4,
        n_iter_no_change: int = 10,
        random_state: int | None = None,
        beta_1: float = 0.9,
        beta_2: float = 0.999,
        epsilon: float = 1e-8,
    ):
        self.hidden_layer_sizes = tuple(hidden_layer_sizes)
        self.alpha = alpha
        self.learning_rate_init = learning_rate_init
        self.max_iter = max_iter
        self.tol = tol
        self.n_iter_no_change = n_iter_no_change
        self.random_state = random_state
        self.beta_1, self.beta_2, self.epsilon = beta_1, beta_2, epsilon

    def _forward(self, x: np.ndarray) -> list[np.ndarray]:
        acts = [x]
        last = len(self.coefs_) - 1
        for i, (w, b) in enumerate(zip(self.coefs_, self.intercepts_)):
            a = acts[-1] @ w
            a += b
            if i != last:
                np.maximum(a, 0, out=a)
            else:
                expit(a, out=a)
            acts.append(a)
        return acts

    def _backprop(self, x: np.ndarray, y: np.ndarray):
        n = x.shape[0]
        acts = self._forward(x)
        prob = acts[-1]
        eps = np.finfo(prob.dtype).eps
        p = np.clip(prob, eps, 1 - eps)
        loss = -np.average(xlogy(y, p) + xlogy(1 - y, 1 - p), axis=0).sum()
        values = 0
        for w in self.coefs_:
            s = w.ravel()
            values += np.dot(s, s)
        loss += (0.5 * self.alpha) * values / n

        last = len(self.coefs_) - 1
        coef_grads = [None] * len(self.coefs_)
        intercept_grads = [None] * len(self.coefs_)
        delta = prob - y
        for i in range(last, -1, -1):
            g = acts[i].T @ delta
            g += self.alpha * self.coefs_[i]
            g /= n
            coef_grads[i] = g
            intercept_grads[i] = np.sum(delta, axis=0) / n
            if i > 0:
                delta = delta @ self.coefs_[i].T
                delta[acts[i] == 0] = 0
        return loss, coef_grads + intercept_grads

    def fit(self, x: np.ndarray, y: np.ndarray) -> "MLPClassifier":
        x = np.asarray(x, np.float64)
        y = np.asarray(y).reshape(-1, 1).astype(np.float64)
        n_samples, n_features = x.shape
        rng = np.random.RandomState(self.random_state)
        units = [n_features, *self.hidden_layer_sizes, 1]
        self.coefs_, self.intercepts_ = [], []
        for fan_in, fan_out in zip(units[:-1], units[1:]):
            bound = np.sqrt(6.0 / (fan_in + fan_out))
            self.coefs_.append(rng.uniform(-bound, bound, (fan_in, fan_out)))
            self.intercepts_.append(rng.uniform(-bound, bound, fan_out))
        params = self.coefs_ + self.intercepts_
        ms = [np.zeros_like(p) for p in params]
        vs = [np.zeros_like(p) for p in params]
        t = 0

        batch = min(200, n_samples)
        sample_idx = np.arange(n_samples, dtype=int)
        self.loss_curve_ = []
        best_loss, no_improvement = np.inf, 0
        self.n_iter_ = 0
        for _ in range(self.max_iter):
            perm = np.arange(n_samples)
            rng.shuffle(perm)
            sample_idx = sample_idx[perm]
            accumulated = 0.0
            for start in range(0, n_samples, batch):
                idx = sample_idx[start : start + batch]
                loss, grads = self._backprop(x[idx], y[idx])
                accumulated += loss * len(idx)
                t += 1
                ms = [self.beta_1 * m + (1 - self.beta_1) * g for m, g in zip(ms, grads)]
                vs = [self.beta_2 * v + (1 - self.beta_2) * (g**2) for v, g in zip(vs, grads)]
                lr = self.learning_rate_init * np.sqrt(1 - self.beta_2**t) / (1 - self.beta_1**t)
                for p, m, v in zip(params, ms, vs):
                    p += -lr * m / (np.sqrt(v) + self.epsilon)
            self.n_iter_ += 1
            epoch_loss = accumulated / n_samples
            self.loss_curve_.append(epoch_loss)
            if epoch_loss > best_loss - self.tol:
                no_improvement += 1
            else:
                no_improvement = 0
            if epoch_loss < best_loss:
                best_loss = epoch_loss
            if no_improvement > self.n_iter_no_change:
                break
        return self

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        p = self._forward(np.asarray(x, np.float64))[-1].ravel()
        return np.vstack([1 - p, p]).T
