"""Target-decoy classifier: a feed-forward network in PyTorch, on the card.

The JAX package's flax/optax classifier, step for step:

- BatchNorm(input) -> [Linear -> ReLU -> Dropout] over (100, 50, 20, 5)
  -> Linear(2) -> softmax;
- loss: binary cross-entropy on the softmax clipped to [1e-7, 1 - 1e-7],
  with ``jnp.clip``'s gradient (half of it at a bound);
- Adam (eps 1e-8 outside the square root) with coupled L2 weight decay
  1e-5, ``optax.chain(add_decayed_weights, adam)``: :class:`Adam` here
  (``torch.optim.Adam(weight_decay=..., fused=True)`` computes the same,
  but a process's first fit with it took ~12 s on an H100 against ~4 s
  with this one, both eager: ``tests/torch_fit_timing.py``);
- batch size and learning rate scaled with the sample count; ``epochs``
  passes over shuffled batches of a train split.

What has to match flax, and how:

- flax's BatchNorm keeps running statistics with momentum 0.9 and the
  *biased* batch variance (``mean(x^2) - mean(x)^2``); ``nn.BatchNorm1d``
  uses the unbiased one, so :class:`BatchNorm` here is flax's;
- the random numbers are JAX's (``utils/jax_random``): the Dense kernels
  are flax's ``lecun_normal`` draws from ``PRNGKey(seed)`` (to a few
  float32 ulps, see there), zero biases, BN scale 1, bias 0; the dropout
  masks of step ``t`` come from the ``t``-th ``key, sub = split(key)`` of
  the same key and each Dropout module's ``make_rng('dropout')`` under
  ``sub``, counting the padded steps JAX's scan takes too;
- the numpy generator is drawn in flax's order: the seed (also on a warm
  start), the test split, then one permutation of the batches per epoch;
  rows past ``num_batches * batch`` are never trained on;
- the epoch metric is the loss of each epoch's last batch.

The dropout uniforms are made on the fit's device in blocks of steps, from
keys derived on the host once per fit. The training matrix is uploaded once, each batch is copied from it on
the device into the step's input buffers, and the losses are read once per
fit: no step waits for the device. On the card the first steps run eagerly
on a side stream, and then one step (forward, backward, the Adam update)
is captured as a CUDA graph and replayed for every further step:
a step is ~120 small kernels, whose launches cost the host more than the
card's work (on an H100 host, ~0.6 ms a step replayed against ~5 ms
eager; ``tests/torch_fit_timing.py``).

``to_state_dict`` and ``from_state_dict`` keep the JAX package's format
(flax names, numpy arrays), so a store that either package saved loads in
the other.
"""

from __future__ import annotations

import io
import pickle
from contextlib import nullcontext

import numpy as np
import torch
from torch import nn

from alphadia_torch.convert import classifier_from_jax, classifier_to_jax
from alphadia_torch.utils.jax_random import flax_rng, lecun_normal, prng_key, split_chain, uniform_torch
from alphadia_torch.utils.device import resolve_device


class BatchNorm(nn.Module):
    """Flax's ``nn.BatchNorm(momentum=0.9)`` over the feature axis."""

    def __init__(self, dim: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=0)
            var = ((x * x).mean(dim=0) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                self.mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
                self.var.mul_(self.momentum).add_((1.0 - self.momentum) * var)
        else:
            mean, var = self.mean, self.var
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


class FeedForwardNN(nn.Module):
    def __init__(self, input_dim: int, layers=(100, 50, 20, 5), output_dim: int = 2, dropout: float = 0.001):
        super().__init__()
        self.dropout = dropout
        self.norm = BatchNorm(input_dim)
        dims = [input_dim, *layers, output_dim]
        self.dense = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x, noise: torch.Tensor | None = None):
        """``noise``: uniform draws [B, sum(hidden widths)] for the dropout
        masks of a training step (unused in eval mode or at dropout 0)."""
        x = self.norm(x)
        keep = np.float32(1.0 - self.dropout)
        # XLA turns flax's ``x / keep`` into a product with the float32
        # reciprocal; a true division rounds otherwise for ~15-50% of values
        scale = float(np.float32(1.0) / keep)
        col = 0
        for layer in self.dense[:-1]:
            x = torch.relu(layer(x))
            if self.training and self.dropout > 0.0:
                mask = noise[:, col : col + x.shape[1]] < float(keep)
                x = torch.where(mask, x * scale, 0.0)
                col += x.shape[1]
        return torch.softmax(self.dense[-1](x), dim=-1)

    def init_like_flax(self, key: np.ndarray) -> None:
        """flax's ``model.init(key)``: each ``Dense_k`` kernel is the
        ``lecun_normal`` draw of that scope's first ``make_rng('params')``,
        biases are zero (BN starts at scale 1, bias 0)."""
        with torch.no_grad():
            for k, layer in enumerate(self.dense):
                shape = (layer.weight.shape[1], layer.weight.shape[0])
                w = lecun_normal(flax_rng(key, f"Dense_{k}", 1), shape)
                layer.weight.copy_(torch.from_numpy(np.ascontiguousarray(w.T)))
                layer.bias.zero_()

    def dropout_keys(self, subs: np.ndarray) -> np.ndarray:
        """The key of each Dropout module's mask under each step's ``sub``
        key: uint32 [steps, layers, 2]."""
        n = len(self.dense) - 1
        return np.stack([flax_rng(subs, f"Dropout_{i}", 1) for i in range(n)], axis=1)


class Adam:
    """``optax.chain(add_decayed_weights(weight_decay), adam(lr))``: the
    gradient plus ``weight_decay`` times the parameter feeds the moments,
    the update is ``-lr * m_hat / (sqrt(v_hat) + eps)``. The step count
    lives on the device, so that a CUDA graph can hold a step."""

    def __init__(self, params, lr: float, weight_decay: float, b1=0.9, b2=0.999, eps=1e-8):
        self.params = list(params)
        self.lr, self.weight_decay, self.b1, self.b2, self.eps = lr, weight_decay, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), device=self.params[0].device)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        self.count += 1.0
        bc1 = 1.0 - torch.pow(self.b1, self.count)
        bc2 = 1.0 - torch.pow(self.b2, self.count)
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad + self.weight_decay * p
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (m / bc1) / (torch.sqrt(v / bc2) + self.eps))


# steps that run eagerly before a step is captured as a CUDA graph (the
# warm-up that lazy initialisation needs); dropout uniforms per block of
# steps (at most 64 steps, at most 2**22 values: the threefry rounds hold
# a few int64 temporaries of that size)
WARMUP_STEPS = 3
NOISE_BLOCK = 64
NOISE_BLOCK_VALUES = 1 << 22


def _scaled_training_params(n_samples, base_lr=0.001, max_batch=4096, min_batch=128):
    if n_samples >= 1_000_000:
        return max_batch, base_lr
    batch_size = int(np.clip((n_samples / 1_000_000) * max_batch, min_batch, max_batch))
    # rounded up to a power of two, as the JAX package does
    batch_size = 1 << int(np.ceil(np.log2(batch_size)))
    batch_size = min(batch_size, max_batch)
    return batch_size, base_lr * np.sqrt(batch_size / max_batch)


class BinaryClassifier:
    """fit / predict_proba over PSM feature matrices, on ``device`` (None:
    the card)."""

    def __init__(
        self,
        test_size: float = 0.001,
        batch_size: int = 5000,
        epochs: int = 10,
        learning_rate: float = 0.001,
        weight_decay: float = 1e-5,
        layers: tuple = (100, 50, 20, 5),
        dropout: float = 0.001,
        experimental_hyperparameter_tuning: bool = True,
        random_state: int | None = None,
        device=None,
    ):
        self.test_size = test_size
        self.batch_size = batch_size
        self.epochs = epochs
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.layers = tuple(layers)
        self.dropout = dropout
        self.experimental_hyperparameter_tuning = experimental_hyperparameter_tuning
        self.random_state = random_state
        self.device = resolve_device(device)

        self.input_dim: int | None = None
        self.model: FeedForwardNN | None = None
        self.metrics: dict[str, list] = {"train_loss": []}
        self.n_steps = 0  # optimiser steps of the last fit
        self._fitted = False

    @property
    def fitted(self) -> bool:
        return self._fitted

    def fit(self, x: np.ndarray, y: np.ndarray) -> None:
        x = np.asarray(x, dtype=np.float32)
        y = np.asarray(y)
        if y.ndim == 1:
            y = np.stack([1 - y, y], axis=1).astype(np.float32)
        if self.experimental_hyperparameter_tuning:
            self.batch_size, self.learning_rate = _scaled_training_params(len(x))

        rng_np = np.random.default_rng(self.random_state)
        seed = int(rng_np.integers(0, 2**31)) if self.random_state is not None else 0
        key = prng_key(seed)
        if self.model is None or self.input_dim != x.shape[1]:
            self.input_dim = x.shape[1]
            model = FeedForwardNN(self.input_dim, self.layers, y.shape[1], self.dropout)
            model.init_like_flax(key)
            self.model = model.to(self.device)
        model = self.model

        # the train split; the test rows serve no metric here, as in JAX
        n = len(x)
        n_test = max(int(n * self.test_size), 1)
        train_idx = rng_np.permutation(n)[n_test:]
        bs = min(self.batch_size, len(train_idx))
        num_batches = max(len(train_idx) // bs, 1)
        starts = [rng_np.permutation(num_batches) * bs for _ in range(self.epochs)]
        dropout_keys = None
        if self.dropout > 0.0:
            # JAX's scan pads each epoch to a power of two of steps and
            # splits the key on the padded steps too
            nb_pad = 1 << int(np.ceil(np.log2(num_batches)))
            subs = split_chain(key, self.epochs * nb_pad)
            real = (np.arange(self.epochs)[:, None] * nb_pad + np.arange(num_batches)).reshape(-1)
            dropout_keys = torch.from_numpy(model.dropout_keys(subs[real]).astype(np.int64)).to(self.device)

        xt = torch.from_numpy(x[train_idx]).to(self.device)
        yt = torch.from_numpy(y[train_idx].astype(np.float32)).to(self.device)
        model.train()
        epoch_loss = self._train(model, xt, yt, starts, bs, dropout_keys)
        model.eval()
        self.n_steps = self.epochs * num_batches
        # the only read of the device in a fit
        self.metrics["train_loss"].extend(torch.stack(epoch_loss).cpu().tolist())
        self._fitted = True

    def _train(self, model, xt, yt, starts, bs, dropout_keys) -> list:
        """Every optimiser step of a fit, batch rows ``starts[epoch][k]`` on;
        ``dropout_keys`` (int64 [steps, layers, 2] on the device, or None at
        dropout 0) give each step's masks. Returns the loss of each epoch's
        last step (on the device)."""
        dev = self.device
        on_card = dev.type == "cuda"
        opt = Adam(model.parameters(), float(self.learning_rate), float(self.weight_decay))
        x_in = torch.empty((bs, xt.shape[1]), device=dev)
        y_in = torch.empty((bs, yt.shape[1]), device=dev)
        width = sum(self.layers) if dropout_keys is not None else 0
        noise = torch.empty((bs, width), device=dev)
        per_block = max(1, min(NOISE_BLOCK, NOISE_BLOCK_VALUES // max(bs * width, 1)))
        block: list = []
        drawn = [0]

        def load(s: int) -> None:
            x_in.copy_(xt[s : s + bs])
            y_in.copy_(yt[s : s + bs])
            if width:
                if not block:
                    keys = dropout_keys[drawn[0] : drawn[0] + per_block]
                    drawn[0] += len(keys)
                    layers = [uniform_torch(keys[:, i], (bs, h)) for i, h in enumerate(self.layers)]
                    block.extend(torch.cat(layers, dim=2).unbind(0))
                noise.copy_(block.pop(0))

        # jnp.clip's gradient: half at a bound (``clamp`` passes all of it),
        # which matters once the softmax saturates onto 1 - 1e-7
        p_lo = torch.tensor(1e-7, device=dev)
        p_hi = torch.tensor(1.0 - 1e-7, device=dev)

        def step():
            p = torch.minimum(torch.maximum(model(x_in, noise), p_lo), p_hi)
            loss = -(y_in * torch.log(p) + (1.0 - y_in) * torch.log(1.0 - p)).mean()
            loss.backward()
            opt.step()
            return loss

        flat = [int(s) for order in starts for s in order]
        last = {len(order) * (e + 1) - 1 for e, order in enumerate(starts)}
        epoch_loss = []
        eager = len(flat) if not on_card or len(flat) <= WARMUP_STEPS else WARMUP_STEPS
        stream = torch.cuda.Stream(dev) if on_card else None
        if on_card:
            stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream) if on_card else nullcontext():
            for i in range(eager):
                load(flat[i])
                opt.zero_grad()
                loss = step()
                if i in last:
                    epoch_loss.append(loss.detach().clone())
        if eager == len(flat):
            return epoch_loss
        torch.cuda.current_stream(dev).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        opt.zero_grad()
        with torch.cuda.graph(graph):
            loss = step()
        for i in range(eager, len(flat)):
            load(flat[i])
            graph.replay()
            if i in last:
                epoch_loss.append(loss.detach().clone())
        return epoch_loss

    @torch.no_grad()
    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        if not self._fitted:
            raise RuntimeError("classifier not fitted")
        self.model.eval()
        xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(self.device)
        return self.model(xt).cpu().numpy()

    def predict(self, x: np.ndarray) -> np.ndarray:
        return np.argmax(self.predict_proba(x), axis=1)

    def to_state_dict(self) -> dict:
        """The JAX package's state format: flax variables as numpy arrays."""
        variables = None if self.model is None else classifier_to_jax(self.model.state_dict())
        buf = io.BytesIO()
        pickle.dump(variables, buf)
        return {
            "variables": buf.getvalue(),
            "input_dim": self.input_dim,
            "layers": self.layers,
            "dropout": self.dropout,
            "fitted": self._fitted,
            "batch_size": self.batch_size,
            "learning_rate": self.learning_rate,
        }

    @classmethod
    def from_state_dict(cls, state: dict, device=None) -> "BinaryClassifier":
        obj = cls(layers=state["layers"], dropout=state["dropout"], device=device)
        obj.input_dim = state["input_dim"]
        obj.batch_size = state["batch_size"]
        obj.learning_rate = state["learning_rate"]
        variables = pickle.loads(state["variables"])
        if variables is not None:
            model = FeedForwardNN(obj.input_dim, obj.layers, 2, obj.dropout)
            model.load_state_dict(classifier_from_jax(variables))
            obj.model = model.to(obj.device).eval()
        obj._fitted = state["fitted"]
        return obj

    def __getstate__(self):
        state = dict(self.__dict__)
        state["model"] = self.to_state_dict()
        state["device"] = str(self.device)
        return state

    def __setstate__(self, state):
        model_state = state.pop("model")
        self.__dict__.update(state)
        self.device = torch.device(state["device"])
        self.model = BinaryClassifier.from_state_dict(model_state, self.device).model
