"""Times the FDR classifier's fit on the card, three ways, at the sizes of
``chip_smoke.py`` phase [6] (6,687 PSMs on the 3D world, 31,867 on the 4D
world; 53 features, the network's default batch and 10 epochs):

- ``eager``: one eager step after another, the port's hand-written Adam;
- ``eager_torch_adam``: the same loop with ``torch.optim.Adam(fused=True)``;
- ``graph``: the port's fit (three eager steps on a side stream, then one
  step captured as a CUDA graph and replayed).

Each way runs in a process of its own (its first fit pays the process's
start-up of the training kernels), twice in the order above; a process
times its first fit and then three fits of each size. Usage, on the card:

    python3 tests/torch_fit_timing.py

Prints one line a fit: way, size, wall seconds (to the read of the
losses), steps, ms a step, the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SIZES = {"3D": 6687, "4D": 31867}
N_FEATURES = 53
WAYS = ("eager", "eager_torch_adam", "graph")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def data(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    y = (rng.random(n) < 0.5).astype(np.float32)
    x = rng.normal(size=(n, N_FEATURES)).astype(np.float32) + y[:, None] * 0.5
    return x, y


def classifier_class(way: str):
    import torch

    from alphadia_torch.models.classifier import Adam, BinaryClassifier

    if way == "graph":
        return BinaryClassifier

    class Eager(BinaryClassifier):
        def _train(self, model, xt, yt, starts, bs, generator):
            if way == "eager":
                opt = Adam(model.parameters(), float(self.learning_rate), float(self.weight_decay))
            else:
                opt = torch.optim.Adam(
                    model.parameters(), lr=float(self.learning_rate), weight_decay=float(self.weight_decay), fused=True
                )
            width = sum(self.layers) if self.dropout > 0.0 else 0
            epoch_loss = []
            for order in starts:
                for s in order.tolist():
                    noise = torch.rand((bs, width), generator=generator, device=self.device) if width else None
                    p = model(xt[s : s + bs], noise).clamp(1e-7, 1.0 - 1e-7)
                    y = yt[s : s + bs]
                    loss = -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p)).mean()
                    opt.zero_grad()
                    loss.backward()
                    opt.step()
                epoch_loss.append(loss.detach())
            return epoch_loss

    return Eager


def run_way(way: str) -> None:
    import torch

    card = card_line()
    cls = classifier_class(way)
    sets = {name: data(n) for name, n in SIZES.items()}
    order = ["3D"] + ["3D", "4D"] * 3
    for k, name in enumerate(order):
        clf = cls(random_state=k, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        clf.fit(*sets[name])  # ends with the read of the losses
        wall = time.perf_counter() - t0
        assert np.isfinite(clf.metrics["train_loss"]).all()
        what = "first fit of the process" if k == 0 else "fit"
        print(
            f"{way} {name} {what}: {wall:.4f} s, {clf.n_steps} steps, {wall / clf.n_steps * 1e3:.4f} ms a step, "
            f"last loss {clf.metrics['train_loss'][-1]:.5f} ({card})",
            flush=True,
        )


def main() -> int:
    if len(sys.argv) > 1:
        run_way(sys.argv[1])
        return 0
    for _ in range(2):
        for way in WAYS:
            subprocess.run([sys.executable, __file__, way], check=True, cwd=ROOT)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
