"""Peptide property models: retention time, charge, MS2 intensities and ion
mobility, in PyTorch.

Shared architecture: residue-token embedding plus a modification-mass
channel -> two 1-D convolution blocks (local context) -> a property head:

- RT / mobility: masked mean-pool and a length feature -> MLP -> scalar;
- charge: the same pool -> MLP -> sigmoid per charge 1..6;
- MS2: per cleavage site the flanking states with charge and NCE features
  -> MLP -> relu intensities per fragment type and charge, divided by the
  precursor's largest.

Sequences are encoded to ``MAX_LEN`` tokens, 0 the pad. The JAX package's
flax models of ``models/property_models.py``, layer for layer: the packaged
weights carry across through ``convert.property_models_from_jax``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from alphadia_torch.library import chem

MAX_LEN = 35
VOCAB = "ACDEFGHIKLMNPQRSTVWYU"
TOKEN_OF = {aa: i + 1 for i, aa in enumerate(VOCAB)}  # 0 = pad
MAX_CHARGE = 6
FRAG_COLS = ("b_z1", "b_z2", "y_z1", "y_z2")
DIM = 64
KERNEL = 5


def encode_sequences(sequences, mods=None, mod_sites=None, max_len: int = MAX_LEN) -> tuple[np.ndarray, np.ndarray]:
    """(tokens i32[B, L], modification mass / 100 f32[B, L]); a modification
    the table does not know adds nothing."""
    n = len(sequences)
    tokens = np.zeros((n, max_len), np.int32)
    mod_mass = np.zeros((n, max_len), np.float32)
    for i, seq in enumerate(sequences):
        s = str(seq)[:max_len]
        tokens[i, : len(s)] = [TOKEN_OF.get(a, 0) for a in s]
        if mods is not None and mods[i]:
            names = [m for m in str(mods[i]).split(";") if m]
            sites = [x for x in str(mod_sites[i]).split(";") if x != ""]
            for name, site in zip(names, sites):
                pos = int(site)
                idx = 0 if pos <= 0 else min(pos - 1, max_len - 1)
                try:
                    mod_mass[i, idx] += chem.mod_delta_mass(name)
                except KeyError:
                    pass
    return tokens, mod_mass / 100.0  # scale to O(1)


class SequenceEncoder(nn.Module):
    """Per-residue states [B, L, DIM] (zero at the pad) and the mask [B, L, 1].
    The pad's embedding row is not zero: the mask applies after the
    modification channel is added, as in the flax model."""

    def __init__(self, dim: int = DIM):
        super().__init__()
        self.embed = nn.Embedding(len(VOCAB) + 1, dim)
        self.mod = nn.Linear(1, dim)
        # flax Conv(padding="SAME") with kernel 5 pads 2 and 2; both are
        # cross-correlations
        self.conv0 = nn.Conv1d(dim, dim, KERNEL, padding=KERNEL // 2)
        self.conv1 = nn.Conv1d(dim, dim, KERNEL, padding=KERNEL // 2)

    def forward(self, tokens, mod_mass):
        mask = (tokens > 0).to(torch.float32)[..., None]
        x = self.embed(tokens.long()) + self.mod(mod_mass[..., None])
        x = x * mask
        h = F.relu(self.conv0(x.transpose(1, 2)))
        h = F.relu(self.conv1(h)).transpose(1, 2) + x
        return h * mask, mask


def _masked_pool(h, mask):
    """Mean-pool plus a length feature (additive properties need length)."""
    length = mask.sum(dim=1)
    mean = (h * mask).sum(dim=1) / torch.clamp(length, min=1.0)
    return torch.cat([mean, length / 35.0], dim=-1)


class _PooledHead(nn.Module):
    """Encoder -> pool (+ extra features) -> Dense -> relu -> Dense."""

    def __init__(self, n_extra: int, n_out: int, dim: int = DIM):
        super().__init__()
        self.encoder = SequenceEncoder(dim)
        self.hidden = nn.Linear(dim + 1 + n_extra, dim)
        self.out = nn.Linear(dim, n_out)

    def head(self, tokens, mod_mass, *extra):
        h, mask = self.encoder(tokens, mod_mass)
        p = torch.cat([_masked_pool(h, mask), *extra], dim=-1)
        return self.out(F.relu(self.hidden(p)))


class RTModel(_PooledHead):
    def __init__(self, dim: int = DIM):
        super().__init__(0, 1, dim)

    def forward(self, tokens, mod_mass):
        return self.head(tokens, mod_mass)[..., 0]  # normalised RT


class MobilityModel(_PooledHead):
    def __init__(self, dim: int = DIM):
        super().__init__(1, 1, dim)

    def forward(self, tokens, mod_mass, charge):
        return self.head(tokens, mod_mass, charge[..., None].to(torch.float32) / 4.0)[..., 0]


class ChargeModel(_PooledHead):
    def __init__(self, dim: int = DIM):
        super().__init__(0, MAX_CHARGE, dim)

    def forward(self, tokens, mod_mass):
        return torch.sigmoid(self.head(tokens, mod_mass))  # P(charge z observable)


class MS2Model(nn.Module):
    def __init__(self, dim: int = DIM, n_frag_cols: int = len(FRAG_COLS)):
        super().__init__()
        self.encoder = SequenceEncoder(dim)
        self.hidden = nn.Linear(2 * dim + 2, dim)
        self.out = nn.Linear(dim, n_frag_cols)

    def forward(self, tokens, mod_mass, charge, nce: float = 25.0):
        h, _ = self.encoder(tokens, mod_mass)
        left, right = h[:, :-1, :], h[:, 1:, :]  # the states before and after each cleavage site
        z = (charge.to(torch.float32) / 4.0)[:, None, None].expand(-1, left.shape[1], 1)
        nce_f = torch.full_like(z, nce / 100.0)
        site = F.relu(self.hidden(torch.cat([left, right, z, nce_f], dim=-1)))
        out = F.relu(self.out(site))  # [B, L-1, F]
        out = out * (tokens[:, 1:] > 0).to(torch.float32)[..., None]
        # the largest over sites and columns, masked zeros included
        peak = out.amax(dim=(1, 2), keepdim=True)
        return out / torch.clamp(peak, min=1e-6)


# the packaged and saved weights' keys: the flax variables of each model
MODEL_OF = {"rt": RTModel, "ms2": MS2Model, "ccs": MobilityModel, "charge": ChargeModel}
