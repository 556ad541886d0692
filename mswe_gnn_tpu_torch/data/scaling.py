"""Feature scalers: minmax / minmax_neg / standard, with per-scale variants.

Numpy re-implementation of the reference scaling layer
(reference utils/scaling.py:27-141): scalers are fitted on the training split
only; multiscale datasets get one scaler per scale for area / edge_length /
edge_slope (reference utils/scaling.py:69-110); velocities are fitted on the
vector norm sqrt(VX^2 + VY^2) (reference utils/scaling.py:59-61).
A copy of mswe_gnn_tpu/data/scaling.py, which the port does not import.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np


class Scaler:
    """Column scaler with sklearn-like fit/transform on flat arrays."""

    def __init__(self, kind: str):
        if kind not in ("minmax", "minmax_neg", "standard"):
            raise ValueError(f"unknown scaler kind {kind!r}")
        self.kind = kind
        self.lo = self.hi = self.mean = self.std = None

    def fit(self, x: np.ndarray) -> "Scaler":
        x = np.asarray(x, dtype=np.float64).ravel()
        self.lo, self.hi = float(x.min()), float(x.max())
        self.mean, self.std = float(x.mean()), float(x.std())
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        if self.kind == "minmax":
            span = max(self.hi - self.lo, 1e-12)
            return (x - self.lo) / span
        if self.kind == "minmax_neg":
            span = max(self.hi - self.lo, 1e-12)
            return 2.0 * (x - self.lo) / span - 1.0
        return (x - self.mean) / max(self.std, 1e-12)

    def inverse_transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, dtype=np.float64)
        if self.kind == "minmax":
            return x * (self.hi - self.lo) + self.lo
        if self.kind == "minmax_neg":
            return (x + 1.0) / 2.0 * (self.hi - self.lo) + self.lo
        return x * self.std + self.mean


MaybeScaler = Optional[Union[Scaler, List[Scaler]]]


def fit_scaler(kind: Optional[str], values: Sequence[np.ndarray],
               to_min: bool = False) -> Optional[Scaler]:
    """Fit one scaler on the concatenation of per-sample arrays."""
    if kind is None:
        return None
    vals = [np.asarray(v, dtype=np.float64) for v in values]
    if to_min:
        vals = [v - v.min() for v in vals]
    return Scaler(kind).fit(np.concatenate([v.ravel() for v in vals]))


def fit_multiscale_scaler(kind: Optional[str], per_scale_values: Sequence[Sequence[np.ndarray]]
                          ) -> Optional[List[Scaler]]:
    """One scaler per scale (reference utils/scaling.py:69-110).

    ``per_scale_values[s]`` is the list of that scale's arrays across samples.
    """
    if kind is None:
        return None
    return [Scaler(kind).fit(np.concatenate([np.asarray(v).ravel() for v in vals]))
            for vals in per_scale_values]


def apply_scaler(scaler: Optional[Scaler], x: np.ndarray, to_min: bool = False) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    if to_min:
        x = x - x.min()
    if scaler is None:
        return x
    return scaler.transform(x)
