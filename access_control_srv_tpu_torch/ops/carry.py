"""Host-to-device carry: compiled policy tables and encoded request batches
(numpy, from ``ops/compile.py`` / ``ops/encode.py`` of either package) into
the port's torch tensors.

Both functions accept the numpy objects as they are, whichever package
built them, so a test can hand the JAX package's compiled tables and
encoded batch to the port's kernel and the JAX kernel alike.  Bools stay
``torch.bool`` (one byte, read as ``uint8`` by the CUDA kernel); integers
stay int32.  Everything is made contiguous, because the kernel indexes
rows with plain strides.
"""

from __future__ import annotations

import numpy as np
import torch

def pow2_bucket(n: int, floor: int = 8) -> int:
    """Smallest power of two >= n (min `floor`): the shared padding bucket
    of the batch axis and of the regex matrices' entity axis."""
    return max(floor, 1 << max(n - 1, 1).bit_length())


def half_pow2_bucket(n: int, floor: int = 8) -> int:
    """Smallest value >= n of the form 2^k or 1.5 * 2^k (min ``floor``):
    the signature path's row and slot buckets.  The JAX package pads with
    exactly these buckets, so the slot layouts of the two packages are
    identical and comparable."""
    p = pow2_bucket(n, floor)
    return p - p // 4 if n <= p - p // 4 and p - p // 4 >= floor else p


def pad_cols(a: np.ndarray, width: int) -> np.ndarray:
    """Zero-pad the second axis out to `width` (conditions are [n_cond, B];
    regex matrices are [W, E])."""
    a = np.asarray(a)
    if a.shape[1] == width:
        return a
    fill = np.zeros(a.shape[:1] + (width - a.shape[1],), a.dtype)
    return np.concatenate([a, fill], axis=1)


def lead_padding(batch):
    """Shared batch-axis padding contract for every kernel entry: returns
    (b, bucket, e_bucket, pad_lead) where ``pad_lead`` zero-fills the
    leading axis out to the power-of-two bucket.  Rows are independent, so
    zero-padded rows cannot affect real rows."""
    b = batch.arrays[next(iter(batch.arrays))].shape[0]
    bucket = pow2_bucket(b)

    def pad_lead(a: np.ndarray) -> np.ndarray:
        a = np.asarray(a)
        if a.shape[0] == bucket:
            return a
        fill = np.zeros((bucket - a.shape[0],) + a.shape[1:], a.dtype)
        return np.concatenate([a, fill], axis=0)

    e_bucket = pow2_bucket(batch.rgx_set.shape[1])
    return b, bucket, e_bucket, pad_lead


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def tables_from_numpy(arrays: dict, device, keys=None, optional=()
                      ) -> dict[str, torch.Tensor]:
    """Compiled policy arrays -> device tensors; ``keys`` limits them to
    the ones the consumer reads (all of them when None), ``optional``
    adds those of its names the arrays carry (``rule_orig_flat`` of a
    compacted subtree compiled for explain, by either package)."""
    names = list(arrays if keys is None else keys)
    names += [k for k in optional if k in arrays and k not in names]
    return {k: _tensor(np.asarray(arrays[k]), device) for k in names}


def stacked_from_numpy(arrays: list[dict], device, keys
                       ) -> dict[str, torch.Tensor]:
    """Per-signature subtrees (numpy dicts, already padded to one shape)
    -> ``[G, ...]`` device tensors of the arrays named in ``keys``: the
    signature path's stacked varying tables."""
    return {k: _tensor(np.stack([np.asarray(a[k]) for a in arrays]), device)
            for k in keys}


def batch_from_numpy(batch, device, keys=None
                     ) -> tuple[int, dict[str, torch.Tensor]]:
    """Encoded request batch -> (real row count, device tensors).

    ``keys`` limits the per-row arrays carried to the ones the consumer
    reads (all of them when None).  The per-row arrays and the condition
    columns are padded to the batch bucket, the regex matrices to the
    entity bucket (``lead_padding``), as the JAX kernel entry pads them;
    the padding rows are computed and dropped."""
    b, bucket, e_bucket, pad_lead = lead_padding(batch)
    names = batch.arrays if keys is None else keys
    out = {k: _tensor(pad_lead(batch.arrays[k]), device) for k in names}
    out["rgx_set"] = _tensor(pad_cols(batch.rgx_set, e_bucket), device)
    out["pfx_neq"] = _tensor(pad_cols(batch.pfx_neq, e_bucket), device)
    for name in ("cond_true", "cond_abort", "cond_code"):
        out[name] = _tensor(pad_cols(getattr(batch, name), bucket), device)
    return b, out
