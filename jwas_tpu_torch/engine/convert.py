"""Arrays of the JAX package -> the port's tensors.

For tests that make both packages compute from identical parameters: the
grouped store and its statistics as jwas_tpu builds them (numpy-converted
GroupedPackedMarkers fields, with j-major Gram tiles (b, b, nblocks)) become
a GroupedPackedMarkers of this package with block-major Grams
(nblocks, b, b) over the (p_pad, bpm) store, and chain-state arrays become
flat tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from jwas_tpu_torch.ops.grouped import GroupedPackedMarkers, GroupFetcher


def from_jax_arrays(store, means, valid, xpx, grams, n_obs: int,
                    row_perm=None, *, device="cpu", **state):
    """Returns (gm, state): state maps each keyword to a tensor on device
    (int arrays keep int32, the rest become float32)."""
    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.array(x), dtype=dtype).to(device)

    ngroups, G, bpm = np.shape(store)
    gm = GroupedPackedMarkers(
        fetch=GroupFetcher(t(store, torch.uint8).view(ngroups * G, bpm), G,
                           device, ngroups),
        means=t(means),
        row_perm=None if row_perm is None else t(row_perm, torch.int64),
        xpx=t(xpx),
        # j-major grams[j, r, k] -> block-major [k, j, r]
        grams=t(np.ascontiguousarray(np.transpose(np.asarray(grams), (2, 0, 1)))),
        valid=t(valid),
        n_obs=int(n_obs),
    )
    out = {}
    for name, x in state.items():
        x = np.asarray(x)
        out[name] = t(x, torch.int32 if x.dtype.kind in "iu" else torch.float32)
    return gm, out
