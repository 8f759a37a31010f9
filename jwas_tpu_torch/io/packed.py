"""The 2-bit packed genotype store: loader, writer, converter, missing scan.

numpy-only counterpart of jwas_tpu/io/packed.py: the .j2b + .manifest.json
loader (Packed2BitStore.load, :143-171, with mmap) and writer
(Packed2BitStore.save, :121-141), the converter prepare_packed_genotypes
(:186-276: missing codes, means and allele frequencies, MAF filter) with
the code -> byte packer (_pack_numpy, :401), its out-of-core low_memory
mode (_prepare_packed_low_memory, :288-398) and store_has_missing
(jwas_tpu/ops/grouped.py:975-993). The converter reads a CSV in row chunks
with the csv module and packs with numpy; jwas_tpu's C++ packer is not
ported.

Layout: marker-major (p, ceil(n/4)) uint8; byte i of a marker holds the codes
of observations 4i..4i+3, low bits first; code 3 is missing (read as the
marker mean). `packed` may also be a uint8 tensor on a device (a store
generated there), which the grouped path then uses in place.
"""

from __future__ import annotations

import itertools
import json
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from jwas_tpu_torch.io.table import NA_VALUES, as_table, parse_column, read_csv_rows

FORMAT = "jwas_tpu-2bit-v1"


@dataclass
class Packed2BitStore:
    obs_ids: List[str]
    marker_ids: List[str]
    packed: object            # (p, ceil(n/4)) uint8: numpy (possibly a
                              # memmap) or a torch tensor
    means: np.ndarray         # (p,) float64 mean over non-missing codes
    allele_freq: np.ndarray   # (p,)
    n_obs: int
    n_markers: int
    has_missing: Optional[bool] = None   # None: manifest predates the flag

    @property
    def sum2pq(self) -> float:
        f = np.asarray(self.allele_freq, dtype=np.float64)
        return float(np.sum(2.0 * f * (1.0 - f)))

    def save(self, path: str) -> None:
        """Write <path>.j2b and <path>.manifest.json, each under a temporary
        name first and then renamed (jwas_tpu's format and publish order)."""
        packed = self.packed
        if not isinstance(packed, np.ndarray):
            packed = packed.cpu().numpy()
        np.ascontiguousarray(packed).tofile(path + ".j2b.tmp")
        self._publish(path)

    def _publish(self, path: str) -> None:
        """Write the manifest under a temporary name, then rename
        <path>.j2b.tmp and the manifest into place."""
        manifest = {
            "format": FORMAT, "n_obs": self.n_obs, "n_markers": self.n_markers,
            "obs_ids": list(self.obs_ids), "marker_ids": list(self.marker_ids),
            "means": np.asarray(self.means, dtype=np.float64).tolist(),
            "allele_freq": np.asarray(self.allele_freq, dtype=np.float64).tolist(),
        }
        if self.has_missing is not None:
            manifest["has_missing"] = bool(self.has_missing)
        mtmp = path + ".manifest.json.tmp"
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
        os.replace(path + ".j2b.tmp", path + ".j2b")
        os.replace(mtmp, path + ".manifest.json")

    @staticmethod
    def load(path: str, mmap: bool = False) -> "Packed2BitStore":
        """Read <path>.j2b and <path>.manifest.json. mmap=True maps the
        .j2b file instead of reading it into memory."""
        with open(path + ".manifest.json") as f:
            man = json.load(f)
        if man.get("format") != FORMAT:
            raise ValueError(f"unrecognized packed-store format in {path}")
        n, p = int(man["n_obs"]), int(man["n_markers"])
        bpm = (n + 3) // 4
        if mmap:
            packed = np.memmap(path + ".j2b", dtype=np.uint8, mode="r",
                               shape=(p * bpm,))
        else:
            packed = np.fromfile(path + ".j2b", dtype=np.uint8)
        if packed.size != p * bpm:
            raise ValueError("packed store size mismatch with manifest")
        return Packed2BitStore(
            obs_ids=[str(s) for s in man["obs_ids"]],
            marker_ids=[str(s) for s in man["marker_ids"]],
            packed=packed.reshape(p, bpm),
            means=np.asarray(man["means"], dtype=np.float64),
            allele_freq=np.asarray(man["allele_freq"], dtype=np.float64),
            n_obs=n,
            n_markers=p,
            has_missing=man.get("has_missing"),
        )


def pack_codes(codes: np.ndarray) -> np.ndarray:
    """Pack (n, p) codes in {0, 1, 2, 3} into (p, ceil(n/4)) marker-major
    bytes (jwas_tpu's _pack_numpy)."""
    n, p = codes.shape
    bpm = (n + 3) // 4
    padded = np.zeros((bpm * 4, p), dtype=np.uint8)
    padded[:n] = codes
    quads = padded.reshape(bpm, 4, p)
    out = (quads[:, 0, :] | (quads[:, 1, :] << np.uint8(2))
           | (quads[:, 2, :] << np.uint8(4)) | (quads[:, 3, :] << np.uint8(6)))
    return np.ascontiguousarray(out.T)


def _genotype_chunks(file, separator: str, header: bool, chunk_rows: int,
                     dtype=np.float32):
    """(marker_ids, iterator of (obs_ids, (rows, p) chunk of dtype)) of a
    genotype file, a table or an (n, p) array; IDs as jwas_tpu reads them
    (_read_genotype_input: the first column, stripped; markers numbered
    from 1 without a header or for an array)."""
    if isinstance(file, np.ndarray):
        n, p = file.shape
        ids = [str(i + 1) for i in range(n)]
        return [str(j + 1) for j in range(p)], iter(
            [(ids, np.asarray(file, dtype=dtype))])
    if isinstance(file, (str, os.PathLike)):
        rows = read_csv_rows(str(file), separator)
        first = next(rows)
        if header:
            marker_ids = [str(c) for c in first[1:]]
        else:
            marker_ids = [str(j + 1) for j in range(len(first) - 1)]
            rows = itertools.chain([first], rows)

        def chunks():
            buf = []
            for r in rows:
                buf.append(r)
                if len(buf) == chunk_rows:
                    yield _parse_chunk(buf, dtype)
                    buf = []
            if buf:
                yield _parse_chunk(buf, dtype)
        return marker_ids, chunks()
    t = as_table(file)
    cols = t.columns
    marker_ids = ([str(c) for c in cols[1:]] if header
                  else [str(j + 1) for j in range(len(cols) - 1)])
    ids = [str(x).strip() for x in t[cols[0]].tolist()]
    mat = np.stack([np.asarray(t[c], dtype=dtype) for c in cols[1:]], axis=1)
    return marker_ids, iter([(ids, mat)])


def _parse_chunk(rows, dtype=np.float32):
    ids = [r[0].strip() for r in rows]
    tok = np.array([r[1:] for r in rows], dtype=object)
    tok[np.isin(tok, list(NA_VALUES))] = "nan"
    return ids, tok.astype(dtype)


def prepare_packed_genotypes(file, *, separator: str = ",", header: bool = True,
                             missing_value: float = 9.0, MAF: float = 0.0,
                             save_path: Optional[str] = None,
                             low_memory: bool = False, chunk_rows: int = 8192,
                             disk_guard_ratio: float = 0.95) -> Packed2BitStore:
    """Convert genotypes (a CSV path, a table or an (n, p) array) into a
    2-bit packed store (jwas_tpu's prepare_packed_genotypes).

    Values equal to missing_value, or missing, get code 3; the rest are
    rounded and clipped to 0..2. Means and allele frequencies are taken
    over the non-missing values; MAF > 0 drops markers with frequency
    outside (MAF, 1 - MAF) and fixed loci. A CSV is read chunk_rows rows at
    a time; the codes, one byte a value, are held until the filter is
    known. save_path writes the store with Packed2BitStore.save.

    low_memory=True is the out-of-core mode: a CSV path is read twice in
    4-row-aligned chunks, the first pass for the statistics, the second
    packing each chunk into its byte range of a marker-major .j2b on disk
    at save_path (required), so no whole matrix is held. A disk guard
    refuses a store larger than disk_guard_ratio of the free space there.
    The returned store's packed array is a read-only memmap of that file.
    """
    if low_memory:
        return _prepare_packed_low_memory(
            file, separator=separator, header=header,
            missing_value=missing_value, MAF=MAF, save_path=save_path,
            chunk_rows=chunk_rows, disk_guard_ratio=disk_guard_ratio)
    marker_ids, chunks = _genotype_chunks(file, separator, header, chunk_rows)
    p = len(marker_ids)
    mv = np.float32(missing_value)
    obs_ids: List[str] = []
    codes = []
    sums = np.zeros(p, dtype=np.float64)
    nmiss = np.zeros(p, dtype=np.int64)
    for ids, mat in chunks:
        obs_ids.extend(ids)
        miss = (mat == mv) | np.isnan(mat)
        sums += np.where(miss, 0.0, mat).sum(axis=0, dtype=np.float64)
        nmiss += miss.sum(axis=0)
        codes.append(np.where(miss, 3, np.clip(np.rint(mat), 0, 2)).astype(np.uint8))
    # IDs typed as pandas types the column, then as strings
    obs_ids = [str(x).strip() for x in parse_column(obs_ids).tolist()]
    n = len(obs_ids)
    means = sums / np.maximum(n - nmiss, 1)
    freqs = means / 2.0
    keep = np.ones(p, dtype=bool)
    if MAF > 0:
        keep = (freqs > MAF) & (freqs < 1 - MAF) & (freqs * (1.0 - freqs) > 0)
    codes = np.concatenate(codes, axis=0) if codes else np.zeros((0, p), np.uint8)
    if not keep.all():
        codes = codes[:, keep]
        marker_ids = [m for m, k in zip(marker_ids, keep) if k]
    store = Packed2BitStore(
        obs_ids=obs_ids, marker_ids=marker_ids, packed=pack_codes(codes),
        means=means[keep], allele_freq=freqs[keep], n_obs=n,
        n_markers=len(marker_ids), has_missing=bool(nmiss[keep].sum() > 0),
    )
    if save_path:
        store.save(save_path)
    return store


def _codes(mat, mv):
    """(rows, p) values -> (rows, p) uint8 codes, 3 where missing."""
    miss = (mat == mv) | np.isnan(mat)
    return np.where(miss, 3, np.clip(np.rint(mat), 0, 2)).astype(np.uint8)


def _prepare_packed_low_memory(file, *, separator, header, missing_value, MAF,
                               save_path, chunk_rows,
                               disk_guard_ratio) -> Packed2BitStore:
    """Two-pass out-of-core conversion; see prepare_packed_genotypes."""
    if not isinstance(file, str):
        raise TypeError("low_memory=True requires a genotype file path")
    if not save_path:
        raise ValueError("low_memory=True requires save_path")
    chunk_rows = max(4, (int(chunk_rows) // 4) * 4)  # 4-row-aligned chunks
    mv = np.float32(missing_value)

    # pass 1: IDs and per-marker statistics
    marker_ids, chunks = _genotype_chunks(file, separator, header, chunk_rows)
    p = len(marker_ids)
    sums = np.zeros(p, dtype=np.float64)
    nmiss = np.zeros(p, dtype=np.int64)
    obs_ids: List[str] = []
    for ids, mat in chunks:
        obs_ids.extend(ids)
        miss = (mat == mv) | np.isnan(mat)
        sums += np.where(miss, 0.0, mat).sum(axis=0, dtype=np.float64)
        nmiss += miss.sum(axis=0)
    obs_ids = [str(x).strip() for x in parse_column(obs_ids).tolist()]
    n = len(obs_ids)
    means = sums / np.maximum(n - nmiss, 1)
    freqs = means / 2.0
    keep = np.ones(p, dtype=bool)
    if MAF > 0:
        keep = (freqs > MAF) & (freqs < 1 - MAF) & (freqs * (1.0 - freqs) > 0)
    kept = np.flatnonzero(keep)
    p_keep = int(kept.size)

    # disk guard (streaming_genotypes.jl:167-202)
    bpm = (n + 3) // 4
    need = p_keep * bpm
    st = os.statvfs(os.path.dirname(os.path.abspath(save_path)) or ".")
    free = st.f_bavail * st.f_frsize
    if need > disk_guard_ratio * free:
        raise RuntimeError(
            f"packed store needs {need/1e9:.2f} GB but only {free/1e9:.2f} GB "
            f"free (disk_guard_ratio={disk_guard_ratio}); free space or lower MAF"
        )

    # pass 2: each 4-row-aligned chunk into its byte columns of the file
    tmp = save_path + ".j2b.tmp"
    mm = np.memmap(tmp, dtype=np.uint8, mode="w+", shape=(p_keep, bpm))
    _, chunks = _genotype_chunks(file, separator, header, chunk_rows)
    row0 = 0
    for _, mat in chunks:
        tile = pack_codes(_codes(mat[:, kept], mv))
        mm[:, row0 // 4:row0 // 4 + tile.shape[1]] = tile
        row0 += mat.shape[0]
    mm.flush()
    del mm

    store = Packed2BitStore(
        obs_ids=obs_ids, marker_ids=[marker_ids[int(j)] for j in kept],
        packed=None, means=means[keep], allele_freq=freqs[keep], n_obs=n,
        n_markers=p_keep, has_missing=bool(nmiss[keep].sum() > 0))
    store._publish(save_path)
    store.packed = np.memmap(save_path + ".j2b", dtype=np.uint8, mode="r",
                             shape=(p_keep, bpm))
    return store


def _missing_lut() -> np.ndarray:
    v = np.arange(256, dtype=np.uint16)
    lut = np.zeros(256, dtype=bool)
    for j in range(4):
        lut |= ((v >> (2 * j)) & 3) == 3
    return lut


_MISS_LUT = _missing_lut()


def store_has_missing(packed) -> bool:
    """Does any byte of the store hold code 3? One LUT pass in 64 MiB
    steps, so a memmapped store is never read whole into memory; a tensor
    is scanned where it lives."""
    step = 1 << 26
    if not isinstance(packed, np.ndarray):
        import torch
        flat = packed.reshape(-1)
        lut = torch.from_numpy(_MISS_LUT).to(flat.device)
        return any(bool(lut[flat[i:i + step].long()].any())
                   for i in range(0, flat.numel(), step))
    flat = np.asarray(packed).reshape(-1)
    return any(_MISS_LUT[flat[i:i + step]].any()
               for i in range(0, flat.size, step))
