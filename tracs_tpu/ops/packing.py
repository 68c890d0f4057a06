"""IUPAC codec: FASTA sequences <-> 4-plane bit-packed allele tensors.

Canonical device layout: ``planes`` is a ``[n_samples, 4, W] uint32`` tensor,
where plane ``p`` in (A=0, C=1, G=2, T=3) holds one bit per genome position
(site ``s`` lives in word ``s // 32``, bit ``s % 32``).  IUPAC ambiguity codes
set multiple planes; ``N`` (and any unrecognised character, including ``X``
and ``-``) sets all four — matching the reference loader semantics
(reference src/pairsnp.hpp:107-198: switch with ``default:`` -> all four).

This dense-bit layout replaces the reference's per-sequence
``boost::dynamic_bitset`` quadruple: 0.5 bytes/site in device memory, `uint32`
words for the popcount path, and cheap on-device expansion into the int8
channels of the GEMM paths (see ops/pairsnp.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np

from tracs_tpu.io.fasta import read_fasta

# bit order: bit0=A, bit1=C, bit2=G, bit3=T  (chosen to match the reference
# align-stage little-endian np.packbits convention, tracs/align.py:285-323,
# so nibble values index the same 16-entry IUPAC table)
_A, _C, _G, _T = 1, 2, 4, 8

_CHAR_TO_NIBBLE = {
    "A": _A,
    "C": _C,
    "G": _G,
    "T": _T,
    "M": _A | _C,
    "R": _A | _G,
    "W": _A | _T,
    "S": _C | _G,
    "Y": _C | _T,
    "K": _G | _T,
    "V": _A | _C | _G,
    "H": _A | _C | _T,
    "D": _A | _G | _T,
    "B": _C | _G | _T,
    "N": _A | _C | _G | _T,
}

# nibble -> IUPAC character, with 0 -> 'X' (align-stage output convention,
# tracs/align.py:306-323).  Note the *input* codec maps X back to N, exactly
# like the reference C++ loader does.
IUPAC_BY_NIBBLE = np.frombuffer(b"XACMGRSVTWYHKDBN", dtype="S1")

NIBBLE_LUT = np.full(256, 15, dtype=np.uint8)  # default: N (all four planes)
for ch, nib in _CHAR_TO_NIBBLE.items():
    NIBBLE_LUT[ord(ch)] = nib
    NIBBLE_LUT[ord(ch.lower())] = nib


def iupac_code_for_mask(nibble: int) -> str:
    """IUPAC character for a 4-bit allele-presence mask (bit0=A..bit3=T)."""
    return IUPAC_BY_NIBBLE[nibble].decode()


@dataclasses.dataclass
class PackedAlignment:
    """Bit-packed multiple sequence alignment.

    planes : np.uint32 [n, 4, W]  allele-presence bit-planes (W = ceil(L/32),
             padded tail bits are zero — i.e. "no allele", which every kernel
             must treat as not-a-site)
    length : true genome length L in sites
    names  : per-sequence record names
    """

    planes: np.ndarray
    length: int
    names: list

    @property
    def n_seqs(self) -> int:
        return self.planes.shape[0]

    @property
    def n_words(self) -> int:
        return self.planes.shape[2]

    def nibbles(self) -> np.ndarray:
        """Expand to per-site 4-bit masks, shape [n, L] uint8."""
        return unpack_planes_to_nibbles(self.planes, self.length)

    def counts_n(self) -> np.ndarray:
        """Per-sequence count of fully-ambiguous (N) sites, shape [n] int64.
        Used in the comparable-sites formula (reference pairsnp.hpp:417-419)."""
        n_mask = (
            self.planes[:, 0] & self.planes[:, 1] & self.planes[:, 2] & self.planes[:, 3]
        )
        return popcount_words(n_mask).sum(axis=-1)


def seqs_to_nibbles(seqs: Sequence[str | bytes]) -> np.ndarray:
    """Vectorised chars -> 4-bit masks.  All sequences must share a length
    (reference load_seqs raises on variable lengths, pairsnp.hpp:94-98)."""
    if len(seqs) == 0:
        return np.zeros((0, 0), dtype=np.uint8)
    first_len = len(seqs[0])
    for s in seqs:
        if len(s) != first_len:
            raise ValueError("Error reading FASTA, variable sequence lengths!")
    buf = np.empty((len(seqs), first_len), dtype=np.uint8)
    for i, s in enumerate(seqs):
        if isinstance(s, str):
            s = s.encode("ascii")
        buf[i] = np.frombuffer(s, dtype=np.uint8)
    return NIBBLE_LUT[buf]


def nibbles_to_planes(nibbles: np.ndarray) -> np.ndarray:
    """[n, L] uint8 masks -> [n, 4, W] uint32 bit-planes (little bit order)."""
    n, L = nibbles.shape
    W = (L + 31) // 32
    pad = W * 32 - L
    if pad:
        nibbles = np.pad(nibbles, ((0, 0), (0, pad)))
    planes = np.empty((n, 4, W), dtype=np.uint32)
    for p in range(4):
        bits = (nibbles >> p) & 1  # [n, 32W] uint8
        packed = np.packbits(bits, axis=-1, bitorder="little")  # [n, 4W] uint8
        b = packed.reshape(n, W, 4).astype(np.uint32)
        planes[:, p] = b[:, :, 0] | (b[:, :, 1] << 8) | (b[:, :, 2] << 16) | (b[:, :, 3] << 24)
    return planes


def unpack_planes_to_nibbles(planes: np.ndarray, length: int) -> np.ndarray:
    """[n, 4, W] uint32 -> [n, L] uint8 4-bit masks."""
    n, _, W = planes.shape
    shifts = np.arange(32, dtype=np.uint32)
    out = np.zeros((n, W * 32), dtype=np.uint8)
    for p in range(4):
        bits = ((planes[:, p, :, None] >> shifts[None, None, :]) & 1).astype(np.uint8)
        out |= bits.reshape(n, W * 32) << p
    return out[:, :length]


def popcount_words(words: np.ndarray) -> np.ndarray:
    """Vectorised popcount of uint32 words (numpy host path)."""
    v = words.astype(np.uint32).copy()
    v = v - ((v >> 1) & np.uint32(0x55555555))
    v = (v & np.uint32(0x33333333)) + ((v >> 2) & np.uint32(0x33333333))
    v = (v + (v >> 4)) & np.uint32(0x0F0F0F0F)
    return ((v * np.uint32(0x01010101)) >> 24).astype(np.int64)


def pack_sequences(seqs: Sequence[str | bytes], names: Sequence[str] | None = None) -> PackedAlignment:
    nib = seqs_to_nibbles(seqs)
    planes = nibbles_to_planes(nib)
    if names is None:
        names = [f"seq{i}" for i in range(len(seqs))]
    return PackedAlignment(planes=planes, length=nib.shape[1], names=list(names))


#: bump to invalidate on-disk pack caches when the plane layout changes
PACKER_VERSION = 1

#: only cache inputs at least this large (small files re-pack in ms)
_PACK_CACHE_MIN_BYTES = 64 << 20


def _pack_cache_dir() -> str | None:
    """Cache directory for packed planes, or None when disabled.
    ``TRACS_TPU_PACK_CACHE`` overrides the default (set to ``0`` to turn
    the cache off)."""
    cfg = os.environ.get("TRACS_TPU_PACK_CACHE")
    if cfg == "0":
        return None
    return cfg or os.path.expanduser("~/.cache/tracs_tpu/packed")


def _pack_cache_key(path: str) -> str:
    """Content key for a FASTA: packer version + size + mtime + a digest
    of 16 stripes sampled ACROSS the file (plus head and tail).  A FULL
    content hash would read the whole file — as slow as re-packing it,
    which is what the cache exists to avoid — so the key trades that for
    size+mtime+strided samples: a middle-of-file edit that somehow
    preserves size and mtime (tar -x, rsync -a, touch -r pipelines) still
    re-keys unless it dodges every 256 KB stripe."""
    import hashlib

    st = os.stat(path)
    h = hashlib.sha256()
    h.update(f"pack{PACKER_VERSION}:{st.st_size}:{st.st_mtime_ns}".encode())
    stripe = 256 << 10
    with open(path, "rb") as fh:
        h.update(fh.read(stripe))
        if st.st_size > 2 * stripe:
            for k in range(1, 16):
                fh.seek(max(0, st.st_size * k // 16 - stripe // 2))
                h.update(fh.read(stripe))
            fh.seek(-stripe, 2)
            h.update(fh.read(stripe))
    return h.hexdigest()[:32]


def _pack_cache_load(entry: str) -> PackedAlignment | None:
    import json

    meta_p = os.path.join(entry, "meta.json")
    planes_p = os.path.join(entry, "planes.npy")
    if not (os.path.exists(meta_p) and os.path.exists(planes_p)):
        return None
    with open(meta_p) as fh:
        meta = json.load(fh)
    if meta.get("version") != PACKER_VERSION:
        return None
    # mmap: reruns start sweeping without re-reading 10 GB of FASTA — pages
    # fault in at disk (not parse) speed, and only the rows a mesh shard
    # actually touches
    planes = np.load(planes_p, mmap_mode="r")
    return PackedAlignment(
        planes=planes, length=int(meta["length"]), names=list(meta["names"])
    )


def _pack_cache_store(entry: str, packed: PackedAlignment) -> None:
    import json
    import tempfile

    os.makedirs(os.path.dirname(entry), exist_ok=True)
    tmp = tempfile.mkdtemp(dir=os.path.dirname(entry))
    try:
        np.save(os.path.join(tmp, "planes.npy"), packed.planes)
        with open(os.path.join(tmp, "meta.json"), "w") as fh:
            json.dump(
                {
                    "version": PACKER_VERSION,
                    "length": packed.length,
                    "names": packed.names,
                },
                fh,
            )
        os.rename(tmp, entry)  # atomic publish; loses the race gracefully
    except OSError:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)


def pack_fasta(path: str | os.PathLike, use_cache: bool | None = None) -> PackedAlignment:
    """Load an aligned (equal-length) FASTA/FASTA.gz into bit-planes.

    The native C++ fast path (src/tracs_native.cpp) is used when built;
    falls back to the numpy packer.

    Large inputs are persisted to an mmap-able on-disk plane cache keyed
    by (content key, PACKER_VERSION): a 10 GB FASTA packs once (~6 min at
    cold-disk north-star scale) and every rerun — including ``--resume``
    after an interruption — loads in seconds.  Controlled by
    ``TRACS_TPU_PACK_CACHE`` (dir, or ``0`` to disable)."""
    path = os.fspath(path)
    cache_dir = _pack_cache_dir() if use_cache in (None, True) else None
    entry = key = None
    if cache_dir is not None:
        try:
            big_enough = (
                use_cache or os.stat(path).st_size >= _PACK_CACHE_MIN_BYTES
            )
            if big_enough:
                key = _pack_cache_key(path)
                entry = os.path.join(cache_dir, key)
                cached = _pack_cache_load(entry)
                if cached is not None:
                    return cached
        except OSError:
            entry = None

    from tracs_tpu.runtime.native import native_pack_fasta

    packed = native_pack_fasta(path)
    if packed is None:
        names, seqs = [], []
        for name, seq in read_fasta(path):
            names.append(name)
            seqs.append(seq)
        if not seqs:
            raise ValueError(f"No sequences found in {path!r}")
        packed = pack_sequences(seqs, names)
    if entry is not None:
        try:
            _pack_cache_store(entry, packed)
        except OSError:  # cache is best-effort; never fail the pack
            pass
    return packed


def nibbles_to_string(nibbles: np.ndarray) -> str:
    """[L] uint8 4-bit masks -> IUPAC string (0 -> 'X')."""
    return IUPAC_BY_NIBBLE[nibbles].tobytes().decode("ascii")


@dataclasses.dataclass
class SplitAlignment:
    """Match-decomposed layout for the fast distance kernel (ops/pairsnp.py):

        match(u, v) = sum_x ex_x(u) ex_x(v)            [4 dense channels]
                      - n(u) n(v) + n(u) + n(v)        [1 dense channel + counts]
                      + partial-ambiguity correction   [10 channels, gathered]

    where ``ex`` are the N-exclusive singleton planes (plane & ~N-mask) and
    the correction channels are nonzero only at sites where some sample holds
    a 2- or 3-bit IUPAC code — gathered into a compact [n, 4, Wp] tensor.
    ~5 MACs/site instead of the 15 of the general inclusion-exclusion gram.
    """

    excl: np.ndarray      # [n, 4, W] uint32: singleton planes with N sites cleared
    nmask: np.ndarray     # [n, W]   uint32: N (all-four) mask
    partial: np.ndarray   # [n, 4, Wp] uint32: raw planes gathered at partial sites
    cnt_n: np.ndarray     # [n] int64: per-sample N counts
    length: int
    n_partial: int
    names: list
    partial_pos: np.ndarray | None = None  # [n_partial] int64 gathered positions
    # backref to the PackedAlignment this split was derived from: lets the
    # device path rebuild excl/nmask FROM the (smaller, possibly already
    # uploaded) 4-plane tensor instead of transferring them (ops/pairsnp.py
    # ``_split_device``).  None for hand-built layouts; slices inherit it
    # but are guarded by a row-count check before the derive path is used.
    src: object = None

    @property
    def n_seqs(self) -> int:
        return self.excl.shape[0]


def partial_site_positions(packed: PackedAlignment) -> np.ndarray:
    """Positions (int64) where ANY sample holds a partial (2-/3-bit IUPAC)
    code.  The partial-correction gram of a PAIR of alignments is only
    meaningful when both sides are gathered at the SAME position set — use
    the union of each side's positions (sites partial on one side only
    contribute zero: the |S|>=2 channel products need >=2 bits on BOTH)."""
    p = packed.planes
    a, c, g, t = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    all4 = a & c & g & t
    ge2 = (a & c) | (a & g) | (a & t) | (c & g) | (c & t) | (g & t)
    global_partial = np.bitwise_or.reduce((ge2 & ~all4).astype(np.uint32), axis=0)
    bits = np.unpackbits(global_partial.view(np.uint8), bitorder="little")
    return np.nonzero(bits[: packed.length])[0].astype(np.int64)


def split_alignment(
    packed: PackedAlignment, partial_sites: np.ndarray | None = None
) -> SplitAlignment:
    """Build the SplitAlignment layout (host, once per alignment).

    ``partial_sites`` overrides the gathered partial-site positions — pass
    the union of both alignments' positions when building the two sides of
    a query-vs-db pair, so their correction grams share the gather axis."""
    from tracs_tpu.runtime.native import native_split_stats

    p = packed.planes
    stats = native_split_stats(p)
    if stats is not None:
        # single native streaming pass; also yields the 2-bit upload planes
        # (b0/b1) + exception mask that ops/pairsnp.py::_planes_device uses
        # to halve host->device bytes
        excl, all4, cnt_n, ge2, b0, b1, partial_or = stats
        packed._code2 = (b0, b1, ge2)
        if partial_sites is None:
            bits = np.unpackbits(partial_or.view(np.uint8), bitorder="little")
            partial_sites = np.nonzero(bits[: packed.length])[0].astype(np.int64)
    else:
        a, c, g, t = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
        all4 = a & c & g & t
        excl = (p & ~all4[:, None, :]).astype(np.uint32)
        cnt_n = popcount_words(all4).sum(axis=-1)

    # gather raw planes at partial sites (usually a tiny fraction)
    if partial_sites is None:
        partial_sites = partial_site_positions(packed)
    idx = np.asarray(partial_sites, dtype=np.int64)
    n_partial = len(idx)
    if n_partial:
        word = (idx >> 5).astype(np.int64)
        bit = (idx & 31).astype(np.uint32)
        # gather the EXCLUSIVE planes: an N sample must contribute zero to
        # the partial-ambiguity correction channels (its match is fully
        # accounted for by the n term)
        vals = ((excl[:, :, word] >> bit[None, None, :]) & 1).astype(np.uint8)  # [n,4,P]
        Wp = (n_partial + 31) // 32
        padded = np.zeros((p.shape[0], 4, Wp * 32), dtype=np.uint8)
        padded[:, :, :n_partial] = vals
        packed_bytes = np.packbits(padded, axis=-1, bitorder="little")
        b = packed_bytes.reshape(p.shape[0], 4, Wp, 4).astype(np.uint32)
        partial = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)
    else:
        partial = np.zeros((p.shape[0], 4, 1), dtype=np.uint32)

    return SplitAlignment(
        excl=excl, nmask=all4.astype(np.uint32), partial=partial,
        cnt_n=cnt_n, length=packed.length, n_partial=n_partial,
        names=packed.names, partial_pos=idx, src=packed,
    )


# ---------------------------------------------------------------------------
# variant-site compaction
# ---------------------------------------------------------------------------

def _gather_columns(planes: np.ndarray, positions: np.ndarray) -> np.ndarray:
    """Repack the selected columns of a [n, 4, W] plane tensor into a fresh
    [n, 4, ceil(V/32)] tensor (little bit order), chunked over rows to bound
    the temporary bit matrix."""
    n = planes.shape[0]
    V = int(positions.size)
    word_idx = (positions >> 5).astype(np.int64)
    bit_idx = (positions & 31).astype(np.uint32)
    Wc = (V + 31) // 32
    out_bytes = np.zeros((n, 4, Wc * 4), dtype=np.uint8)
    rows_per_chunk = max(1, (1 << 26) // max(1, 4 * V))
    for s in range(0, n, rows_per_chunk):
        e = min(n, s + rows_per_chunk)
        bits = ((planes[s:e][:, :, word_idx] >> bit_idx) & 1).astype(np.uint8)
        packed = np.packbits(bits, axis=-1, bitorder="little")  # [r, 4, ceil(V/8)]
        out_bytes[s:e, :, : packed.shape[-1]] = packed
    return np.ascontiguousarray(out_bytes).view(np.uint32).reshape(n, 4, Wc)


def compact_variant_columns(
    a: PackedAlignment,
    b: PackedAlignment | None = None,
    *,
    max_ratio: float = 0.75,
):
    """Drop alignment columns that cannot affect any pairwise result.

    A column where every sample (of both alignments, in query-vs-db mode)
    holds the SAME nonzero nibble contributes exactly one match to every
    pair — so the compacted distance matrix is IDENTICAL to the full one
    (D = V - matches_variant = L - matches_total), with no offset at all.
    Comparable-site counts shift by the constant
    ``nn_offset = L - V - n_droppedN`` (each dropped constant-N column
    removes one N from both samples and one from their N-gram).  Mismatch
    positions for the recombination filter map back through ``positions``.

    Real bacterial alignments are overwhelmingly conserved, so this is the
    classic snp-sites reduction: typically 10-100x fewer sites feed the
    O(n^2 * L) kernels.  The scan itself is one O(n * W) pass of bitwise
    and/or reductions.  The reference has no analogue (its kernel always
    walks the full bitsets, src/pairsnp.hpp:395-421); outputs remain
    bit-identical by construction.

    Returns ``(a_c, b_c, positions, nn_offset)`` or ``None`` when fewer
    than ``(1 - max_ratio)`` of the columns would be dropped (not worth the
    repack).  Columns holding a constant ZERO nibble (impossible for
    FASTA-derived alignments — the codec maps unknown chars to N) are kept
    as variant, which is what makes the distance offset provably zero.
    """
    same = b is None or b is a
    planes_list = [a.planes] if same else [a.planes, b.planes]
    L, W = a.length, a.planes.shape[2]
    if a.planes.shape[0] == 0 or (not same and b.planes.shape[0] == 0):
        return None

    and_all = None
    or_all = None
    for pl in planes_list:
        pa = np.bitwise_and.reduce(pl, axis=0)  # [4, W]
        po = np.bitwise_or.reduce(pl, axis=0)
        and_all = pa if and_all is None else (and_all & pa)
        or_all = po if or_all is None else (or_all | po)

    varies = (
        (and_all[0] ^ or_all[0])
        | (and_all[1] ^ or_all[1])
        | (and_all[2] ^ or_all[2])
        | (and_all[3] ^ or_all[3])
    )
    nz = or_all[0] | or_all[1] | or_all[2] | or_all[3]
    in_l = np.full(W, 0xFFFFFFFF, dtype=np.uint32)
    tail = W * 32 - L
    if tail:
        in_l[-1] = np.uint32(0xFFFFFFFF >> tail)
    keep = (varies | ~nz) & in_l

    positions = np.nonzero(
        np.unpackbits(keep.view(np.uint8), bitorder="little")
    )[0].astype(np.int64)
    if positions.size == 0:
        # keep one (constant, nonzero) column so kernels see >= 1 site;
        # it contributes one match to every pair, exactly as it did in full
        positions = np.array([0], dtype=np.int64)
        keep = keep.copy()
        keep[0] |= np.uint32(1)
    V = int(positions.size)
    if V >= max_ratio * L:
        return None

    const_n = and_all[0] & and_all[1] & and_all[2] & and_all[3]
    dropped_n = int(popcount_words(const_n & ~keep & in_l).sum())
    nn_offset = L - V - dropped_n

    a_c = PackedAlignment(_gather_columns(a.planes, positions), V, a.names)
    b_c = a_c if same else PackedAlignment(_gather_columns(b.planes, positions), V, b.names)
    return a_c, b_c, positions, nn_offset
