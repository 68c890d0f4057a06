"""ctypes loader for the native C++ host-ingest library.

The reference keeps its hot host loops in C++ (src/pairsnp.hpp loader,
src/kseq.h).  Here the equivalents — gzip FASTA parsing + bit-plane packing
and pileup text parsing — live in src/tracs_native.cpp, compiled with g++ on
first use to src/libtracs_native-<source hash>.so (never committed: it is
built for the host CPU) and called through ctypes.  Every entry point has a
numpy fallback so the framework works unbuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB: "ctypes.CDLL | None | bool" = None  # None = not tried, False = unavailable

_SRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "src")
_SRC_PATH = os.path.join(_SRC_DIR, "tracs_native.cpp")
_BUILD_FLAGS = [
    "-O3", "-march=native", "-shared", "-fPIC", "-fopenmp", "-std=c++17",
]

#: (path, built in this process) of the library get_lib() loaded, if any
LOADED: tuple[str, bool] | None = None


def lib_path() -> str | None:
    """Where the library built from the current source lives: the file name
    carries a hash of the source and the build flags, so an edited source
    (or a checkout that set arbitrary mtimes) never loads a stale build.
    None when the source is missing."""
    try:
        with open(_SRC_PATH, "rb") as fh:
            src = fh.read()
    except OSError:
        return None
    digest = hashlib.sha256(src + " ".join(_BUILD_FLAGS).encode()).hexdigest()
    return os.path.join(_SRC_DIR, f"libtracs_native-{digest[:16]}.so")


def _build(path: str) -> bool:
    """Compile the source into ``path``.  The compiler writes a private
    temporary file that is renamed into place, so concurrent builders (test
    workers, processes of one launch) never load a half-written library:
    the last rename wins and every rename publishes a complete file."""
    fd, tmp = tempfile.mkstemp(dir=_SRC_DIR, prefix=".libtracs_native-", suffix=".so")
    os.close(fd)
    cmd = ["g++", *_BUILD_FLAGS, _SRC_PATH, "-o", tmp, "-lz"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            logging.debug("native build failed: %s", r.stderr[-2000:])
            return False
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError) as e:  # toolchain missing
        logging.debug("native build failed: %s", e)
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib():
    """Return the loaded CDLL, building it on first use; None if unavailable."""
    global _LIB, LOADED
    with _LOCK:
        if _LIB is False:
            return None
        if _LIB is not None:
            return _LIB
        path = lib_path()
        built = False
        if path is not None and not os.path.exists(path):
            built = _build(path)
        try:
            lib = ctypes.CDLL(path) if path is not None else None
        except OSError:
            lib = None
        if lib is None:
            _LIB = False
            return None
        _configure(lib)
        _LIB = lib
        LOADED = (path, built)
        return lib


def _configure(lib) -> None:
    u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
    u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")

    lib.tn_fasta_scan.restype = ctypes.c_int64
    lib.tn_fasta_scan.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64)]

    lib.tn_fasta_pack.restype = ctypes.c_int64
    lib.tn_fasta_pack.argtypes = [
        ctypes.c_char_p, u32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64,
    ]

    lib.tn_parse_pileup.restype = ctypes.c_int64
    lib.tn_parse_pileup.argtypes = [
        ctypes.c_char_p, f32p, ctypes.c_int64, i64p, ctypes.c_int64,
        u8p, ctypes.c_int64, ctypes.c_int,
    ]

    u64p = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")
    lib.tn_sketch_file.restype = ctypes.c_int64
    lib.tn_sketch_file.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, u64p, ctypes.c_int64,
    ]

    lib.tn_repr_double.restype = ctypes.c_int64
    lib.tn_repr_double.argtypes = [ctypes.c_double, ctypes.c_char_p]

    lib.tn_dist_csv_scan.restype = ctypes.c_int64
    lib.tn_dist_csv_scan.argtypes = [ctypes.c_char_p]

    lib.tn_read_dist_csv.restype = ctypes.c_int64
    lib.tn_read_dist_csv.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_double,
        i64p, i64p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64, i64p,
    ]

    f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
    lib.tn_format_dist_rows.restype = ctypes.c_int64
    lib.tn_format_dist_rows.argtypes = [
        ctypes.c_char_p, i64p,                       # names blob + offsets
        i64p, i64p, ctypes.c_int64,                  # rows, cols, n
        ctypes.c_void_p, i64p,                       # datediff|NULL, dvals
        ctypes.c_void_p, ctypes.c_void_p,            # p0|NULL, eK|NULL
        ctypes.c_void_p,                             # filt|NULL
        i64p, ctypes.c_char_p, ctypes.c_int64,       # nn, ref, ref_len
        ctypes.c_char_p, ctypes.c_int64,             # out, cap
    ]
    i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
    lib.tn_window_stats.restype = None
    lib.tn_window_stats.argtypes = [
        i64p, ctypes.c_int64,          # pos, n_snps
        i64p, ctypes.c_int64,          # seg_bounds, n_pairs
        i64p, i32p, i64p,              # w, count out, span out
    ]

    lib.tn_filter_windows.restype = None
    lib.tn_filter_windows.argtypes = [
        i64p, ctypes.c_int64,          # pos, n_snps
        i64p, ctypes.c_int64,          # seg_bounds, n_pairs
        i64p,                          # w
        u8p, i64p, i64p,               # tables, tab_off, tab_width
        ctypes.c_int64,                # cap
        i64p, u8p,                     # kept out, ovf_mark out
    ]

    lib.tn_split_stats.restype = None
    lib.tn_split_stats.argtypes = [
        u32p, ctypes.c_int64, ctypes.c_int64,        # planes, n, W
        u32p, u32p, i64p,                            # excl, nmask, cnt_n
        u32p, u32p, u32p, u32p,                      # ge2, b0, b1, partial_or
    ]

    lib._f64p = f64p  # stash for callers needing pointer casts


def native_pack_fasta(path):
    """Parse + bit-pack an aligned FASTA via the native library.

    Returns a PackedAlignment or None when the native path is unavailable
    (caller falls back to the numpy packer).
    """
    from tracs_tpu.ops.packing import PackedAlignment

    lib = get_lib()
    if lib is None:
        return None
    path_b = os.fspath(path).encode()
    seq_len = ctypes.c_int64(0)
    n = lib.tn_fasta_scan(path_b, ctypes.byref(seq_len))
    if n == -2:
        raise ValueError("Error reading FASTA, variable sequence lengths!")
    if n < 0:
        raise ValueError(f"Error reading FASTA {os.fspath(path)!r}")
    if n == 0:
        raise ValueError(f"No sequences found in {path!r}")
    L = seq_len.value
    W = (L + 31) // 32
    planes = np.zeros((n, 4, W), dtype=np.uint32)
    name_cap = 4096
    names_buf = ctypes.create_string_buffer(n * name_cap)
    rc = lib.tn_fasta_pack(path_b, planes, n, L, names_buf, name_cap)
    if rc < 0:
        raise ValueError(f"Error packing FASTA {path!r} (code {rc})")
    names = [
        names_buf.raw[i * name_cap : (i + 1) * name_cap].split(b"\x00", 1)[0].decode()
        for i in range(n)
    ]
    return PackedAlignment(planes=planes, length=L, names=names)


def _names_blob(names):
    """Concatenated UTF-8 names + int64 offsets for tn_format_dist_rows."""
    offs = np.zeros(len(names) + 1, dtype=np.int64)
    parts = []
    pos = 0
    for i, nm in enumerate(names):
        b = nm.encode()
        parts.append(b)
        pos += len(b)
        offs[i + 1] = pos
    return b"".join(parts), offs


def native_format_rows(names, rows, cols, dvals, nn, ref,
                       datediff=None, p0=None, eK=None, filt=None,
                       *, _blob_cache=None):
    """Format distance-CSV rows with the native writer; None if unavailable.

    Column order/content matches the reference CSV schema
    (reference tracs/distance.py:156-158, 222-258): NA for absent
    metadata/filter columns, Python float repr for the numeric text.
    ``_blob_cache``: optional dict to reuse the names blob across row
    blocks of a streaming run.
    """
    lib = get_lib()
    if lib is None or len(rows) == 0:
        return None

    if _blob_cache is not None and "blob" in _blob_cache:
        blob, offs = _blob_cache["blob"]
    else:
        blob, offs = _names_blob(names)
        if _blob_cache is not None:
            _blob_cache["blob"] = (blob, offs)

    n = len(rows)
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    dvals = np.ascontiguousarray(dvals, dtype=np.int64)
    nn = np.ascontiguousarray(nn, dtype=np.int64)

    def f64_or_null(x):
        if x is None:
            return None, None
        arr = np.ascontiguousarray(x, dtype=np.float64)
        return arr, arr.ctypes.data_as(ctypes.c_void_p)

    def i64_or_null(x):
        if x is None:
            return None, None
        arr = np.ascontiguousarray(x, dtype=np.int64)
        return arr, arr.ctypes.data_as(ctypes.c_void_p)

    dd_arr, dd_p = f64_or_null(datediff)
    p0_arr, p0_p = f64_or_null(p0)
    eK_arr, eK_p = f64_or_null(eK)
    ft_arr, ft_p = i64_or_null(filt)

    name_lens = offs[1:] - offs[:-1]
    ref_b = ref.encode()
    cap = int(
        name_lens[rows].sum() + name_lens[cols].sum()
        + n * (3 * 32 + 3 * 21 + 16 + len(ref_b))
    )
    out = ctypes.create_string_buffer(cap)
    wrote = lib.tn_format_dist_rows(
        blob, offs, rows, cols, n,
        dd_p, dvals, p0_p, eK_p, ft_p,
        nn, ref_b, len(ref_b), out, cap,
    )
    if wrote < 0:
        return None
    # string_at copies exactly `wrote` bytes (`.raw` would copy the whole cap)
    return ctypes.string_at(out, wrote).decode()


def native_read_dist_csv(path, col_index, threshold):
    """Parse a distance CSV for the cluster stage via the native reader.

    Returns (I, J, names, n_rows) — edge endpoint ids (first-appearance
    order), the id-ordered sample names, and the data row count — or None
    when the native path is unavailable.  Raises ValueError on a
    non-numeric metric field (reference float() parity) or a short row.
    """
    lib = get_lib()
    if lib is None:
        return None
    path_b = os.fspath(path).encode()
    n_rows = lib.tn_dist_csv_scan(path_b)
    if n_rows < 0:
        return None
    I = np.zeros(max(n_rows, 1), dtype=np.int64)
    J = np.zeros(max(n_rows, 1), dtype=np.int64)
    n_out = np.zeros(4, dtype=np.int64)
    names_cap = 1 << 22
    while True:
        blob = ctypes.create_string_buffer(names_cap)
        rc = lib.tn_read_dist_csv(
            path_b, col_index, float(threshold), I, J, max(n_rows, 1),
            blob, names_cap, n_out,
        )
        if rc == -2 and names_cap < (1 << 30):
            names_cap *= 8
            continue
        break
    if rc == -4:
        raise ValueError(f"could not convert distance column {col_index} to float")
    if rc == -3:
        raise ValueError("malformed distance CSV row (too few columns)")
    if rc != 0:
        return None
    n_edges, n_names, n_rows, blob_len = (int(x) for x in n_out)
    names = (
        ctypes.string_at(blob, blob_len).decode().split("\x00")[:-1]
        if blob_len
        else []
    )
    return I[:n_edges], J[:n_edges], names, n_rows


def native_split_stats(planes):
    """Single-pass split-layout statistics over [n, 4, W] packed planes.

    Returns ``(excl, nmask, cnt_n, ge2, b0, b1, partial_or)`` — the
    N-exclusive planes, N mask, per-sample N counts, the >=2-bit
    (exception) mask, the two 2-bit-code planes for the compact device
    upload, and the OR-over-samples partial-site mask — or None when the
    native library is unavailable (caller falls back to the numpy build).
    Replaces ~10 broadcasted numpy passes with one streaming read of the
    planes (measured 105 s -> seconds at 10k x 1 Mb)."""
    lib = get_lib()
    if lib is None:
        return None
    planes = np.ascontiguousarray(planes, dtype=np.uint32)
    n, _, W = planes.shape
    excl = np.empty((n, 4, W), dtype=np.uint32)
    nmask = np.empty((n, W), dtype=np.uint32)
    cnt_n = np.empty(n, dtype=np.int64)
    ge2 = np.empty((n, W), dtype=np.uint32)
    b0 = np.empty((n, W), dtype=np.uint32)
    b1 = np.empty((n, W), dtype=np.uint32)
    partial_or = np.empty(W, dtype=np.uint32)
    lib.tn_split_stats(
        planes.reshape(-1), n, W,
        excl.reshape(-1), nmask.reshape(-1), cnt_n,
        ge2.reshape(-1), b0.reshape(-1), b1.reshape(-1), partial_or,
    )
    return excl, nmask, cnt_n, ge2, b0, b1, partial_or


def native_window_stats(pos, seg_bounds, w):
    """Per-SNP windowed (count, span) for the recombination filter: a
    two-pointer sweep per pair segment (O(n_snps) total vs the numpy
    fallback's global binary searches).  Returns (int32 count, int64 span)
    arrays, or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    seg_bounds = np.ascontiguousarray(seg_bounds, dtype=np.int64)
    w = np.ascontiguousarray(w, dtype=np.int64)
    n_pairs = len(seg_bounds) - 1
    count = np.empty(len(pos), dtype=np.int32)
    span = np.empty(len(pos), dtype=np.int64)
    lib.tn_window_stats(pos, len(pos), seg_bounds, n_pairs, w, count, span)
    return count, span


def native_filter_windows(pos, seg_bounds, w, tables, tab_off, tab_width, cap):
    """Full recombination-filter window pass: two-pointer (count, span) per
    SNP with the keep decision resolved inline from per-pair boolean tables
    and kept counts accumulated per pair.  Returns (int64 kept[n_pairs],
    uint8 ovf_mark[n_snps]) where marked SNPs had window counts above
    ``cap`` (provisionally counted kept — the caller resolves them); None
    when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    seg_bounds = np.ascontiguousarray(seg_bounds, dtype=np.int64)
    w = np.ascontiguousarray(w, dtype=np.int64)
    tables = np.ascontiguousarray(tables, dtype=np.uint8)
    tab_off = np.ascontiguousarray(tab_off, dtype=np.int64)
    tab_width = np.ascontiguousarray(tab_width, dtype=np.int64)
    n_pairs = len(seg_bounds) - 1
    kept = np.empty(n_pairs, dtype=np.int64)
    ovf = np.zeros(len(pos), dtype=np.uint8)
    lib.tn_filter_windows(
        pos, len(pos), seg_bounds, n_pairs, w,
        tables, tab_off, tab_width, int(cap), kept, ovf,
    )
    return kept, ovf
