"""Native host-runtime components (C++ via ctypes, pure-Python fallback).

The reference's native layer lives entirely inside pip deps (SURVEY.md §2b:
sentencepiece C++ for tokenization; CPython's difflib for the fuzzy eval
credit). Here the equivalents are first-party C++:

  * ``viterbi.cpp`` — unigram-LM Viterbi encoder (the sentencepiece role),
    bit-identical to text/spm.viterbi_encode;
  * ``fuzzy.cpp``   — difflib.SequenceMatcher ratio + closest-answer scan
    (the eval hot path: O(N·len²) per prediction in the reference).

The shared library is built on demand with g++ from the sources beside
this file into the package's ``_build/`` directory; loading is lazy and every
caller has a pure-Python fallback, so the package works without a toolchain.
A copy of the JAX package's ``native/`` (same sources, same entry points):
the two packages share no module.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Sequence

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libmprnative.so")
_lock = threading.Lock()
_lib = None
_tried = False


def build_library(force: bool = False) -> Optional[str]:
    """Compile the shared library if needed; returns its path or None."""
    srcs = [os.path.join(_DIR, s)
            for s in ("fuzzy.cpp", "viterbi.cpp", "clip_bpe.cpp")]
    if not force and os.path.exists(_LIB_PATH) and all(
            os.path.getmtime(_LIB_PATH) >= os.path.getmtime(s)
            for s in srcs):
        return _LIB_PATH
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
             *srcs, "-o", tmp],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)  # atomic under concurrent builds
        return _LIB_PATH
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        return None


def get_library():
    """Load (building if necessary); None when unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build_library()
        if path is None:
            return None
        for attempt in range(2):
            if _try_load(path) or attempt:
                break
            # a stale .so (e.g. restored with equal mtimes by a checkout)
            # can predate newer entry points: force one rebuild and retry
            path = build_library(force=True)
            if path is None:
                break
        return _lib


def _try_load(path) -> bool:
    """Load ``path`` and bind every entry point; on any failure (missing
    symbol from a stale build, bad binary) leave ``_lib`` None and report
    False so get_library can rebuild."""
    global _lib
    try:
        lib = ctypes.CDLL(path)
        lib.mpr_ratio.restype = ctypes.c_double
        lib.mpr_ratio.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.mpr_closest_index.restype = ctypes.c_int32
        lib.mpr_closest_index.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int32]
        lib.mpr_spm_create.restype = ctypes.c_void_p
        lib.mpr_spm_create.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.c_float]
        lib.mpr_spm_free.restype = None
        lib.mpr_spm_free.argtypes = [ctypes.c_void_p]
        lib.mpr_spm_encode.restype = ctypes.c_int32
        lib.mpr_spm_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.mpr_spm_encode_batch.restype = None
        lib.mpr_spm_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.mpr_spm_encode_span.restype = ctypes.c_int32
        lib.mpr_spm_encode_span.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.mpr_bpe_create.restype = ctypes.c_void_p
        lib.mpr_bpe_create.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.mpr_bpe_free.restype = None
        lib.mpr_bpe_free.argtypes = [ctypes.c_void_p]
        lib.mpr_bpe_encode.restype = ctypes.c_int32
        lib.mpr_bpe_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.mpr_bpe_encode_batch.restype = None
        lib.mpr_bpe_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        _lib = lib
    except Exception:
        _lib = None
    return _lib is not None


# ---------------------------------------------------------------------------
# Fuzzy matching
# ---------------------------------------------------------------------------


def ratio(a: str, b: str) -> float:
    """difflib.SequenceMatcher(None, a, b).ratio() — native when available."""
    lib = get_library()
    if lib is not None:
        return lib.mpr_ratio(a.encode(), b.encode())
    from difflib import SequenceMatcher

    return SequenceMatcher(None, a, b).ratio()


def closest_index(query: str, candidates: Sequence[str]) -> int:
    """First index attaining the max ratio(candidates[i], query) — the
    reference's fuzzy-label scan (dataset/VQAFeatureDataset.py:55-58)."""
    lib = get_library()
    if lib is not None:
        arr = (ctypes.c_char_p * len(candidates))(
            *[c.encode() for c in candidates])
        return int(lib.mpr_closest_index(query.encode(), arr,
                                         len(candidates)))
    from difflib import SequenceMatcher

    best, best_i = -1.0, 0
    for i, c in enumerate(candidates):
        r = SequenceMatcher(None, c, query).ratio()
        if r > best:
            best, best_i = r, i
    return best_i


# ---------------------------------------------------------------------------
# Native Viterbi encoder
# ---------------------------------------------------------------------------


class NativeViterbi:
    """Handle to the C++ unigram encoder for a given vocab; falls back to
    None construction when the library is unavailable."""

    def __init__(self, pieces: Sequence[tuple], unk_penalty: float = 10.0):
        lib = get_library()
        self._lib = lib
        self._handle = None
        if lib is None:
            return
        blobs = [p.encode() for p, _, _ in pieces]
        concat = b"".join(blobs)
        offsets = [0]
        for b in blobs:
            offsets.append(offsets[-1] + len(b))
        n = len(pieces)
        off_arr = (ctypes.c_int32 * (n + 1))(*offsets)
        score_arr = (ctypes.c_float * n)(*[s for _, s, _ in pieces])
        type_arr = (ctypes.c_int32 * n)(*[t for _, _, t in pieces])
        self._handle = lib.mpr_spm_create(concat, off_arr, score_arr,
                                          type_arr, n,
                                          ctypes.c_float(unk_penalty))
        self._out = (ctypes.c_int32 * 4096)()

    @property
    def available(self) -> bool:
        return self._handle is not None

    def encode(self, normalized: str) -> List[int]:
        data = normalized.encode()
        # every piece covers >= 1 byte, so len(data)+1 ids always fit —
        # a fixed 4096 cap would silently truncate long chunks and break
        # bit-identity with the pure-Python Viterbi
        if len(data) < 4096:
            out = self._out
        else:
            out = (ctypes.c_int32 * (len(data) + 1))()
        # span entry (explicit length): embedded NUL bytes must tokenize
        # like the pure-Python Viterbi, not truncate at the NUL —
        # encode() and encode_batch() stay bit-identical for any input
        cnt = self._lib.mpr_spm_encode_span(self._handle, data, len(data),
                                            out, len(out))
        return list(out[:cnt])

    def encode_batch(self, normalized: Sequence[str]):
        """Encode N pre-normalized strings in ONE native call.

        Returns ``(ids, lens)`` — ids row-major int32 (N, cap) numpy,
        ``lens[i]`` valid ids in row i. Rows are bit-identical to
        :meth:`encode`. The batch entry exists because the serving host
        path tokenizes a full chunk (512 prompts) at once and the
        per-call ctypes + list-building overhead dominates there."""
        import numpy as np

        blobs = [t.encode() for t in normalized]
        n = len(blobs)
        offsets = np.zeros(n + 1, np.int32)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        cap = int(max((len(b) for b in blobs), default=0)) + 1
        ids = np.empty((n, cap), np.int32)
        lens = np.empty(n, np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        self._lib.mpr_spm_encode_batch(
            self._handle, b"".join(blobs),
            offsets.ctypes.data_as(i32p), n,
            ids.ctypes.data_as(i32p), lens.ctypes.data_as(i32p), cap)
        return ids, lens

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib is not None:
            self._lib.mpr_spm_free(self._handle)
            self._handle = None


# ---------------------------------------------------------------------------
# Native CLIP BPE encoder
# ---------------------------------------------------------------------------


class NativeBPE:
    """Handle to the C++ CLIP-BPE fast path (native/clip_bpe.cpp).

    ``encode`` returns None when the input needs the exact Python path
    (non-ASCII, '&', special-token literals) — callers must fall back to
    text/clip_bpe.CLIPBPETokenizer.encode, never approximate."""

    def __init__(self, vocab: Sequence[str], merges: Sequence[tuple]):
        lib = get_library()
        self._lib = lib
        self._handle = None
        if lib is None:
            return
        vb = [v.encode() for v in vocab]
        voff = [0]
        for b in vb:
            voff.append(voff[-1] + len(b))
        mb = [(a + "\x01" + b).encode() for a, b in merges]
        moff = [0]
        for b in mb:
            moff.append(moff[-1] + len(b))
        self._handle = lib.mpr_bpe_create(
            b"".join(vb), (ctypes.c_int32 * len(voff))(*voff), len(vb),
            b"".join(mb), (ctypes.c_int32 * len(moff))(*moff), len(mb))
        self._out = (ctypes.c_int32 * 1024)()

    @property
    def available(self) -> bool:
        return self._handle is not None

    def encode(self, text: str) -> Optional[List[int]]:
        try:
            raw = text.encode()
        except UnicodeEncodeError:
            return None
        cnt = self._lib.mpr_bpe_encode(self._handle, raw, self._out, 1024)
        if cnt < 0:
            return None
        return list(self._out[:cnt])

    def encode_batch(self, texts: Sequence[str], cap: int = 256):
        """Encode N strings in ONE native call -> (ids (N, cap) int32,
        lens); ``lens[i] == -1`` marks a row needing the exact Python
        fallback (non-ASCII, '&', special literals, vocab miss — the
        caller re-encodes just those rows)."""
        import numpy as np

        blobs = []
        for t in texts:
            try:
                blobs.append(t.encode())
            except UnicodeEncodeError:  # lone surrogates: Python path
                blobs.append(b"&")  # forces a -1 fallback for this row
        n = len(blobs)
        offsets = np.zeros(n + 1, np.int32)
        np.cumsum([len(b) for b in blobs], out=offsets[1:])
        ids = np.empty((n, cap), np.int32)
        lens = np.empty(n, np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        self._lib.mpr_bpe_encode_batch(
            self._handle, b"".join(blobs),
            offsets.ctypes.data_as(i32p), n,
            ids.ctypes.data_as(i32p), lens.ctypes.data_as(i32p), cap)
        return ids, lens

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib is not None:
            self._lib.mpr_bpe_free(self._handle)
            self._handle = None
