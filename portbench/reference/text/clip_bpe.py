"""OpenAI CLIP BPE tokenizer (host-side port).

A frozen copy of ``multimodalpromptretrieval_tpu_torch/text/clip_bpe.py``
for the benchmark's reference, with the port's C++ fast path left out:
every row takes the exact Python path.

The reference calls ``clip.tokenize(batch["question"])`` for the retrieval
embeddings (dataset/VQAFeatureDataset.py:147,190). This reproduces CLIP's
SimpleTokenizer: bytes→unicode mapping, lowercasing + whitespace cleanup,
the word regex, BPE merges with the ``</w>`` end-of-word marker, and
``tokenize``'s fixed (B, 77) int32 framing with SOT/EOT and zero padding.

The standard merges file (``bpe_simple_vocab_16e6.txt[.gz]``) is loaded via
``from_merges_file`` at deploy time; ``build_toy`` constructs a small
merge-free vocab for hermetic tests (characters only, same framing).

Note: upstream CLIP additionally runs ``ftfy.fix_text``; ftfy is unicode
mojibake repair and is a no-op on the ASCII medical questions here. We apply
``html.unescape`` twice like upstream's basic_clean.
"""

from __future__ import annotations

import gzip
import html
from functools import lru_cache
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import regex as re

_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
    r"""[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    re.IGNORECASE,
)


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class _NoNative:
    """The port's C++ encoder is not part of this copy."""

    available = False


class CLIPBPETokenizer:
    def __init__(self, vocab: Sequence[str],
                 merges: Sequence[Tuple[str, str]],
                 context_length: int = 77):
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.context_length = context_length
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self._cache: Dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self._native = _NoNative()

    # -- constructors ---------------------------------------------------------

    @staticmethod
    def from_merges_file(path: str, context_length: int = 77
                         ) -> "CLIPBPETokenizer":
        """Standard CLIP vocab: 256 bytes + 256 byte</w> + 48894 merges
        + SOT/EOT = 49408 entries."""
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        # upstream slices exactly (SimpleTokenizer.__init__); additionally
        # drop malformed/blank lines so truncated fixture files load too
        merge_lines = lines[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merge_lines
                  if len(m.split()) == 2]
        base = list(bytes_to_unicode().values())
        vocab = base + [v + "</w>" for v in base]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        return CLIPBPETokenizer(vocab, merges, context_length)

    @staticmethod
    def build_toy(context_length: int = 77) -> "CLIPBPETokenizer":
        """Merge-free byte-level vocab (every word becomes characters +
        char</w>); hermetic stand-in with identical framing semantics."""
        base = list(bytes_to_unicode().values())
        vocab = base + [v + "</w>" for v in base]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        return CLIPBPETokenizer(vocab, [], context_length)

    # -- BPE ------------------------------------------------------------------

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        if self._native.available:
            ids = self._native.encode(text)
            if ids is not None:
                return ids
        return self._encode_py(text)

    def _encode_py(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for tok in re.findall(_PAT, text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[p] for p in self._bpe(tok).split(" "))
        return ids

    def tokenize(self, texts: Sequence[str] | str,
                 truncate: bool = True) -> np.ndarray:
        """clip.tokenize parity: (B, context_length) int32, SOT ... EOT 0 0.

        Batch fast path: ONE native call encodes every ASCII row
        (mpr_bpe_encode_batch fills a numpy matrix directly); rows the
        native encoder rejects (lens[i] == -1: non-ASCII, '&', special
        literals) fall back to the exact per-row path. Frames are
        identical either way."""
        if isinstance(texts, str):
            texts = [texts]
        n = len(texts)
        L = self.context_length
        result = np.zeros((n, L), np.int32)
        lens = None
        if n > 1 and self._native.available:
            try:
                mat, lens = self._native.encode_batch(texts, cap=L + 8)
            except Exception:
                lens = None
        if lens is not None and (lens >= 0).all() \
                and int(lens.max(initial=0)) <= L - 2:
            # every row native and in-frame: pure numpy assembly
            m = int(lens.max(initial=0))
            if m:
                valid = np.arange(m)[None, :] < lens[:, None]
                result[:, 1:1 + m] = np.where(valid, mat[:, :m], 0)
            result[:, 0] = self.sot
            result[np.arange(n), lens + 1] = self.eot
            return result
        for i, text in enumerate(texts):
            if lens is not None and lens[i] >= 0:
                toks = [self.sot] + mat[i, :lens[i]].tolist() + [self.eot]
            else:
                toks = [self.sot] + self.encode(text) + [self.eot]
            if len(toks) > L:
                if not truncate:
                    raise RuntimeError(
                        f"Input {text!r} is too long for context length "
                        f"{L}")
                toks = toks[:L]
                toks[-1] = self.eot
            result[i, :len(toks)] = toks
        return result

    def decode(self, ids: Iterable[int]) -> str:
        ids = [int(i) for i in ids]
        if self.eot in ids:
            # tokenize() zero-pads AFTER the EOT; cut there instead of
            # filtering id 0 globally — 0 is the real token '!' (first
            # bytes_to_unicode entry) and must survive inside the text
            ids = ids[:ids.index(self.eot)]
        text = "".join(self.decoder[i] for i in ids if i != self.sot)
        # byte-decode first ('<','/','w','>' are ordinary byte symbols), then
        # replace the word-end marker in the decoded string — openai/CLIP
        # simple tokenizer decode order.
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace(
            "</w>", " ").strip()
