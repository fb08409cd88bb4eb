"""Tiktoken-format tokenizer (reference: python/hetu/data/tokenizers/
tiktoken_tokenizer.py).

The rank file (one `base64(token) rank` pair per line) loads WITHOUT the
tiktoken package, and the byte-pair merge itself is implemented here
(lowest-rank adjacent pair first — the tiktoken algorithm), so the tokenizer
is fully functional standalone; when the `tiktoken` package is importable
its compiled Encoding is used for the hot encode path instead.

The port's copy of `hetu_tpu/data/tokenizers/tiktoken_bpe.py`, unchanged but for its
imports (host code: the port never imports the JAX package).
"""
from __future__ import annotations

import base64
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Union

# llama3-style split pattern (the reference ships PATTERN_TIKTOKEN variants;
# any pattern string can be passed in)
PATTERN_DEFAULT = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)


def load_tiktoken_ranks(path: str) -> Dict[bytes, int]:
    """Parse a .tiktoken/.model rank file: `base64(token) rank` per line."""
    ranks: Dict[bytes, int] = {}
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            tok_b64, rank = line.split()
            ranks[base64.b64decode(tok_b64)] = int(rank)
    return ranks


def save_tiktoken_ranks(ranks: Dict[bytes, int], path: str):
    with open(path, "wb") as f:
        for tok, rank in sorted(ranks.items(), key=lambda kv: kv[1]):
            f.write(base64.b64encode(tok) + b" " + str(rank).encode() + b"\n")


def bpe_merge(piece: bytes, ranks: Dict[bytes, int]) -> List[int]:
    """Tiktoken's merge loop: repeatedly fuse the adjacent part pair with
    the LOWEST rank until none is mergeable; parts map to their rank ids."""
    parts = [piece[i:i + 1] for i in range(len(piece))]
    while len(parts) > 1:
        best_k, best_rank = -1, None
        for k in range(len(parts) - 1):
            r = ranks.get(parts[k] + parts[k + 1])
            if r is not None and (best_rank is None or r < best_rank):
                best_k, best_rank = k, r
        if best_k < 0:
            break
        parts[best_k:best_k + 2] = [parts[best_k] + parts[best_k + 1]]
    return [ranks[p] for p in parts]


class TikTokenizer:
    """Byte-level BPE over a tiktoken rank file + named special tokens."""

    def __init__(self, path: str, pattern: str = PATTERN_DEFAULT,
                 special_tokens: Optional[Sequence[str]] = None):
        self.ranks = load_tiktoken_ranks(path)
        self.pattern = pattern
        specials = list(special_tokens if special_tokens is not None
                        else ("<s>", "</s>", "<unk>"))
        # non-dense rank files exist (holes in the id space): special ids
        # must start past the MAX rank, not len(ranks), or they collide
        # with base ids and decode() silently prefers the base token
        base = (max(self.ranks.values()) + 1) if self.ranks else 0
        self.special_tokens = {t: base + i for i, t in enumerate(specials)}
        self._base = base
        self.bos_id = self.special_tokens.get("<s>")
        self.eos_id = self.special_tokens.get("</s>")
        self.pad_id = self.eos_id
        self._id_to_bytes = {r: t for t, r in self.ranks.items()}
        self._id_to_special = {i: t for t, i in self.special_tokens.items()}

        import regex
        self._pat = regex.compile(pattern)
        self._fast = None
        try:  # optional compiled path
            from tiktoken import Encoding
            self._fast = Encoding(
                name=Path(path).stem, pat_str=pattern,
                mergeable_ranks=self.ranks,
                special_tokens=self.special_tokens)
        except Exception:
            pass

    # -------------------------------------------------- encode / decode
    def _encode_ordinary(self, text: str) -> List[int]:
        if self._fast is not None:
            return self._fast.encode(text, disallowed_special=())
        ids: List[int] = []
        for m in self._pat.finditer(text):
            piece = m.group().encode("utf-8")
            r = self.ranks.get(piece)
            ids.extend([r] if r is not None else bpe_merge(piece, self.ranks))
        return ids

    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        ids = self._encode_ordinary(text) if text else []
        if add_bos and self.bos_id is not None:
            ids = [self.bos_id] + ids
        if add_eos and self.eos_id is not None:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Union[int, Sequence[int]]) -> str:
        if isinstance(ids, int):
            ids = [ids]
        buf = bytearray()
        for i in ids:
            b = self._id_to_bytes.get(i)
            if b is not None:
                buf.extend(b)
            elif i in self._id_to_special:
                buf.extend(self._id_to_special[i].encode("utf-8"))
        return buf.decode("utf-8", errors="replace")

    # -------------------------------------------------- vocab surface
    @property
    def vocab_size(self) -> int:
        # id-space size (embedding rows needed), not the token count —
        # the two differ when the rank file is non-dense
        return self._base + len(self.special_tokens)

    @property
    def base_vocab_size(self) -> int:
        # id-space size below the special tokens (== first special id);
        # > len(self.ranks) when the rank file is non-dense
        return self._base

    def token_to_id(self, token: Union[str, bytes]) -> Optional[int]:
        if isinstance(token, str):
            sid = self.special_tokens.get(token)
            if sid is not None:
                return sid
            token = token.encode("utf-8")
        return self.ranks.get(token)
