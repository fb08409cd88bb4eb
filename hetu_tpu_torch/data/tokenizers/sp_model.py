"""SentencePiece tokenizer with a pure-python .model loader.

The reference wraps the `sentencepiece` runtime (reference: python/hetu/data/
tokenizers/sentencepiece_tokenizer.py) — which is not available here, so this
module reads the `tokenizer.model` protobuf DIRECTLY (generic proto wire
parsing, no compiled schema) and implements both sentencepiece inference
algorithms in python:

  * unigram — Viterbi segmentation maximizing summed piece log-probs
  * bpe     — greedy best-score adjacent merge (sp stores merge priority as
              the piece score, so "highest score first" == training order)

plus the LLaMA-relevant details: ▁ whitespace escaping, add_dummy_prefix,
byte-fallback pieces (<0x00>..<0xFF>) for out-of-vocab characters, and
CONTROL pieces (bos/eos/pad) excluded from text matching.

The port's copy of `hetu_tpu/data/tokenizers/sp_model.py`, unchanged but for its
imports (host code: the port never imports the JAX package).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

_WS = "▁"  # ▁

# sentencepiece_model.proto piece types
_NORMAL, _UNKNOWN, _CONTROL, _USER_DEFINED, _UNUSED, _BYTE = 1, 2, 3, 4, 5, 6


# ---------------------------------------------------------------------------
# minimal protobuf wire reader (enough for ModelProto)
# ---------------------------------------------------------------------------

def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _signed(v: int) -> int:
    """proto int32/int64 varints are two's complement in 64 bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's wire data.
    value: int for varint/fixed, bytes for length-delimited."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        fno, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
        elif wt == 1:
            v = struct.unpack("<Q", buf[i:i + 8])[0]
            i += 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:
            v = struct.unpack("<I", buf[i:i + 4])[0]
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt} (field {fno})")
        yield fno, wt, v


def parse_model_proto(data: bytes):
    """ModelProto -> (pieces [(text, score, type)], trainer {..}, norm {..})."""
    pieces: List[Tuple[str, float, int]] = []
    trainer: Dict[str, int] = {}
    # proto defaults (sentencepiece_model.proto NormalizerSpec):
    # remove_extra_whitespaces defaults TRUE — models trained with
    # defaults omit the field entirely
    norm = {"add_dummy_prefix": True, "escape_whitespaces": True,
            "remove_extra_whitespaces": True}
    for fno, _, v in _fields(data):
        if fno == 1:  # repeated SentencePiece
            text, score, typ = "", 0.0, _NORMAL
            for pfno, pwt, pv in _fields(v):
                if pfno == 1:
                    text = pv.decode("utf-8")
                elif pfno == 2:
                    score = struct.unpack("<f", struct.pack("<I", pv))[0]
                elif pfno == 3:
                    typ = pv
            pieces.append((text, score, typ))
        elif fno == 2:  # TrainerSpec
            for tfno, twt, tv in _fields(v):
                if tfno == 3:    # model_type: 1=unigram 2=bpe
                    trainer["model_type"] = tv
                elif tfno == 35:  # byte_fallback
                    trainer["byte_fallback"] = bool(tv)
                elif tfno == 40:
                    trainer["unk_id"] = _signed(tv)
                elif tfno == 41:
                    trainer["bos_id"] = _signed(tv)
                elif tfno == 42:
                    trainer["eos_id"] = _signed(tv)
                elif tfno == 43:
                    trainer["pad_id"] = _signed(tv)
        elif fno == 3:  # NormalizerSpec
            for nfno, nwt, nv in _fields(v):
                if nfno == 1:
                    norm["name"] = nv.decode("utf-8")
                elif nfno == 3:
                    norm["add_dummy_prefix"] = bool(nv)
                elif nfno == 4:
                    norm["remove_extra_whitespaces"] = bool(nv)
                elif nfno == 5:
                    norm["escape_whitespaces"] = bool(nv)
    return pieces, trainer, norm


# ---------------------------------------------------------------------------
# writer (tests + in-tree model construction; also proves the reader against
# real wire format rather than a private fixture format)
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _ld(fno: int, payload: bytes) -> bytes:
    return _varint((fno << 3) | 2) + _varint(len(payload)) + payload


def write_model_proto(pieces: Sequence[Tuple[str, float, int]],
                      model_type: int = 1, *,
                      unk_id: int = 0, bos_id: int = 1, eos_id: int = 2,
                      pad_id: int = -1, add_dummy_prefix: bool = True,
                      byte_fallback: bool = False,
                      normalizer_name: str = "identity",
                      remove_extra_whitespaces: bool = False) -> bytes:
    out = b""
    for text, score, typ in pieces:
        p = _ld(1, text.encode("utf-8"))
        p += _varint((2 << 3) | 5) + struct.pack("<f", score)
        p += _varint((3 << 3) | 0) + _varint(typ)
        out += _ld(1, p)
    tr = _varint((3 << 3) | 0) + _varint(model_type)
    tr += _varint((35 << 3) | 0) + _varint(int(byte_fallback))
    for fno, vid in ((40, unk_id), (41, bos_id), (42, eos_id), (43, pad_id)):
        tr += _varint((fno << 3) | 0) + _varint(vid)
    out += _ld(2, tr)
    nm = _ld(1, normalizer_name.encode("utf-8"))
    nm += _varint((3 << 3) | 0) + _varint(int(add_dummy_prefix))
    nm += _varint((4 << 3) | 0) + _varint(int(remove_extra_whitespaces))
    nm += _varint((5 << 3) | 0) + _varint(1)
    out += _ld(3, nm)
    return out


# ---------------------------------------------------------------------------
# rule-name normalization (NormalizerSpec.name driven)
# ---------------------------------------------------------------------------

# The real sentencepiece runtime normalizes through the model's PRECOMPILED
# charsmap (a serialized double-array trie baked at training time from the
# named rule — builder.cc BuildNmtNfkcMap).  This module implements the
# NAMED rules directly with unicodedata instead of decoding the trie:
# identical for NFKC-representable mappings (the overwhelming majority —
# fullwidth forms, compatibility ligatures, composed accents), approximate
# for the handful of hand-curated NMT entries.  Documented divergence, not
# silent: models whose name is unknown raise.
_NMT_SPACE = {0x0009, 0x000A, 0x000D, 0x000B, 0x000C, 0x00A0, 0x1680,
              0x2028, 0x2029, 0x202F, 0x205F, 0x3000} | \
             set(range(0x2000, 0x200B))
_NMT_REMOVE = (set(range(0x0000, 0x0009)) | set(range(0x000E, 0x0020))
               | {0x007F, 0x008F, 0x009F, 0x00AD, 0xFEFF}
               | set(range(0x200B, 0x2010)) | set(range(0x202A, 0x202F))
               | set(range(0x2060, 0x2065)))


def _nmt_premap(text: str) -> str:
    out = []
    for ch in text:
        cp = ord(ch)
        if cp in _NMT_REMOVE:
            continue
        out.append(" " if cp in _NMT_SPACE else ch)
    return "".join(out)


#: NormalizerSpec rule names this module implements; anything else (e.g.
#: 'user_defined' custom-charsmap models, which sentencepiece supports)
#: falls back to identity AT LOAD TIME with a logged warning — a model
#: that loads must not start raising on its first encode().
KNOWN_RULES = ("identity", "", "nfkc", "nfkc_cf", "nmt_nfkc", "nmt_nfkc_cf")


def rule_normalize(name: str, text: str) -> str:
    """Apply the NormalizerSpec rule `name` (reference: the sentencepiece
    normalization_rule_name the library bakes into the charsmap)."""
    import unicodedata
    if name in ("identity", ""):
        return text
    if name in ("nfkc", "nfkc_cf", "nmt_nfkc", "nmt_nfkc_cf"):
        if name.startswith("nmt_"):
            text = _nmt_premap(text)
        text = unicodedata.normalize("NFKC", text)
        if name.endswith("_cf"):
            text = text.casefold()
        return text
    raise ValueError(f"unknown normalization rule {name!r} "
                     "(identity|nfkc|nfkc_cf|nmt_nfkc|nmt_nfkc_cf)")


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

class SentencePieceTokenizer:
    """encode/decode over a sentencepiece .model file, runtime-free."""

    def __init__(self, model_file: Optional[str] = None,
                 model_bytes: Optional[bytes] = None):
        if model_bytes is None:
            if model_file is None:
                raise ValueError("need model_file or model_bytes")
            with open(model_file, "rb") as f:
                model_bytes = f.read()
        pieces, trainer, norm = parse_model_proto(model_bytes)
        self.pieces = pieces
        self.model_type = trainer.get("model_type", 1)
        self.add_dummy_prefix = norm["add_dummy_prefix"]
        self.normalizer_name = norm.get("name", "identity")
        if self.normalizer_name not in KNOWN_RULES:
            # validate ONCE at load: unknown rules (custom precompiled
            # charsmaps) degrade to identity with a visible warning instead
            # of raising mid-encode()
            from hetu_tpu_torch.utils.logging import get_logger
            get_logger("tokenizers.sp").warning(
                f"unknown normalization rule "
                f"{self.normalizer_name!r}; known rules are "
                f"{[r for r in KNOWN_RULES if r]} — falling back to "
                "identity (the model's precompiled charsmap is not "
                "applied)")
            self.normalizer_name = "identity"
        self.remove_extra_whitespaces = norm["remove_extra_whitespaces"]
        self.unk_id = trainer.get("unk_id", 0)
        self.bos_id = trainer.get("bos_id", 1)
        self.eos_id = trainer.get("eos_id", 2)
        self.pad_id = trainer.get("pad_id", -1)
        # text-matchable vocab: NORMAL + USER_DEFINED only
        self._vocab: Dict[str, Tuple[int, float]] = {}
        self._byte_ids: Dict[int, int] = {}   # byte value -> piece id
        for pid, (text, score, typ) in enumerate(pieces):
            if typ in (_NORMAL, _USER_DEFINED):
                self._vocab[text] = (pid, score)
            elif typ == _BYTE:
                self._byte_ids[int(text[1:-1], 16)] = pid  # "<0xAB>"
        self._max_len = max((len(t) for t in self._vocab), default=1)
        # no vocab piece carries ▁ past position 0 -> no merge can cross
        # a word boundary -> the BPE arena chunks exactly at each ▁
        # (LLaMA-style vocabs qualify; interior-▁ pieces fall back to the
        # whole-text arena)
        self._bpe_chunkable = not any(_WS in t[1:] for t in self._vocab)

    # -------------------------------------------------- helpers
    def _normalize(self, text: str) -> str:
        """NormalizerSpec order (normalizer.cc): charsmap rule ->
        whitespace squeeze -> ▁ escaping -> dummy prefix."""
        text = rule_normalize(self.normalizer_name, text)
        if self.remove_extra_whitespaces:
            import re
            text = re.sub(r" +", " ", text).strip(" ")
        text = text.replace(" ", _WS)
        if self.add_dummy_prefix and text and not text.startswith(_WS):
            text = _WS + text
        return text

    def _char_fallback(self, ch: str, out: List[int]):
        """OOV character -> byte pieces when present, else unk."""
        if self._byte_ids:
            for b in ch.encode("utf-8"):
                out.append(self._byte_ids.get(b, self.unk_id))
        else:
            out.append(self.unk_id)

    # -------------------------------------------------- unigram (Viterbi)
    def _encode_unigram(self, text: str) -> List[int]:
        n = len(text)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)
        best[0] = 0.0
        unk_penalty = min(
            (s for _, (_, s) in self._vocab.items()), default=0.0) - 10.0
        for i in range(n):
            if best[i] == NEG:
                continue
            hi = min(n, i + self._max_len)
            for j in range(i + 1, hi + 1):
                hit = self._vocab.get(text[i:j])
                if hit is not None and best[i] + hit[1] > best[j]:
                    best[j] = best[i] + hit[1]
                    back[j] = (i, hit[0])
            # fallback edge: single char as unk/byte
            if best[i] + unk_penalty > best[i + 1]:
                best[i + 1] = best[i] + unk_penalty
                back[i + 1] = (i, -1)
        ids: List[int] = []
        j = n
        rev: List[Tuple[int, int, int]] = []   # (i, j, id|-1)
        while j > 0:
            i, pid = back[j]
            rev.append((i, j, pid))
            j = i
        for i, j, pid in reversed(rev):
            if pid >= 0:
                ids.append(pid)
            else:
                self._char_fallback(text[i:j], ids)
        return ids

    # -------------------------------------------------- bpe (score merges)
    def _encode_bpe(self, text: str) -> List[int]:
        """Best-score-first adjacent merges (ties leftmost — the greedy
        reference semantics; the sentencepiece library's symbol-pair
        agenda is the same scheme, bpe_model.cc).  Word-chunked when the
        vocab allows (corpus-speed path), heap-based lazy-invalidation
        merges within an arena — against the O(n^2) rescan the first
        version did."""
        if self._bpe_chunkable and len(text) > 64:
            ids: List[int] = []
            start = 0
            for k in range(1, len(text) + 1):
                if k == len(text) or text[k] == _WS:
                    ids.extend(self._merge_arena(text[start:k]))
                    start = k
            return ids
        return self._merge_arena(text)

    def _merge_arena(self, text: str) -> List[int]:
        import heapq

        units = list(text)
        n = len(units)
        if n <= 1:
            return self._bpe_emit(units)
        if n <= 16:
            # small arenas (typical ▁-chunked words): the plain greedy
            # rescan beats the heap's setup cost
            get = self._vocab.get
            while len(units) > 1:
                best_k, best_score = -1, None
                for k in range(len(units) - 1):
                    hit = get(units[k] + units[k + 1])
                    if hit is not None and (best_score is None
                                            or hit[1] > best_score):
                        best_k, best_score = k, hit[1]
                if best_k < 0:
                    break
                units[best_k:best_k + 2] = [units[best_k]
                                            + units[best_k + 1]]
            return self._bpe_emit(units)
        nxt = list(range(1, n)) + [-1]
        prv = [-1] + list(range(0, n - 1))
        alive = [True] * n
        heap: List[Tuple[float, int, str, str]] = []

        def push(k: int):
            j = nxt[k]
            if j < 0:
                return
            hit = self._vocab.get(units[k] + units[j])
            if hit is not None:
                # (-score, k): leftmost wins ties like the greedy scan
                heapq.heappush(heap, (-hit[1], k, units[k], units[j]))

        for k in range(n - 1):
            push(k)
        while heap:
            _, k, left, right = heapq.heappop(heap)
            if not alive[k] or units[k] != left:
                continue              # stale: k was merged away/changed
            j = nxt[k]
            if j < 0 or units[j] != right:
                continue              # stale: the right neighbor changed
            units[k] = left + right
            alive[j] = False
            nxt[k] = nxt[j]
            if nxt[j] >= 0:
                prv[nxt[j]] = k
            if prv[k] >= 0:
                push(prv[k])
            push(k)
        return self._bpe_emit([units[k] for k in range(n) if alive[k]])

    def _bpe_emit(self, units: Sequence[str]) -> List[int]:
        ids: List[int] = []
        for u in units:
            hit = self._vocab.get(u)
            if hit is not None:
                ids.append(hit[0])
            else:
                for ch in u:
                    self._char_fallback(ch, ids)
        return ids

    # -------------------------------------------------- public api
    def encode(self, text: str, add_bos: bool = False,
               add_eos: bool = False) -> List[int]:
        if not text:
            ids = []
        else:
            t = self._normalize(text)
            ids = (self._encode_bpe(t) if self.model_type == 2
                   else self._encode_unigram(t))
        if add_bos and self.bos_id >= 0:
            ids = [self.bos_id] + ids
        if add_eos and self.eos_id >= 0:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out: List[str] = []
        byte_buf = bytearray()

        def flush():
            if byte_buf:
                out.append(byte_buf.decode("utf-8", errors="replace"))
                byte_buf.clear()

        for pid in ids:
            if pid < 0 or pid >= len(self.pieces):
                continue
            text, _, typ = self.pieces[pid]
            if typ == _BYTE:
                byte_buf.append(int(text[1:-1], 16))
                continue
            flush()
            if typ in (_CONTROL, _UNKNOWN):
                continue
            out.append(text)
        flush()
        s = "".join(out).replace(_WS, " ")
        if self.add_dummy_prefix and s.startswith(" "):
            s = s[1:]
        return s

    @property
    def vocab_size(self) -> int:
        return len(self.pieces)

    def id_to_piece(self, pid: int) -> str:
        return self.pieces[pid][0]

    def piece_to_id(self, piece: str) -> int:
        hit = self._vocab.get(piece)
        if hit is not None:
            return hit[0]
        for pid, (text, _, _) in enumerate(self.pieces):
            if text == piece:
                return pid
        return self.unk_id
