"""The port's data stack (hetu_tpu_torch/data) against the JAX package's
(hetu_tpu/data), on the same seeded inputs.

The modules are host code copied into the port, so the two sides must
agree exactly: every array equal byte for byte (values, dtype, shape,
keys), every token id, every file a tokenizer writes.  The cases mirror
tests/test_data.py, tests/test_messages.py, tests/test_tokenizers.py and
tests/test_tokenizers_sp_tiktoken.py.  Where the port's prefetch thread
differs from the reference's (it stops with its consumer, and hands a
collation error to it) the port alone is tested.
"""
from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest

from hetu_tpu.data import bucket as jbucket
from hetu_tpu.data import data_collator as jcollator
from hetu_tpu.data import dataloader as jloader
from hetu_tpu.data import dataset as jdataset
from hetu_tpu.data import messages as jmessages
from hetu_tpu.data.tokenizers import bpe as jbpe
from hetu_tpu.data.tokenizers import hf as jhf
from hetu_tpu.data.tokenizers import sp_model as jsp
from hetu_tpu.data.tokenizers import tiktoken_bpe as jtt
from hetu_tpu_torch.data import bucket as tbucket
from hetu_tpu_torch.data import data_collator as tcollator
from hetu_tpu_torch.data import dataloader as tloader
from hetu_tpu_torch.data import dataset as tdataset
from hetu_tpu_torch.data import messages as tmessages
from hetu_tpu_torch.data.tokenizers import bpe as tbpe
from hetu_tpu_torch.data.tokenizers import hf as thf
from hetu_tpu_torch.data.tokenizers import sp_model as tsp
from hetu_tpu_torch.data.tokenizers import tiktoken_bpe as ttt


def _same(a, b):
    """Two batches (dicts of arrays) equal byte for byte."""
    assert list(a) == list(b)
    for key in a:
        x, y = np.asarray(a[key]), np.asarray(b[key])
        assert x.dtype == y.dtype and x.shape == y.shape, key
        assert x.tobytes() == y.tobytes(), key


def _seqs(lengths, seed=0, vocab=100):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in lengths]


# ------------------------------------------------------------ bucket
@pytest.mark.parametrize("lengths,max_len,pad_id", [
    ((5, 9), 16, 0),            # test_pad_batch_shapes_and_masks
    ((3, 20, 16, 1), 16, 7),    # truncation past max_len, another pad id
    ((), 8, 0)])
def test_pad_batch_equals_the_reference(lengths, max_len, pad_id):
    seqs = _seqs(lengths)
    _same(tbucket.pad_batch(seqs, max_len, pad_id),
          jbucket.pad_batch(seqs, max_len, pad_id))


@pytest.mark.parametrize("lengths,max_len,num_packed,on_overflow", [
    ((60, 50, 40, 30, 20, 10), 128, None, "warn"),  # the invariants case
    ((60, 50, 40, 30, 20, 10), 128, 4, "warn"),     # padded to 4 rows
    ((100, 90, 80, 70, 5), 128, 2, "warn"),         # overflow, logged
    ((100, 90, 80, 70, 5), 128, 2, "silent"),       # overflow, dropped
    ((200, 30, 7), 64, None, "warn"),               # a sequence past a row
    ((1, 1, 1, 2, 64), 64, 3, "error")])            # fits exactly
def test_pack_sequences_equals_the_reference(lengths, max_len, num_packed,
                                             on_overflow):
    seqs = _seqs(lengths, seed=1)
    got = tbucket.pack_sequences(seqs, max_len, 0, num_packed=num_packed,
                                 on_overflow=on_overflow)
    _same(got, jbucket.pack_sequences(seqs, max_len, 0,
                                      num_packed=num_packed,
                                      on_overflow=on_overflow))
    if num_packed is not None:
        assert got["input_ids"].shape[0] == num_packed


def test_pack_sequences_overflow_error_equals_the_reference():
    seqs = _seqs((100, 90, 80, 70, 5), seed=2)
    errors = []
    for mod in (tbucket, jbucket):
        with pytest.raises(ValueError) as e:
            mod.pack_sequences(seqs, 128, num_packed=2, on_overflow="error")
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_bucket_and_collator_equal_the_reference():
    seqs = _seqs((30, 7, 12, 50, 3), seed=3)
    tb, jb = tbucket.Bucket(32, pad_id=2), jbucket.Bucket(32, pad_id=2)
    for s in seqs:
        tb.add(s)
        jb.add(s)
    assert len(tb) == len(jb) == 5
    _same(tb.pad_batch(), jb.pad_batch())
    _same(tb.pack_batch(), jb.pack_batch())
    _same(tb.pack_batch(num_packed=4), jb.pack_batch(num_packed=4))
    for packing in (False, True):
        tc = tcollator.DataCollatorForLanguageModel(64, 1, packing)
        jc = jcollator.DataCollatorForLanguageModel(64, 1, packing)
        _same(tc(seqs), jc(seqs))
        _same(tc(seqs, num_rows=3), jc(seqs, num_rows=3))


@pytest.mark.parametrize("length", [1, 100, 256, 257, 4096, 32768, 10 ** 9])
def test_choose_bucket_equals_the_reference(length):
    assert tbucket.choose_bucket(length) == jbucket.choose_bucket(length)
    ladder = (64, 192)
    assert tbucket.choose_bucket(length, ladder) == jbucket.choose_bucket(
        length, ladder)


@pytest.mark.parametrize("split", ["sym", "stripe", "normal"])
@pytest.mark.parametrize("cp", [2, 4])
def test_cp_split_and_merge_equal_the_reference(split, cp):
    batch = tbucket.pack_sequences(_seqs((40, 30, 20, 10, 5), seed=4), 64,
                                   num_packed=3)
    shards = tbucket.cp_split_batch(batch, cp, split=split)
    ref = jbucket.cp_split_batch(batch, cp, split=split)
    assert len(shards) == len(ref) == cp
    for a, b in zip(shards, ref):
        _same(a, b)
    _same(tbucket.merge_cp_batch(shards, split=split),
          jbucket.merge_cp_batch(ref, split=split))
    _same(tbucket.merge_cp_batch(shards, split=split), batch)
    for a, b in zip(tbucket.cp_split_indices(64, cp, split),
                    jbucket.cp_split_indices(64, cp, split)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cp", [2, 4])
def test_cp_split_default_is_the_reference_default(monkeypatch, cp):
    """The split defaults to "sym", the reference's default (its flag
    unset); a pattern outside sym, stripe and normal raises on both
    sides."""
    monkeypatch.delenv("HETU_TPU_CP_SPLIT", raising=False)
    batch = tbucket.pad_batch([np.arange(64), np.arange(64)], 64)
    for a, b in zip(tbucket.cp_split_batch(batch, cp),
                    jbucket.cp_split_batch(batch, cp)):
        _same(a, b)
    for mod in (tbucket, jbucket):
        with pytest.raises(ValueError):
            mod.cp_split_batch(batch, cp, split="zigzag")


@pytest.mark.parametrize("seq,cp", [(64, 4), (40, 4), (4, 4), (48, 3),
                                    (7, 2)])
def test_stripe_granularity_and_bad_splits_equal_the_reference(seq, cp):
    assert tbucket.stripe_granularity(seq, cp) == \
        jbucket.stripe_granularity(seq, cp)
    batch = {"input_ids": np.arange(seq)[None]}
    outcomes = []
    for mod in (tbucket, jbucket):
        for split in ("stripe", "zigzag"):
            try:
                out = mod.cp_split_batch(batch, cp, split=split)
                outcomes.append([s["input_ids"].tolist() for s in out])
            except (ValueError, AssertionError) as e:
                outcomes.append(type(e).__name__)
    assert outcomes[:2] == outcomes[2:]


@pytest.mark.parametrize("lengths,align", [((10, 6, 8, 8), 1),
                                           ((13, 3, 0, 16), 8)])
def test_cp_uneven_split_and_merge_equal_the_reference(lengths, align):
    batch = tbucket.pack_sequences(_seqs((20, 12, 9), seed=5),
                                   sum(lengths), num_packed=2)
    got = tbucket.cp_split_uneven(batch, lengths, align=align, pad_id=3)
    _same(got, jbucket.cp_split_uneven(batch, lengths, align=align,
                                       pad_id=3))
    _same(tbucket.merge_cp_uneven(got, lengths),
          jbucket.merge_cp_uneven(got, lengths))
    _same(tbucket.merge_cp_uneven(got, lengths), batch)
    with pytest.raises(ValueError):
        tbucket.cp_split_uneven(batch, lengths[:-1])


# ------------------------------------------------- datasets, loaders
def test_synthetic_and_json_datasets_equal_the_reference(tmp_path):
    a = tdataset.TokenizedDataset.synthetic(20, 50, 5, 20, seed=3)
    b = jdataset.TokenizedDataset.synthetic(20, 50, 5, 20, seed=3)
    assert len(a) == len(b) == 20
    for i in range(20):
        assert a[i].dtype == b[i].dtype and a[i].tobytes() == b[i].tobytes()

    class Tok:
        eos_token_id = 0

        def encode(self, s):
            return [ord(c) % 250 + 1 for c in s]

    lines = tmp_path / "d.jsonl"
    lines.write_text('{"text": "hello"}\n\n{"text": "world!"}\n')
    array = tmp_path / "d.json"
    array.write_text(json.dumps([{"text": "ab"}, "cd"]))
    for path, kw in ((lines, {"max_seq_len": 4}), (array, {}),
                     (array, {"append_eos": False})):
        x = tdataset.JsonDataset(str(path), Tok(), **kw)
        y = jdataset.JsonDataset(str(path), Tok(), **kw)
        assert len(x) == len(y)
        for i in range(len(x)):
            assert x[i].tobytes() == y[i].tobytes()


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("shuffle,drop_last,packing", [
    (True, True, False), (False, False, False), (True, True, True)])
def test_dataloader_order_equals_the_reference(prefetch, shuffle, drop_last,
                                               packing):
    """Batches, their order and their collation (packed rows pinned to
    the batch size) equal the reference's loader's, with and without the
    prefetch thread."""
    ds = tdataset.TokenizedDataset.synthetic(30, 50, 5, 20, seed=7)
    ref_ds = jdataset.TokenizedDataset.synthetic(30, 50, 5, 20, seed=7)
    mine = tloader.DataLoader(
        ds, 4, tcollator.DataCollatorForLanguageModel(32, packing=packing),
        shuffle=shuffle, seed=7, drop_last=drop_last, prefetch=prefetch)
    ref = jloader.DataLoader(
        ref_ds, 4, jcollator.DataCollatorForLanguageModel(32,
                                                          packing=packing),
        shuffle=shuffle, seed=7, drop_last=drop_last, prefetch=0)
    assert len(mine) == len(ref)
    for epoch in (0, 1):
        got, want = list(mine.epoch(epoch)), list(ref.epoch(epoch))
        assert len(got) == len(want) == len(mine)
        for a, b in zip(got, want):
            _same(a, b)
    built = tloader.build_data_loader(ds, 4, 32, packing=packing,
                                      shuffle=shuffle, prefetch=prefetch)
    for a, b in zip(built, jloader.build_data_loader(
            ref_ds, 4, 32, packing=packing, shuffle=shuffle, prefetch=0)):
        _same(a, b)


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.daemon and t.name.startswith("Thread")]


def test_prefetch_thread_stops_with_its_consumer():
    """A consumer that stops after two batches (the queue full behind
    it) stops the prefetch thread: nothing is left waiting."""
    ds = tdataset.TokenizedDataset.synthetic(400, 50, 5, 20)
    before = set(_prefetch_threads())
    it = tloader.build_data_loader(ds, 2, 32, prefetch=2).epoch(0)
    assert [b["input_ids"].shape for b in (next(it), next(it))] == [
        (2, 32), (2, 32)]
    time.sleep(0.05)              # the thread fills the queue and waits
    it.close()
    assert set(_prefetch_threads()) <= before


def test_prefetch_hands_a_collation_error_to_the_consumer():
    """A packing overflow under on_overflow="error" raised while the
    thread collates reaches the consumer (the reference's would wait for
    the batch forever)."""
    def collate(seqs):
        return tbucket.pack_sequences(seqs, 16, num_packed=1,
                                      on_overflow="error")
    loader = tloader.DataLoader(
        tdataset.TokenizedDataset.synthetic(8, 50, 12, 16), 4, collate,
        shuffle=False, prefetch=2)
    with pytest.raises(ValueError, match="packing overflow"):
        list(loader)


# ---------------------------------------------------------- messages
_SAMPLES = [
    ("input_output", {"new_system_prompt": "be brief"},
     {"input": "2+2?", "output": "4"}),
    ("input_output", {"train_on_input": True}, {"input": "a", "output": "b"}),
    ("input_output", {"column_map": {"input": "q"}},
     {"q": "x", "output": "y"}),
    ("alpaca", {}, {"instruction": "add", "input": "2 2", "output": "4"}),
    ("alpaca", {}, {"instruction": "say hi", "output": "hi"}),
    ("sharegpt", {}, {"conversations": [
        {"from": "system", "value": "s"}, {"from": "human", "value": "q"},
        {"from": "gpt", "value": "a"}]}),
    ("openai", {}, {"messages": [{"role": "user", "content": "q"},
                                 {"role": "assistant", "content": "a"}]}),
]
_TEMPLATES = {"input_output": "InputOutputTemplate",
              "alpaca": "AlpacaTemplate", "sharegpt": "ShareGPTTemplate",
              "openai": "OpenAITemplate"}


def _char_encode(s):
    return [ord(c) % 256 for c in s]


@pytest.mark.parametrize("i", range(len(_SAMPLES)))
def test_message_templates_equal_the_reference(i):
    kind, kw, sample = _SAMPLES[i]
    name = _TEMPLATES[kind]
    assert getattr(tmessages, name)(**kw)(sample) == \
        getattr(jmessages, name)(**kw)(sample)


@pytest.mark.parametrize("fmt,max_len", [("raw", None), ("raw", 3),
                                         ("default", None), ("default", 7)])
def test_render_messages_equals_the_reference(fmt, max_len):
    msgs = [{"role": "system", "content": "s", "masked": True},
            {"role": "user", "content": "ab", "masked": True},
            {"role": "assistant", "content": "cd", "masked": False},
            {"role": "user", "content": "r", "masked": True},
            {"role": "assistant", "content": "e", "masked": False}]
    out = []
    for mod in (tmessages, jmessages):
        chat = (mod.ChatFormat(role_prefix={}, role_suffix={})
                if fmt == "raw" else mod.ChatFormat())
        out.append(mod.render_messages(msgs, _char_encode, chat_format=chat,
                                       bos_id=1, eos_id=2, max_len=max_len))
    for a, b in zip(*out):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _sp_pieces(mod):
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    pieces += [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
    pieces += [("▁", -2.0, 1), ("▁hi", -3.0, 1), ("▁there", -3.5, 1)]
    return mod.write_model_proto(pieces, 1, byte_fallback=True)


@pytest.mark.parametrize("i", [0, 3, 5])
def test_build_sft_example_masks_equal_the_reference(i):
    """The SFT path end to end with the in-tree SentencePiece tokenizer:
    ids and the loss mask equal the reference's."""
    _, _, sample = _SAMPLES[i]
    out = []
    for mod, sp in ((tmessages, tsp), (jmessages, jsp)):
        tok = sp.SentencePieceTokenizer(model_bytes=_sp_pieces(sp))
        template = getattr(mod, _TEMPLATES[_SAMPLES[i][0]])()
        out.append(mod.build_sft_example(
            sample, template, tok.encode,
            chat_format=mod.ChatFormat(role_prefix={}, role_suffix={}),
            bos_id=tok.bos_id, eos_id=tok.eos_id, max_len=64))
    for a, b in zip(*out):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# -------------------------------------------------------- tokenizers
CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "the quick brown fox is quick and the dog is lazy",
    "pack my box with five dozen liquor jugs",
    "how vexingly quick daft zebras jump!",
    "sphinx of black quartz, judge my vow",
] * 4
_TEXTS = CORPUS[:5] + ["unseen words survive byte fallback éø",
                       "日本語 \U0001f600 \x00\x7f", ""]


@pytest.mark.parametrize("vocab_size,specials", [(400, ()), (300, ()),
                                                 (350, ("<|endoftext|>",))])
def test_bpe_train_save_load_equal_the_reference(tmp_path, vocab_size,
                                                 specials):
    mine = tbpe.ByteLevelBPETokenizer.train(CORPUS, vocab_size=vocab_size,
                                            special_tokens=specials)
    ref = jbpe.ByteLevelBPETokenizer.train(CORPUS, vocab_size=vocab_size,
                                           special_tokens=specials)
    assert mine.vocab_size == ref.vocab_size
    for text in _TEXTS:
        assert mine.encode(text) == ref.encode(text)
        assert mine.decode(mine.encode(text)) == text
    for tok, d in ((mine, tmp_path / "mine"), (ref, tmp_path / "ref")):
        tok.save(str(d))
    for name in ("vocab.json", "merges.txt"):
        assert (tmp_path / "mine" / name).read_bytes() == \
            (tmp_path / "ref" / name).read_bytes()
    loaded = tbpe.ByteLevelBPETokenizer.load(str(tmp_path / "ref"))
    via = thf.build_tokenizer("bpe", str(tmp_path / "mine"))
    for text in _TEXTS:
        assert loaded.encode(text) == via.encode(text) == ref.encode(text)
    for token in specials:
        assert mine.token_to_id(token) == ref.token_to_id(token)


@pytest.mark.parametrize("kind,path", [("nope", "x"), ("bpe", None),
                                       ("hf", None), ("sp", None),
                                       ("tiktoken", None)])
def test_build_tokenizer_validates_as_the_reference(kind, path):
    errors = []
    for mod in (thf, jhf):
        with pytest.raises(ValueError) as e:
            mod.build_tokenizer(kind, path)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


_WS = "▁"


def _llama_style_pieces():
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    pieces += [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
    for text, score in [
            (_WS, -2.0), (_WS + "the", -3.0), (_WS + "quick", -4.0),
            (_WS + "brown", -4.5), (_WS + "fox", -5.0), ("t", -8.0),
            ("h", -8.1), ("e", -8.2), ("q", -8.3), ("u", -8.4),
            ("i", -8.5), ("c", -8.6), ("k", -8.7), (_WS + "t", -7.0),
            ("he", -6.0)]:
        pieces.append((text, score, 1))
    return pieces


def _nfkc_pieces():
    pieces = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
    pieces += [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
    for i, text in enumerate(["abc", "café"[:4], "café", "x", "a", "b", "c",
                              _WS]):
        pieces.append((text, -2.0 - 0.1 * i, 1))
    return pieces


_BPE_PIECES = [("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3),
               (_WS, -1.0, 1), ("a", -2.0, 1), ("b", -2.1, 1),
               ("ab", -0.5, 1), (_WS + "ab", -0.2, 1), ("abab", -0.9, 1)]

#: name -> (pieces, write_model_proto keywords, texts)
_SP_MODELS = {
    "unigram": (_llama_style_pieces(), dict(model_type=1, unk_id=0,
                                            bos_id=1, eos_id=2,
                                            byte_fallback=True),
                ["the quick brown fox", "the ©", "quick the", " the  fox"]),
    "bpe": (_BPE_PIECES, dict(model_type=2), ["abab", "axb", "ab ab"]),
    "nmt_nfkc": (_nfkc_pieces(), dict(model_type=1, byte_fallback=True,
                                      normalizer_name="nmt_nfkc",
                                      remove_extra_whitespaces=True),
                 ["ａｂｃ", "café", "  abc  x  "]),
    "nmt_nfkc_cf": (_nfkc_pieces(), dict(model_type=1, byte_fallback=True,
                                         normalizer_name="nmt_nfkc_cf"),
                    ["ABC", "Café"]),
    "unknown_rule": (_nfkc_pieces(), dict(model_type=1,
                                          normalizer_name="martian"),
                     ["abc"]),
}


@pytest.mark.parametrize("name", sorted(_SP_MODELS))
def test_sentencepiece_write_parse_encode_equal_the_reference(tmp_path,
                                                              name):
    """write_model_proto's bytes, parse_model_proto's tables and every
    encode / decode (BOS and EOS on and off) equal the reference's, from
    a file and from bytes."""
    pieces, kw, texts = _SP_MODELS[name]
    blob = tsp.write_model_proto(pieces, **kw)
    assert blob == jsp.write_model_proto(pieces, **kw)
    assert tsp.parse_model_proto(blob) == jsp.parse_model_proto(blob)
    path = tmp_path / "tokenizer.model"
    path.write_bytes(blob)
    mine, ref = tsp.SentencePieceTokenizer(str(path)), \
        jsp.SentencePieceTokenizer(model_bytes=blob)
    assert (mine.normalizer_name, mine.vocab_size) == (ref.normalizer_name,
                                                       ref.vocab_size)
    for text in texts:
        for flags in ({}, {"add_bos": True, "add_eos": True}):
            ids = mine.encode(text, **flags)
            assert ids == ref.encode(text, **flags)
            assert mine.decode(ids) == ref.decode(ids)
    via = thf.build_tokenizer("sp", str(path))
    assert via.encode(texts[0]) == ref.encode(texts[0])


def _toy_ranks():
    ranks = {bytes([b]): b for b in range(256)}
    nxt = 256
    for merge in (b"he", b"ll", b"llo", b"hello", b" w", b"or", b"ld"):
        ranks[merge] = nxt
        nxt += 1
    return ranks


@pytest.mark.parametrize("name", ["toy", "holey"])
def test_tiktoken_ranks_and_encode_equal_the_reference(tmp_path, name):
    """The rank file written, the ranks read back, the pure-Python merge
    and the tokenizer's ids (the package's compiled path off on both
    sides) equal the reference's; rank files with holes put the special
    ids past the largest rank on both."""
    if name == "toy":
        ranks, pattern = _toy_ranks(), jtt.PATTERN_DEFAULT
        texts = ["hello world", "hold", "ohelp", "lllo", ""]
    else:
        ranks, pattern = {b"a": 0, b"b": 1, b"ab": 2, b"c": 5}, r"."
        texts = ["abc", "cab"]
    mine_path, ref_path = tmp_path / "mine.tiktoken", tmp_path / "ref"
    ttt.save_tiktoken_ranks(ranks, str(mine_path))
    jtt.save_tiktoken_ranks(ranks, str(ref_path))
    assert mine_path.read_bytes() == ref_path.read_bytes()
    assert ttt.load_tiktoken_ranks(str(mine_path)) == ranks
    mine = ttt.TikTokenizer(str(mine_path), pattern=pattern)
    ref = jtt.TikTokenizer(str(ref_path), pattern=pattern)
    mine._fast = ref._fast = None
    assert (mine.special_tokens, mine.vocab_size, mine.base_vocab_size) == (
        ref.special_tokens, ref.vocab_size, ref.base_vocab_size)
    for text in texts:
        assert ttt.bpe_merge(text.encode(), ranks) == jtt.bpe_merge(
            text.encode(), ranks)
        ids = mine.encode(text, add_bos=True, add_eos=True)
        assert ids == ref.encode(text, add_bos=True, add_eos=True)
        assert mine.decode(ids) == ref.decode(ids)
    assert mine.decode([mine.special_tokens["<s>"]]) == "<s>"
